"""Image ops on NHWC tensors (counterpart of ``seg2eye_tpu/ops/image.py``).

The layouts are the JAX package's: images and label maps are (B,H,W,C)
at these functions, so both packages are compared like with like; only
``resize_bilinear_ac``, which the DeepLab layers call, takes NCHW.  The
sample positions are computed on the host in float64, as the JAX package
does, and cast to the compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def one_hot_label(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B,H,W) or (B,H,W,1) int label map -> (B,H,W,num_classes) float32."""
    if label.dim() == 4:
        label = label[..., 0]
    return F.one_hot(label.long(), num_classes).to(torch.float32)


def _nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    # torch F.interpolate(mode='nearest') samples src index floor(i*in/out)
    return np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC tensor, source index
    floor(i*in/out) per axis (torch ``F.interpolate(mode='nearest')``)."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    rows = torch.from_numpy(_nearest_indices(out_h, h)).to(x.device)
    cols = torch.from_numpy(_nearest_indices(out_w, w)).to(x.device)
    return x.index_select(1, rows).index_select(2, cols)


def _bilinear_axis(out_n: int, in_n: int):
    pos = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    pos = np.clip(pos, 0.0, in_n - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), in_n - 1)
    hi = np.minimum(lo + 1, in_n - 1)
    return lo, hi, pos - lo


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of an NHWC tensor, positions
    (i+0.5)*in/out-0.5 clamped to the image, without antialiasing on
    downscale (torch ``align_corners=False`` and cv2 INTER_LINEAR)."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    dt = x.dtype
    xf = x.to(torch.promote_types(dt, torch.float32))
    dev = x.device

    def idx(a):
        return torch.from_numpy(a).to(dev)

    def frac(a):
        return torch.from_numpy(a).to(device=dev, dtype=xf.dtype)

    hlo, hhi, hf = _bilinear_axis(out_h, h)
    wlo, whi, wf = _bilinear_axis(out_w, w)
    top = xf.index_select(1, idx(hlo))
    bot = xf.index_select(1, idx(hhi))
    xh = top + (bot - top) * frac(hf)[None, :, None, None]
    left = xh.index_select(2, idx(wlo))
    right = xh.index_select(2, idx(whi))
    out = left + (right - left) * frac(wf)[None, None, :, None]
    return out.to(dt)


def _bilinear_ac_axis(out_n: int, in_n: int):
    if out_n == 1 or in_n == 1:
        lo = np.zeros(out_n, np.int64)
        return lo, lo, np.zeros(out_n, np.float64)
    pos = np.arange(out_n) * (in_n - 1) / (out_n - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), in_n - 2)
    return lo, lo + 1, pos - lo


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NCHW tensor: sample
    positions i*(in-1)/(out-1) per axis, taken in float64 on the host (a
    1-pixel axis is broadcast), two 1-D lerps computed in at least float32
    and cast back, as the JAX package does (``F.interpolate`` takes the
    positions in float32: 4.6e-5 apart at 160x100 -> 640x400).  Unlike the
    functions above it takes NCHW: its callers are the DeepLab layers,
    whose activations are NCHW.  The same size returns ``x`` itself."""
    _, _, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dev = x.device

    def idx(a):
        return torch.from_numpy(a).to(dev)

    def frac(a):
        return torch.from_numpy(a).to(device=dev, dtype=xf.dtype)

    hlo, hhi, hf = _bilinear_ac_axis(out_h, h)
    wlo, whi, wf = _bilinear_ac_axis(out_w, w)
    top = xf.index_select(2, idx(hlo))
    bot = xf.index_select(2, idx(hhi))
    xh = top + (bot - top) * frac(hf)[:, None]
    left = xh.index_select(3, idx(wlo))
    right = xh.index_select(3, idx(whi))
    return (left + (right - left) * frac(wf)).to(x.dtype)


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool of an NHWC tensor, padding not
    counted (``count_include_pad=False``): the multiscale discriminator's
    downsampler.  -> NHWC-contiguous (channels_last NCHW once permuted).

    It pools a contiguous NCHW copy: on CUDA, PyTorch's backward of this
    pool on channels_last input is wrong (torch 2.11: an input gradient
    105% off the CPU's, while the contiguous input's matches it)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, stride=2,
                     padding=1, count_include_pad=False)
    return y.permute(0, 2, 3, 1).contiguous()


def to_255(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,255], truncated toward zero (the reference's ``.int()``)."""
    return torch.trunc((x + 1.0) * 255.0 / 2.0)


def to_255resized(x: torch.Tensor, w: int = 400, h: int = 640) -> torch.Tensor:
    """[-1,1] NHWC batch -> bilinear resize to (h,w) -> truncated [0,255]."""
    return to_255(resize_bilinear(x.to(torch.float32), h, w))
