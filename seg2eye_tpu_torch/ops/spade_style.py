"""Fused SPADE+Style norm: the CUDA kernels, their plain PyTorch version
and the dispatcher (counterpart of ``seg2eye_tpu/ops/pallas/spade_style.py``).

Per norm site (reference normalization.py:172-192):

    actv  = relu(conv3x3(seg, ws) + bs)          # 128-ch hidden, cuDNN
    gamma = conv3x3(actv, wg) + bg               # C-ch  } in the kernel,
    beta  = conv3x3(actv, wb) + bb               #       } never in HBM
    out   = (normalize(x) * (1 + gamma) + beta + x * (s0 + 1) + s1) / 2

``spade_style`` is the entry point.  A CPU tensor takes the plain version,
``spade_style_reference``; a CUDA tensor takes a kernel or raises:
bfloat16 the tensor-core kernel (``csrc/spade_style_sm90.cu``: wgmma with
TMA loads), float32 the FFMA kernel (``csrc/spade_style.cu``; tensor cores
in float32 would mean TF32).  ``spade_style_from_actv`` is the plain
version of exactly what the kernels compute, from ``actv`` on.  The
backward of both routes is the autograd of ``spade_style_reference``,
recomputed from the inputs, as the TPU kernel's custom VJP does; there is
no backward kernel.

Layouts are the JAX package's: x (N,H,W,C), seg (N,H,W,S), style (N,2C)
holding [s0|s1], mean/var (N,C) float32.  Weights are torch's OIHW:
ws (128,S,3,3), wg/wb (C,128,3,3), biases (128,) and (C,).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
NHIDDEN = 128
# the kernel, and its source, per dtype
KERNELS = {torch.bfloat16: "spade_style_fwd_bf16_sm90",
           torch.float32: "spade_style_fwd_f32"}
SOURCE = {torch.bfloat16: "seg2eye_tpu_torch/ops/csrc/spade_style_sm90.cu",
          torch.float32: "seg2eye_tpu_torch/ops/csrc/spade_style.cu"}
REPLACES = "seg2eye_tpu/ops/pallas/spade_style.py:83"   # the Pallas _kernel


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 'same' conv in x's dtype (cuDNN on the card)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def seg_mlp_shared(seg: torch.Tensor, ws: torch.Tensor,
                   bs: torch.Tensor) -> torch.Tensor:
    """actv = relu(conv3x3(seg, ws) + bs), NHWC; outside the kernel."""
    return torch.relu(_conv3x3(seg, ws, bs))


def spade_style_from_actv(x, actv, style, mean, var, wg, bg, wb, bb,
                          eps: float = EPS):
    """The plain version of what the kernels compute: from ``actv`` on,
    line for line the JAX reference math."""
    c = x.shape[-1]
    f32 = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(f32)
    gamma = _conv3x3(actv, wg, bg).to(f32)
    beta = _conv3x3(actv, wb, bb).to(f32)
    normalized = (x32 - mean[:, None, None, :]) * \
        torch.rsqrt(var[:, None, None, :] + eps)
    spade = normalized * (1.0 + gamma) + beta
    s0 = style[:, :c].to(f32)[:, None, None, :]
    s1 = style[:, c:].to(f32)[:, None, None, :]
    adain = x32 * (s0 + 1.0) + s1
    return ((spade + adain) * 0.5).to(x.dtype)


def spade_style_reference(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                          eps: float = EPS):
    """The plain version of one site, seg MLP included."""
    actv = seg_mlp_shared(seg.to(x.dtype), ws, bs)
    return spade_style_from_actv(x, actv, style, mean, var, wg, bg, wb, bb,
                                 eps)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"spade_style kernel: {msg}")


def n_tile(c: int) -> int:
    """GEMM columns (gamma|beta interleaved) per block of the tensor-core
    kernel: 128 where 2C fits in them, else 256 (as the kernel picks)."""
    return 128 if 2 * c <= 128 else 256


def packed_columns(c: int) -> int:
    """Columns of the bfloat16 layout: 2C rounded up to the N tile."""
    return -(-2 * c // n_tile(c)) * n_tile(c)


def pack_weights(wg, bg, wb, bb, dtype: torch.dtype):
    """The kernel's weight layout for ``dtype``, and bcat (C,2) float32
    holding (bg[c], bb[c]).

    bfloat16 (the tensor-core kernel): wcat (9, packed_columns(C), 128),
    K-major per tap: wcat[3*dy + dx, j, k] is column j of tap (dy, dx) at
    actv channel k, with columns interleaved j = 2c (gamma) and 2c + 1
    (beta), and the columns past 2C zero.

    float32 (the FFMA kernel): wcat (3,3,128,C,2), gamma's and beta's
    weights of channel c side by side."""
    c = wg.shape[0]
    bcat = torch.stack([bg, bb], dim=-1).to(torch.float32).contiguous()
    if dtype == torch.float32:
        wcat = torch.stack([wg, wb], dim=-1).permute(2, 3, 1, 0, 4)
        return wcat.to(dtype).contiguous(), bcat
    cols = torch.stack([wg, wb], dim=1).reshape(2 * c, NHIDDEN, 3, 3)
    wcat = torch.zeros((9, packed_columns(c), NHIDDEN), dtype=dtype,
                       device=wg.device)
    wcat[:, :2 * c] = cols.permute(2, 3, 0, 1).reshape(9, 2 * c, NHIDDEN)
    return wcat, bcat


def packed_shape(c: int, dtype: torch.dtype) -> tuple:
    if dtype == torch.float32:
        return (3, 3, NHIDDEN, c, 2)
    return (9, packed_columns(c), NHIDDEN)


class PackedWeights:
    """``pack_weights`` of one norm site, kept from one forward to the next
    and made anew, per dtype, once a weight is replaced or changed in place
    (its storage or ``_version`` moves).  The cache holds detached views of
    the weights it packed, so their storage cannot be reused unseen."""

    def __init__(self):
        self._cache = {}

    def __call__(self, wg, bg, wb, bb, dtype: torch.dtype):
        weights = (wg, bg, wb, bb)
        key = tuple((t.data_ptr(), t._version) for t in weights)
        hit = self._cache.get(dtype)
        if hit is None or hit[0] != key:
            hit = (key, [t.detach() for t in weights],
                   pack_weights(*weights, dtype))
            self._cache[dtype] = hit
        return hit[2]


def spade_style_cuda(x, actv, style, mean, var, wcat, bcat,
                     eps: float = EPS) -> torch.Tensor:
    """Launch x's dtype's CUDA kernel on one site; ``actv`` is
    ``seg_mlp_shared``'s output and (wcat, bcat) is ``pack_weights``'.
    Checks every input and allocates the output; raises on anything the
    kernel does not take, and on a failed launch."""
    from seg2eye_tpu_torch.ops import _build

    _require(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _require(x.dtype in KERNELS, f"unsupported dtype {x.dtype}")
    _require(x.dim() == 4, f"x must be (N,H,W,C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    _require(wcat.dtype == x.dtype and bcat.dtype == torch.float32
             and wcat.is_contiguous() and bcat.is_contiguous(),
             "wcat and bcat must come from pack_weights(..., x.dtype)")
    style = style.to(torch.float32).contiguous()
    mean = mean.to(torch.float32).contiguous()
    var = var.to(torch.float32).contiguous()
    shapes = {"actv": (actv, (n, h, w, NHIDDEN)), "style": (style, (n, 2 * c)),
              "mean": (mean, (n, c)), "var": (var, (n, c)),
              "wcat": (wcat, packed_shape(c, x.dtype)), "bcat": (bcat, (c, 2))}
    for name, (t, shape) in shapes.items():
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.device == x.device, f"{name} is on {t.device}, not {x.device}")
    _require(actv.dtype == x.dtype, f"actv is {actv.dtype}, x is {x.dtype}")
    # NHWC contiguous == NCHW in channels_last memory
    _require(x.is_contiguous() and actv.is_contiguous(),
             "x and actv must be NHWC-contiguous (channels_last)")
    # TMA reads actv and wcat: 16-byte aligned base addresses
    _require(actv.data_ptr() % 16 == 0 and wcat.data_ptr() % 16 == 0,
             "actv and wcat must be 16-byte aligned")

    lib = _build.library()
    out = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, KERNELS[x.dtype])(
        x.device.index, actv.data_ptr(), x.data_ptr(), style.data_ptr(),
        mean.data_ptr(), var.data_ptr(), wcat.data_ptr(), bcat.data_ptr(),
        out.data_ptr(), n, h, w, c, eps, stream)
    _build.check(lib, err, "spade_style kernel launch")
    spade_style.launches += 1
    return out


class _SpadeStyle(torch.autograd.Function):
    """Kernel (CUDA) or plain version (CPU) forward; the backward is the
    autograd of ``spade_style_reference``, recomputed."""

    @staticmethod
    def forward(ctx, x, seg, style, mean, var, ws, bs, wg, bg, wb, bb, eps,
                packed):
        ctx.save_for_backward(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb)
        ctx.eps = eps
        if x.device.type == "cpu":
            return spade_style_reference(x, seg, style, mean, var,
                                         ws, bs, wg, bg, wb, bb, eps)
        actv = seg_mlp_shared(seg.to(x.dtype), ws, bs).contiguous()
        wcat, bcat = (packed or pack_weights)(wg, bg, wb, bb, x.dtype)
        return spade_style_cuda(x.contiguous(), actv, style, mean, var,
                                wcat, bcat, eps)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = spade_style_reference(*inputs, eps=ctx.eps)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None)


def spade_style(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                eps: float = EPS,
                packed: PackedWeights | None = None) -> torch.Tensor:
    """One SPADE+Style norm site.  CPU tensors take the plain version;
    CUDA tensors take their dtype's kernel, and every launch of either
    kernel counts in ``spade_style.launches``; any other device raises.
    ``packed`` keeps the kernel's weight layout between calls (one per
    site); without it the weights are packed on every call."""
    return _SpadeStyle.apply(x, seg, style, mean, var,
                             ws, bs, wg, bg, wb, bb, eps, packed)


spade_style.launches = 0
