"""Fused SPADE+Style norm: the CUDA kernels, their plain PyTorch version
and the dispatcher (counterpart of ``seg2eye_tpu/ops/pallas/spade_style.py``).

Per norm site (reference normalization.py:172-192):

    actv  = relu(conv3x3(seg, ws) + bs)          # 128-ch hidden, cuDNN
    gamma = conv3x3(actv, wg) + bg               # C-ch  } in the kernel,
    beta  = conv3x3(actv, wb) + bb               #       } never in HBM
    out   = (normalize(x) * (1 + gamma) + beta + x * (s0 + 1) + s1) / 2

``spade_style`` is the entry point.  It calls the ``seg2eye::spade_style``
op (``torch.library``), which ``torch.export`` keeps as one node of an
exported program, and whose registrations choose by device: a CPU tensor
takes the plain version, ``spade_style_reference``; a CUDA tensor takes
its dtype's tensor-core kernel (``csrc/spade_style_sm90.cu``: wgmma with
TMA loads) or raises: bfloat16 in one pass, float32 in three TF32 passes
(3xTF32: each operand split into a TF32 hi and lo, hi*hi + hi*lo + lo*hi
summed in float32), which keeps float32's accuracy; one TF32 pass would
not.  The CUDA registration packs the weights into the kernel's layout
through one cache, ``packed_weights``, which sees the real tensors behind
the op boundary and packs again only when a weight changes.
``spade_style_from_actv`` is the plain version of exactly what the kernels
compute, from ``actv`` on.  Its float32 convolutions run in full float32
whatever the process's TF32 flags (``full_float32``).

The backward recomputes from the inputs and chooses by dtype, then by
device.  bfloat16: on CUDA the backward kernel (``csrc/spade_style_sm90.cu``,
``spade_style_backward_cuda``) recomputes gamma on the tensor cores and
writes dx, [dgamma | dbeta] and per-block sums, from which the style,
mean, var and bias gradients follow; one cuDNN dgrad and one wgrad on
[dgamma | dbeta] against cat(wg, wb), then the ReLU mask and the seg
MLP's backward.  ``spade_style_backward_reference`` is the plain closed
form of that route, which the tests and the card's checks hold the kernel
to.  Every other case (float32, which has no backward kernel, and CPU
tensors): the autograd of ``spade_style_reference``, recomputed from the
inputs (float32 in full float32), as the TPU kernel's custom VJP does.

Layouts are the JAX package's: x (N,H,W,C), seg (N,H,W,S), style (N,2C)
holding [s0|s1], mean/var (N,C) float32.  Weights are torch's OIHW:
ws (128,S,3,3), wg/wb (C,128,3,3), biases (128,) and (C,).
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from seg2eye_tpu_torch.utils.precision import full_float32
from seg2eye_tpu_torch.utils.spans import BACKWARD_RANGE, K1_PACK, span

EPS = 1e-5
NHIDDEN = 128
# the kernel, and its source, per dtype
KERNELS = {torch.bfloat16: "spade_style_fwd_bf16_sm90",
           torch.float32: "spade_style_fwd_f32_3xtf32_sm90"}
SOURCE = {dtype: "seg2eye_tpu_torch/ops/csrc/spade_style_sm90.cu"
          for dtype in KERNELS}
# the backward kernel, per dtype (float32 recomputes through autograd)
BACKWARD_KERNELS = {torch.bfloat16: "spade_style_bwd_bf16_sm90"}
# the backward kernel's sums per (sample, channel), in this order:
# sum h, sum h (x - mean), sum h (1 + gamma), sum h (1 + gamma) (x - mean)
BACKWARD_SUMS = 4
BM = 128                  # pixels per block of the kernels
# (stride, padding, dilation, transposed, output_padding, groups) of the 3x3
# 'same' convs, as aten.convolution_backward takes them
_CONV3X3 = ([1, 1], [1, 1], [1, 1], False, [0, 0], 1)
REPLACES = "seg2eye_tpu/ops/pallas/spade_style.py:83"   # the Pallas _kernel


def _conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 'same' conv in x's dtype (cuDNN on the card; float32 in
    full float32)."""
    with full_float32(x.dtype == torch.float32):
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
    return spade_style_epilogue(x, _conv3x3(actv, wg, bg),
                                _conv3x3(actv, wb, bb), style, mean, var, eps)


def spade_style_epilogue(x, gamma, beta, style, mean, var, eps: float = EPS):
    """out from gamma and beta (N,H,W,C): the normalise + AdaIN + average
    epilogue, in float32 (at least), stored in x's dtype."""
    c = x.shape[-1]
    f32 = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(f32)
    gamma, beta = gamma.to(f32), beta.to(f32)
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
    """Columns of the packed layouts: 2C rounded up to the bfloat16 N tile
    (the float32 kernel's N tile, 128, divides it too)."""
    return -(-2 * c // n_tile(c)) * n_tile(c)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: the low 13 mantissa bits become zero."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_weights(wg, bg, wb, bb, dtype: torch.dtype):
    """The kernel's weight layout for ``dtype``, and bcat (C,2) float32
    holding (bg[c], bb[c]).

    Per tap, K-major: column j of tap (dy, dx) at actv channel k, with
    columns interleaved j = 2c (gamma) and 2c + 1 (beta), and the columns
    past 2C zero, packed_columns(C) of them.

    bfloat16: wcat (9, cols, 128), wcat[3*dy + dx, j, k].
    float32 (3xTF32): wcat (2, 9, cols, 128), wcat[0] = hi = tf32(w) and
    wcat[1] = lo = tf32(w - hi), so that hi + lo is w to about 2^-22."""
    c = wg.shape[0]
    bcat = torch.stack([bg, bb], dim=-1).to(torch.float32).contiguous()
    cols = torch.stack([wg, wb], dim=1).reshape(2 * c, NHIDDEN, 3, 3)
    cols = cols.permute(2, 3, 0, 1).reshape(9, 2 * c, NHIDDEN)
    parts = [cols]
    if dtype == torch.float32:
        hi = tf32_round(cols)
        parts = [hi, tf32_round(cols - hi)]
    wcat = torch.zeros((len(parts), 9, packed_columns(c), NHIDDEN),
                       dtype=dtype, device=wg.device)
    for i, part in enumerate(parts):
        wcat[i, :, :2 * c] = part
    return (wcat if dtype == torch.float32 else wcat[0]), bcat


def gamma_tile(c: int) -> int:
    """Gamma columns per block of the backward kernel: 64 where C <= 64,
    else 128 (as the kernel picks)."""
    return 64 if c <= 64 else 128


def gamma_columns(c: int) -> int:
    """Columns of the gamma-only layout: C rounded up to ``gamma_tile``."""
    return -(-c // gamma_tile(c)) * gamma_tile(c)


def pack_gamma_weights(wg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel's weight layout: wg alone, (9, gamma_columns(C),
    128) in ``dtype``, wgam[3*dy + dx, c, k] = wg[c, k, dy, dx], K-major as
    pack_weights' with the columns past C zero."""
    c = wg.shape[0]
    wgam = torch.zeros((9, gamma_columns(c), NHIDDEN), dtype=dtype,
                       device=wg.device)
    wgam[:, :c] = wg.permute(2, 3, 0, 1).reshape(9, c, NHIDDEN)
    return wgam


def pixel_tiles(h: int, w: int) -> int:
    """Pixel tiles of one sample's (H, W) map in the kernels' grid: BM
    pixels as TH x TW, TW = 8 where W <= 8, else 16."""
    tw = 8 if w <= 8 else 16
    return -(-h // (BM // tw)) * -(-w // tw)


def backward_kernel_work(x_shape, dtype: torch.dtype):
    """(FLOPs, bytes) of one launch of the backward kernel on x (N,H,W,C):
    the gamma product (3x3, 128 -> C); actv, x and dout read once, dx and
    [dgamma | dbeta] written once in ``dtype``; style, mean and var (N,C
    float32 each), the gamma-only weights and the biases read once, the
    float32 per-block sums written once."""
    n, h, w, c = x_shape
    item = torch.empty((), dtype=dtype).element_size()
    pixels = n * h * w
    flops = 2.0 * pixels * 9 * NHIDDEN * c
    nbytes = (pixels * (NHIDDEN + 2 * c + c + 2 * c) * item
              + 4 * 3 * n * c + 9 * NHIDDEN * c * item + 4 * c
              + 4 * n * pixel_tiles(h, w) * BACKWARD_SUMS * c)
    return flops, nbytes


def packed_shape(c: int, dtype: torch.dtype) -> tuple:
    shape = (9, packed_columns(c), NHIDDEN)
    return (2, *shape) if dtype == torch.float32 else shape


class PackedWeights:
    """``pack_weights`` of each weight set the kernels ran on, kept from one
    call to the next and made anew, per dtype, once a weight is replaced or
    changed in place (its storage or ``_version`` moves).  Where the dtype
    has a backward kernel, the entry holds ``pack_gamma_weights`` and
    cat(wg, wb) in that dtype too, made with it, which ``backward``
    returns: a training step's backward packs and casts no weight.

    The kernels run inside the ``seg2eye::spade_style`` op, which sees
    tensors and not the norm site they belong to, so one cache,
    ``packed_weights``, serves every site: an entry is found by the
    identity of the four weight tensors and holds them weakly, and it goes
    when any of them is freed.  A view (a tensor-parallel rank's block of
    a whole bias, made anew at every call) is found by its base tensor,
    offset and shape, so that it too is packed once.  An in-place update that leaves
    ``_version`` alone (``torch.optim.Adam(fused=True)`` does) is not
    seen, so the port's optimizers are never fused (``train.state``).
    ``packings`` counts the packings made; under a profiler each packing
    is one ``utils.spans.K1_PACK`` span."""

    def __init__(self):
        self._cache = {}
        self.packings = 0

    def __call__(self, wg, bg, wb, bb, dtype: torch.dtype):
        """(wcat, bcat) of ``pack_weights``."""
        return self._entry(wg, bg, wb, bb, dtype)[:2]

    def backward(self, wg, bg, wb, bb, dtype: torch.dtype):
        """(wgam, bcat, wgb): the backward kernel's layout, the biases and
        cat(wg, wb) in ``dtype`` (the dgrad's weight), from the entry that
        ``__call__`` serves."""
        _, bcat, wgam, wgb = self._entry(wg, bg, wb, bb, dtype)
        return wgam, bcat, wgb

    def _entry(self, wg, bg, wb, bb, dtype: torch.dtype):
        weights = (wg, bg, wb, bb)
        bases = tuple(t if t._base is None else t._base for t in weights)
        key = (tuple((id(b), t.storage_offset(), tuple(t.shape))
                     for b, t in zip(bases, weights)), dtype)
        stamp = tuple((t.data_ptr(), t._version) for t in weights)
        hit = self._cache.get(key)
        if hit is not None and hit[0] == stamp and all(
                ref() is b for ref, b in zip(hit[1], bases)):
            return hit[2]
        if hit is None:
            for b in bases:
                weakref.finalize(b, self._cache.pop, key, None)
        with span(K1_PACK):
            packed = pack_weights(*weights, dtype)
            if dtype in BACKWARD_KERNELS:
                packed += (pack_gamma_weights(wg, dtype),
                           torch.cat([wg, wb]).to(dtype))
        self._cache[key] = (stamp, tuple(map(weakref.ref, bases)), packed)
        self.packings += 1
        return packed


# the packings of every weight set the CUDA kernels ran on
packed_weights = PackedWeights()


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


SCHEMA = ("(Tensor x, Tensor seg, Tensor style, Tensor mean, Tensor var, "
          "Tensor ws, Tensor bs, Tensor wg, Tensor bg, Tensor wb, Tensor bb, "
          "float eps) -> Tensor")


def _plain(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb, eps):
    return spade_style_reference(x, seg, style, mean, var, ws, bs, wg, bg,
                                 wb, bb, eps).contiguous()


# the op: the plain version for CPU tensors, the kernels for CUDA ones
spade_style_op = torch.library.custom_op(
    "seg2eye::spade_style", _plain, mutates_args=(), device_types="cpu",
    schema=SCHEMA)


@spade_style_op.register_kernel("cuda")
def _kernel(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb, eps):
    actv = seg_mlp_shared(seg.to(x.dtype), ws, bs).contiguous()
    wcat, bcat = packed_weights(wg, bg, wb, bb, x.dtype)
    return spade_style_cuda(x.contiguous(), actv, style, mean, var,
                            wcat, bcat, eps)


@spade_style_op.register_fake
def _fake(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:-1])
    ctx.eps = inputs[-1]


def spade_style_backward_cuda(x, actv, dout, style, mean, var, wgam, bcat,
                              eps: float = EPS):
    """Launch x's dtype's backward kernel on one site: (dx, dgb, sums) as
    ``epilogue_backward_reference`` gives them.  ``actv`` is
    ``seg_mlp_shared``'s output, (wgam, bcat) ``packed_weights.backward``'s.
    Checks every input and allocates the outputs; raises on anything the
    kernel does not take, and on a failed launch."""
    from seg2eye_tpu_torch.ops import _build

    _require(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _require(x.dtype in BACKWARD_KERNELS,
             f"no backward kernel for {x.dtype}")
    _require(x.dim() == 4, f"x must be (N,H,W,C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    style = style.to(torch.float32).contiguous()
    mean = mean.to(torch.float32).contiguous()
    var = var.to(torch.float32).contiguous()
    shapes = {"actv": (actv, (n, h, w, NHIDDEN)), "dout": (dout, (n, h, w, c)),
              "style": (style, (n, 2 * c)), "mean": (mean, (n, c)),
              "var": (var, (n, c)),
              "wgam": (wgam, (9, gamma_columns(c), NHIDDEN)),
              "bcat": (bcat, (c, 2))}
    for name, (t, shape) in shapes.items():
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.device == x.device, f"{name} is on {t.device}, not {x.device}")
    _require(actv.dtype == dout.dtype == wgam.dtype == x.dtype
             and bcat.dtype == torch.float32,
             "actv, dout and wgam must be in x's dtype, bcat float32")
    _require(x.is_contiguous() and actv.is_contiguous()
             and dout.is_contiguous() and wgam.is_contiguous()
             and bcat.is_contiguous(),
             "x, actv, dout, wgam and bcat must be contiguous")
    _require(actv.data_ptr() % 16 == 0 and wgam.data_ptr() % 16 == 0,
             "actv and wgam must be 16-byte aligned")

    lib = _build.library()
    tiles = pixel_tiles(h, w)
    dx = torch.empty_like(x)
    dgb = torch.empty((n, h, w, 2 * c), dtype=x.dtype, device=x.device)
    partial = torch.empty((n, tiles, BACKWARD_SUMS, c), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, BACKWARD_KERNELS[x.dtype])(
        x.device.index, actv.data_ptr(), x.data_ptr(), dout.data_ptr(),
        style.data_ptr(), mean.data_ptr(), var.data_ptr(), wgam.data_ptr(),
        bcat.data_ptr(), dx.data_ptr(), dgb.data_ptr(), partial.data_ptr(),
        n, h, w, c, tiles, eps, stream)
    _build.check(lib, err, "spade_style backward kernel launch")
    spade_style.backward_launches += 1
    return dx, dgb, partial.sum(1)


def epilogue_backward_reference(x, actv, dout, style, mean, var, wg, bg,
                                eps: float = EPS):
    """The plain version of what the backward kernel computes, with h =
    dout / 2 and gamma the product of actv with wg rounded to x's dtype,
    summed in float32 (at least):

        dx  = h ((1 + gamma) rstd + s0 + 1)             in x's dtype
        dgb = [h (x - mean) rstd | h]  (N,H,W,2C)       in x's dtype
        sums (N, BACKWARD_SUMS, C), over the pixels, float32 (at least):
            h, h (x - mean), h (1 + gamma), h (1 + gamma) (x - mean)
    """
    c = x.shape[-1]
    f32 = torch.promote_types(x.dtype, torch.float32)
    # operands rounded to x's dtype, products summed in float32: bfloat16
    # values are exact in TF32, so the TF32 flags matter in float32 alone
    with full_float32(x.dtype == torch.float32):
        gamma = F.conv2d(actv.to(f32).permute(0, 3, 1, 2),
                         wg.to(x.dtype).to(f32), bg.to(f32),
                         padding=1).permute(0, 2, 3, 1)
    h = 0.5 * dout.to(f32)
    xm = x.to(f32) - mean[:, None, None, :]
    rstd = torch.rsqrt(var[:, None, None, :] + eps)
    g1 = 1.0 + gamma
    s0p1 = style[:, :c].to(f32)[:, None, None, :] + 1.0
    dx = (h * (g1 * rstd + s0p1)).to(x.dtype)
    dgb = torch.cat([h * (xm * rstd), h], -1).to(x.dtype)
    sums = torch.stack([h, h * xm, h * g1, h * g1 * xm], 1).sum((2, 3))
    return dx, dgb, sums


def _input_grads(inputs, needs, actv, wgb, dx, dgb, sums, eps):
    """The gradients of the op's inputs (None where ``needs`` says none)
    from the kernel's outputs: the per-(sample, channel) ones from the sums,
    the convs' through ``aten.convolution_backward`` (cuDNN on the card)
    against wgb = cat(wg, wb) in x's dtype, the seg MLP's behind the ReLU
    mask."""
    x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = inputs
    c = x.shape[-1]
    s_h, s_hx, s_hg, s_hgx = sums.unbind(1)
    rstd = torch.rsqrt(var + eps)
    grads = [dx, None,
             torch.cat([s_hx + mean * s_h, s_h], -1).to(style.dtype),
             (-rstd * s_hg).to(mean.dtype),
             (-0.5 * rstd ** 3 * s_hgx).to(var.dtype), None, None, None,
             (rstd * s_hx).sum(0).to(bg.dtype), None, s_h.sum(0).to(bb.dtype)]
    need_actv = needs[1] or needs[5] or needs[6]
    need_w = needs[7] or needs[9]
    if need_actv or need_w:
        actv = actv.permute(0, 3, 1, 2)
        with full_float32(x.dtype == torch.float32):
            dactv, dw, _ = torch.ops.aten.convolution_backward(
                dgb.permute(0, 3, 1, 2), actv, wgb, None, *_CONV3X3,
                [need_actv, need_w, False])
            if need_w:
                grads[7], grads[9] = dw[:c].to(wg.dtype), dw[c:].to(wb.dtype)
            if need_actv:
                dseg, dws, dbs = torch.ops.aten.convolution_backward(
                    torch.ops.aten.threshold_backward(dactv, actv, 0),
                    seg.to(x.dtype).permute(0, 3, 1, 2), ws.to(x.dtype),
                    [NHIDDEN], *_CONV3X3, [needs[1], needs[5], needs[6]])
                grads[1] = None if dseg is None else \
                    dseg.permute(0, 2, 3, 1).to(seg.dtype)
                grads[5] = None if dws is None else dws.to(ws.dtype)
                grads[6] = None if dbs is None else dbs.to(bs.dtype)
    return tuple(g if need else None for g, need in zip(grads, needs))


def spade_style_backward_reference(x, seg, style, mean, var, ws, bs, wg, bg,
                                   wb, bb, dout, eps: float = EPS,
                                   needs=(True,) * 11):
    """The gradients of (x, seg, style, mean, var, ws, bs, wg, bg, wb, bb)
    for ``dout``, None where ``needs`` says none, in plain PyTorch: the
    closed form of what the backward kernel and its wrapper compute on the
    card (it takes any dtype and device)."""
    inputs = (x, seg, style, mean, var, ws, bs, wg, bg, wb, bb)
    actv = seg_mlp_shared(seg.to(x.dtype), ws, bs)
    dx, dgb, sums = epilogue_backward_reference(x, actv, dout, style, mean,
                                                var, wg, bg, eps)
    return _input_grads(inputs, needs, actv, torch.cat([wg, wb]).to(x.dtype),
                        dx, dgb, sums, eps)


def _kernel_backward(inputs, needs, dout, eps):
    """The op's backward through the backward kernel (CUDA)."""
    x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = inputs
    actv = seg_mlp_shared(seg.to(x.dtype), ws, bs).contiguous()
    wgam, bcat, wgb = packed_weights.backward(wg, bg, wb, bb, x.dtype)
    dx, dgb, sums = spade_style_backward_cuda(
        x.contiguous(), actv, dout.contiguous(), style, mean, var, wgam, bcat,
        eps)
    return _input_grads(inputs, needs, actv, wgb, dx, dgb, sums, eps)


def _recompute_backward(inputs, needs, dout, eps):
    """The autograd of ``spade_style_reference``, recomputed from the
    inputs (float32 in full float32)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad(), full_float32(dout.dtype == torch.float32):
        out = spade_style_reference(*inputs, eps=eps)
        grads = iter(torch.autograd.grad(out, wanted, dout))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


def _backward(ctx, grad_out):
    """Inside the ``BACKWARD_RANGE`` span: a CUDA tensor of a dtype with a
    backward kernel takes it; everything else the recomputed autograd."""
    inputs, needs = ctx.saved_tensors, ctx.needs_input_grad[:-1]
    route = (_kernel_backward if grad_out.is_cuda
             and inputs[0].dtype in BACKWARD_KERNELS else _recompute_backward)
    with span(BACKWARD_RANGE):
        grads = route(inputs, needs, grad_out, ctx.eps)
    return (*grads, None)


spade_style_op.register_autograd(_backward, setup_context=_setup_context)


def spade_style(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                eps: float = EPS) -> torch.Tensor:
    """One SPADE+Style norm site, through the ``seg2eye::spade_style`` op,
    which ``torch.export`` keeps as one node.  Its registrations choose by
    device: CPU tensors take the plain version, CUDA tensors their dtype's
    kernel (every launch counts in ``spade_style.launches``, every packing
    of the weights in ``packed_weights.packings``); any other device
    raises.  The backward recomputes actv and, in bfloat16 on CUDA, runs
    the backward kernel (every launch counts in
    ``spade_style.backward_launches``)."""
    return spade_style_op(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                          eps)


spade_style.launches = 0
spade_style.backward_launches = 0
