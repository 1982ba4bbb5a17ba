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
whatever the process's TF32 flags (``full_float32``).  The backward of
both routes is the autograd of ``spade_style_reference``, recomputed from
the inputs, as the TPU kernel's custom VJP does; there is no backward
kernel.

Layouts are the JAX package's: x (N,H,W,C), seg (N,H,W,S), style (N,2C)
holding [s0|s1], mean/var (N,C) float32.  Weights are torch's OIHW:
ws (128,S,3,3), wg/wb (C,128,3,3), biases (128,) and (C,).
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from seg2eye_tpu_torch.utils.precision import full_float32

EPS = 1e-5
NHIDDEN = 128
# the kernel, and its source, per dtype
KERNELS = {torch.bfloat16: "spade_style_fwd_bf16_sm90",
           torch.float32: "spade_style_fwd_f32_3xtf32_sm90"}
SOURCE = {dtype: "seg2eye_tpu_torch/ops/csrc/spade_style_sm90.cu"
          for dtype in KERNELS}
REPLACES = "seg2eye_tpu/ops/pallas/spade_style.py:83"   # the Pallas _kernel
# the profiler range around the backward's recompute
BACKWARD_RANGE = "spade_style backward (plain recompute)"


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


def packed_shape(c: int, dtype: torch.dtype) -> tuple:
    shape = (9, packed_columns(c), NHIDDEN)
    return (2, *shape) if dtype == torch.float32 else shape


class PackedWeights:
    """``pack_weights`` of each weight set the kernels ran on, kept from one
    call to the next and made anew, per dtype, once a weight is replaced or
    changed in place (its storage or ``_version`` moves).

    The kernels run inside the ``seg2eye::spade_style`` op, which sees
    tensors and not the norm site they belong to, so one cache,
    ``packed_weights``, serves every site: an entry is found by the
    identity of the four weight tensors and holds them weakly, and it goes
    when any of them is freed.  A view (a tensor-parallel rank's block of
    a whole bias, made anew at every call) is found by its base tensor,
    offset and shape, so that it too is packed once.  An in-place update that leaves
    ``_version`` alone (``torch.optim.Adam(fused=True)`` does) is not
    seen, so the port's optimizers are never fused (``train.state``).
    ``packings`` counts the packings made."""

    def __init__(self):
        self._cache = {}
        self.packings = 0

    def __call__(self, wg, bg, wb, bb, dtype: torch.dtype):
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
        packed = pack_weights(*weights, dtype)
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


def _backward(ctx, grad_out):
    """The autograd of ``spade_style_reference``, recomputed from the
    inputs (float32 in full float32)."""
    inputs = [t.detach().requires_grad_(need) for t, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad(), full_float32(
            grad_out.dtype == torch.float32), \
            torch.profiler.record_function(BACKWARD_RANGE):
        out = spade_style_reference(*inputs, eps=ctx.eps)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t.requires_grad else None
                 for t in inputs) + (None,)


spade_style_op.register_autograd(_backward, setup_context=_setup_context)


def spade_style(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                eps: float = EPS) -> torch.Tensor:
    """One SPADE+Style norm site, through the ``seg2eye::spade_style`` op,
    which ``torch.export`` keeps as one node.  Its registrations choose by
    device: CPU tensors take the plain version, CUDA tensors their dtype's
    kernel (every launch counts in ``spade_style.launches``, every packing
    of the weights in ``packed_weights.packings``); any other device
    raises.  The backward recomputes through the plain version."""
    return spade_style_op(x, seg, style, mean, var, ws, bs, wg, bg, wb, bb,
                          eps)


spade_style.launches = 0
