"""Per-channel batch statistics of a norm site: the CUDA kernels, their plain
PyTorch version and the ``seg2eye::batch_stats`` op.

A ``SpadeStyleBlock`` with batch statistics normalises x (N, C, H, W) with
the biased variance and the mean of each channel over (N, H, W), in
float32.  The plain version is ``torch.var_mean(x.float(), ...)``.  In
bfloat16 that writes a float32 copy of x, reads it in a Welford pass and
keeps it alive for the backward, whose autograd then runs seven broadcast
float32 passes and a cast.  The JAX package leaves the same reduction to
XLA; it has no kernel of its own.

``batch_stats`` is the entry point.  It calls the ``seg2eye::batch_stats``
op (``torch.library``), whose registrations choose by device: a CPU tensor
takes the plain version; a bfloat16 CUDA tensor takes the kernels of
``csrc/batch_stats_sm90.cu``, which read x once (16-byte vectors along C,
Welford per thread, Chan's formula across threads and blocks) and make no
copy; a CUDA tensor of another dtype raises.  The op keeps x, which the
norm site's K1 op keeps anyway, and the mean.  Its backward chooses by
device too: on CUDA one pass, dx = a_c x + b_c in float32 stored in
bfloat16 (``batch_stats_backward_cuda``; ``batch_stats_backward_reference``
is its plain closed form); on the CPU the autograd of the plain version,
recomputed.

``takes_kernel`` is the rule the norm sites route by: a bfloat16 CUDA
tensor.  Everything else, and the running, instance, data-parallel and
H-band forms of the statistics, stays on ``torch.var_mean``.

Layout: x (N, H, W, C), the NHWC view of a channels_last activation;
var and mean (C,) float32.
"""
from __future__ import annotations

import functools

import torch

# the forward and backward entry points of the library, per dtype
KERNELS = {torch.bfloat16: "batch_stats_fwd_bf16_sm90"}
BACKWARD_KERNELS = {torch.bfloat16: "batch_stats_bwd_bf16_sm90"}
SOURCE = "seg2eye_tpu_torch/ops/csrc/batch_stats_sm90.cu"
# the kernels' grids, in blocks per SM: the forward one wave of its
# resident blocks (its __launch_bounds__), the backward two waves; chunks
# of at least MIN_CHUNK_ROWS rows
FWD_BLOCKS_PER_SM = 2
BWD_BLOCKS_PER_SM = 8
MIN_CHUNK_ROWS = 16


def _widened(x: torch.Tensor) -> torch.Tensor:
    """x in float32 at least (bfloat16 widened; float32 and float64 kept)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_stats_reference(x: torch.Tensor):
    """(var, mean) of x (N, H, W, C) over (N, H, W): biased, float32 at
    least, the plain version."""
    return torch.var_mean(_widened(x), dim=(0, 1, 2), correction=0)


def batch_stats_backward_reference(x, mean, gvar, gmean):
    """The plain version of what the backward kernel computes: x's gradient
    for the gradients (gvar, gmean) of (var, mean),

        dx = a x + b,  a = gvar (2 / M),  b = gmean (1 / M) - a mean,

    M the elements per channel, in float32 at least, each product and sum
    rounded on its own, stored in x's dtype."""
    m = x.numel() // x.shape[-1]
    a = _widened(gvar) * (2.0 / m)
    b = _widened(gmean) * (1.0 / m) - a * mean
    return (a * _widened(x) + b).to(x.dtype)


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether x's batch statistics take the kernels: bfloat16 on CUDA."""
    return x.dtype in KERNELS and x.is_cuda


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunking(m: int, c: int, blocks: int) -> tuple:
    """(rows per chunk, chunks) of a kernel's grid for M rows of C channels
    in about ``blocks`` blocks: a block covers up to 1024 channels (8 a
    thread, C a multiple of 8) or 128 (one a thread)."""
    slabs = -(-c // (1024 if c % 8 == 0 else 128))
    chunks = min(-(-m // MIN_CHUNK_ROWS), max(1, blocks // slabs))
    rows = -(-m // chunks)
    return rows, -(-m // rows)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"batch_stats kernel: {msg}")


def _check(x: torch.Tensor, kernels: dict) -> None:
    _require(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _require(x.dtype in kernels, f"unsupported dtype {x.dtype}")
    _require(x.dim() == 4 and x.numel() > 0,
             f"x must be a non-empty (N,H,W,C), got {tuple(x.shape)}")
    _require(x.is_contiguous(), "x must be NHWC-contiguous (channels_last)")


def batch_stats_cuda(x: torch.Tensor):
    """Launch x's dtype's forward kernels: (var, mean) (C,) float32.
    Checks x and allocates the outputs; raises on anything the kernels do
    not take, and on a failed launch."""
    from seg2eye_tpu_torch.ops import _build

    _check(x, KERNELS)
    c = x.shape[-1]
    m = x.numel() // c
    rows, chunks = chunking(m, c, FWD_BLOCKS_PER_SM * _sms(x.device.index))
    lib = _build.library()
    partial = torch.empty((chunks, 2, c), dtype=torch.float32,
                          device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, KERNELS[x.dtype])(
        x.device.index, x.data_ptr(), partial.data_ptr(), var.data_ptr(),
        mean.data_ptr(), m, c, rows, chunks, stream)
    _build.check(lib, err, "batch_stats kernel launch")
    batch_stats.launches += 1
    return var, mean


def batch_stats_backward_cuda(x, mean, gvar, gmean) -> torch.Tensor:
    """Launch x's dtype's backward kernel: dx as
    ``batch_stats_backward_reference`` gives it.  Checks every input and
    allocates dx; raises on anything the kernel does not take, and on a
    failed launch."""
    from seg2eye_tpu_torch.ops import _build

    _check(x, BACKWARD_KERNELS)
    c = x.shape[-1]
    m = x.numel() // c
    for name, t in (("mean", mean), ("gvar", gvar), ("gmean", gmean)):
        _require(tuple(t.shape) == (c,) and t.dtype == torch.float32
                 and t.is_contiguous() and t.device == x.device,
                 f"{name} must be a contiguous ({c},) float32 tensor on "
                 f"{x.device}")
    rows, chunks = chunking(m, c, BWD_BLOCKS_PER_SM * _sms(x.device.index))
    lib = _build.library()
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, BACKWARD_KERNELS[x.dtype])(
        x.device.index, x.data_ptr(), mean.data_ptr(), gvar.data_ptr(),
        gmean.data_ptr(), dx.data_ptr(), m, c, rows, chunks, stream)
    _build.check(lib, err, "batch_stats backward kernel launch")
    batch_stats.backward_launches += 1
    return dx


# the op: the plain version for CPU tensors, the kernels for CUDA ones
batch_stats_op = torch.library.custom_op(
    "seg2eye::batch_stats", batch_stats_reference, mutates_args=(),
    device_types="cpu", schema="(Tensor x) -> (Tensor, Tensor)")


@batch_stats_op.register_kernel("cuda")
def _kernel(x):
    return batch_stats_cuda(x.contiguous())


@batch_stats_op.register_fake
def _fake(x):
    dtype = torch.promote_types(x.dtype, torch.float32)
    return (x.new_empty(x.shape[-1], dtype=dtype),
            x.new_empty(x.shape[-1], dtype=dtype))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output[1])


def _recompute_backward(x, gvar, gmean):
    """The autograd of the plain version, recomputed from x."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        return torch.autograd.grad(batch_stats_reference(x), x,
                                   (gvar, gmean))[0]


def _backward(ctx, gvar, gmean):
    """A tensor that ``takes_kernel`` takes the backward kernel; a CPU
    tensor the recomputed autograd of the plain version."""
    x, mean = ctx.saved_tensors
    gvar, gmean = (torch.zeros_like(mean) if g is None else g.contiguous()
                   for g in (gvar, gmean))
    if takes_kernel(x):
        return batch_stats_backward_cuda(x.contiguous(), mean, gvar, gmean)
    return _recompute_backward(x, gvar, gmean)


batch_stats_op.register_autograd(_backward, setup_context=_setup_context)


def batch_stats(x: torch.Tensor):
    """(var, mean) of x (N, H, W, C) over (N, H, W), biased, float32,
    through the ``seg2eye::batch_stats`` op: CPU tensors take the plain
    version, bfloat16 CUDA tensors the kernels (every launch counts in
    ``batch_stats.launches``, every backward launch in
    ``batch_stats.backward_launches``); any other raises."""
    return batch_stats_op(x)


batch_stats.launches = 0
batch_stats.backward_launches = 0
