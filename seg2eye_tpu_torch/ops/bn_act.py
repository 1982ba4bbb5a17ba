"""Eval-mode batch norm, residual add and ReLU in one pass: the CUDA kernel,
its plain version and the ``seg2eye::bn_act`` op.

On its running statistics a batch norm is a per-channel affine map.  The
DeepLab sites follow it with a ReLU, and a ResNet bottleneck's last BN with
the residual add first (the residual through its own BN where the block
projects it).  The plain version, ``bn_act_reference``, is that chain as
the models wrote it: ``F.batch_norm`` in eval, the add, ``torch.relu``;
in bfloat16 each op reads and writes its tensor and rounds on its own.
The kernel of ``csrc/bn_act_sm90.cu`` computes

    y = relu(x s + t  [+ r  |  + r s2 + t2]),
    s = w / sqrt(running_var + eps),  t = b - running_mean s

in float32 from one read of x (and of r) and writes y once, rounded once
to bfloat16.  The JAX package has no kernel for it: XLA fuses the chain.

``takes_kernel`` is the rule the sites route by (``models.layers.
bn_relu``): a bfloat16 CUDA tensor in an eval forward (``train`` False)
that autograd does not record.  Everything else keeps the plain version,
bit for bit: every training forward, float32, the CPU.  What the rule
takes, the kernel takes in either of the layouts ``planes`` names
(channels_last rows with C a multiple of 8, or NCHW planes); any other
tensor raises at the launch, so no site leaves the kernel unseen.

``bn_act`` is the entry point for what the rule takes.  Outside a trace
a CUDA tensor goes straight to the launch (``bn_act_cuda``), without the
dispatcher's host cost; a traced forward (``torch.export``) records the
``seg2eye::bn_act`` op, whose registrations choose by device: the plain
version on the CPU, the kernel on CUDA.  The layout is read at the launch,
from the real tensors: export's traced CUDA convolutions come out NCHW
where the card's are channels_last.
"""
from __future__ import annotations

import array
import functools

import torch
import torch.nn.functional as F

from seg2eye_tpu_torch.utils.spans import BN_ACT, span

ENTRY_POINT = "bn_act_bf16_sm90"
SOURCE = "seg2eye_tpu_torch/ops/csrc/bn_act_sm90.cu"
# the kernels' names as the profiler prints them, per layout (rows, then
# planes) and residual: 0 none, 1 r added, 2 r through its own BN.  They
# have none of the substrings of portbench.trace.GROUPS' other groups, so
# their time counts as a memory pass, where the BN, add and ReLU passes
# they replace counted.
KERNEL = "bn_act_kernel"
_PARAMS = ("__nv_bfloat16 const*, __nv_bfloat16 const*, "
           + "float const*, " * 8 + "__nv_bfloat16*, long long, int, ")
KERNEL_NAMES = tuple(
    f"void (anonymous namespace)::{KERNEL}{kind}<{res}>({_PARAMS}{tail}, "
    "float, float)"
    for kind, tail in (("", "int"), ("_planes", "long long"))
    for res in (0, 1, 2))


def bn_act_reference(x, weight, bias, mean, var, eps, r=None, r_weight=None,
                     r_bias=None, r_mean=None, r_var=None, r_eps=1e-5):
    """The plain version: ``F.batch_norm`` of x on its running statistics,
    plus r (through its own BN where ``r_weight`` is given), then
    ``torch.relu``; each op in x's dtype, as ``layers.BatchNorm`` and the
    sites compute them."""
    y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
    if r is not None:
        if r_weight is not None:
            r = F.batch_norm(r, r_mean, r_var, r_weight, r_bias, False, 0.0,
                             r_eps)
        y = y + r
    return torch.relu(y)


def traced(x: torch.Tensor) -> bool:
    """Whether x is a traced value (``torch.export``, ``torch.compile``),
    not a tensor with data."""
    return type(x) is not torch.Tensor or torch.compiler.is_compiling()


def planes(x, r, weights) -> int:
    """The layout the kernel reads x, r and y in: 0 for channels_last rows
    (C a multiple of 8), H W for contiguous NCHW planes.  x (N, C, H, W)
    bfloat16, non-empty, 16-byte aligned; r None or as x, in the same
    layout; each BN's weight (x's, and r's or None) float32 with C
    elements on the card.  A BN's other vectors are its module's, of its
    weight's dtype, size and device.  Raises ValueError on anything else."""
    if x.dtype is not torch.bfloat16 or x.dim() != 4 or not x.numel() \
            or x.data_ptr() % 16:
        raise ValueError(f"bn_act: x {x.dtype} {tuple(x.shape)} at "
                         f"{x.data_ptr():#x}: the kernel takes 16-byte "
                         "aligned, non-empty (N, C, H, W) bfloat16")
    c = x.size(1)
    for w in weights:
        if w is not None and (w.dtype is not torch.float32
                              or w.numel() != c or not w.is_cuda):
            raise ValueError(f"bn_act: a BN weight {w.dtype} of "
                             f"{w.numel()} on {w.device} for C {c}: the "
                             "kernel takes float32 (C,) on the card")
    if c % 8 == 0 and x.is_contiguous(memory_format=torch.channels_last):
        fmt, length = torch.channels_last, 0
    elif x.is_contiguous():
        fmt, length = torch.contiguous_format, x.size(2) * x.size(3)
    else:
        raise ValueError(f"bn_act: x {tuple(x.shape)} strides {x.stride()}"
                         ": the kernel takes channels_last with C a "
                         "multiple of 8, or contiguous NCHW")
    if r is not None and (r.shape != x.shape or r.dtype is not x.dtype
                          or r.data_ptr() % 16
                          or not r.is_contiguous(memory_format=fmt)):
        raise ValueError(f"bn_act: r {r.dtype} {tuple(r.shape)} strides "
                         f"{r.stride()} at {r.data_ptr():#x}: the kernel "
                         f"takes r as x, {x.dtype} {tuple(x.shape)} "
                         f"strides {x.stride()}, 16-byte aligned")
    return length


def takes_kernel(x, train: bool, r=None, params=()) -> bool:
    """The sites' rule: x bfloat16 on CUDA, ``train`` False, no autograd
    recording of x, r or ``params`` (x's BN vectors, then r's).  The
    layout is the kernel's to take (``planes``), not the rule's."""
    if train or not x.is_cuda or x.dtype is not torch.bfloat16:
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, r, *params)))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bn_act_cuda(x, weight, bias, mean, var, eps, r=None, r_weight=None,
                r_bias=None, r_mean=None, r_var=None,
                r_eps=1e-5) -> torch.Tensor:
    """Launch the kernel: y in x's layout, bfloat16, as
    ``bn_act_reference`` gives it up to the roundings it saves; a
    ValueError where ``planes`` refuses the tensors.  The launch's integers
    go in one int64 array (the layout in ``csrc/bn_act_sm90.cu``): ctypes
    converts each argument of a call on its own, and this launch is all the
    host does at a site.  One ``utils.spans.BN_ACT`` span per launch under
    a profiler; raises on a failed launch."""
    from seg2eye_tpu_torch.ops import _build

    length = planes(x, r, (weight, r_weight))
    lib = _build.library()
    c = x.size(1)
    y = torch.empty_like(x)
    index = x.get_device()
    projected = r_weight is not None
    launch = array.array("q", (
        index, x.data_ptr(), 0 if r is None else r.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
        r_weight.data_ptr() if projected else 0,
        r_bias.data_ptr() if projected else 0,
        r_mean.data_ptr() if projected else 0,
        r_var.data_ptr() if projected else 0, y.data_ptr(),
        x.numel() // (length or c), c, _sms(index),
        torch._C._cuda_getCurrentRawStream(index), length))
    with span(BN_ACT):
        err = lib.bn_act_bf16_sm90(launch.buffer_info()[0], eps, r_eps)
    if err:
        _build.check(lib, err, "bn_act kernel launch")
    bn_act.launches += 1
    return y


# the op: the plain version for CPU tensors, the kernel for CUDA ones
bn_act_op = torch.library.custom_op(
    "seg2eye::bn_act", bn_act_reference, mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor weight, Tensor bias, Tensor mean, Tensor var, "
           "float eps, Tensor? r=None, Tensor? r_weight=None, "
           "Tensor? r_bias=None, Tensor? r_mean=None, Tensor? r_var=None, "
           "float r_eps=1e-05) -> Tensor")
bn_act_op.register_kernel("cuda")(bn_act_cuda)


@bn_act_op.register_fake
def _fake(x, weight, bias, mean, var, eps, r=None, r_weight=None,
          r_bias=None, r_mean=None, r_var=None, r_eps=1e-5):
    return torch.empty_like(x)


def bn_act(x, weight, bias, mean, var, eps, r=None, r_weight=None,
           r_bias=None, r_mean=None, r_var=None,
           r_eps=1e-5) -> torch.Tensor:
    """relu(BN(x) [+ r | + BN2(r)]) on running statistics, for tensors
    that ``takes_kernel`` takes: outside a trace the kernel's launch
    itself, without the dispatcher; traced, or on the CPU, the
    ``seg2eye::bn_act`` op.  Every kernel launch counts in
    ``bn_act.launches``."""
    args = (x, weight, bias, mean, var, eps, r, r_weight, r_bias, r_mean,
            r_var, r_eps)
    if traced(x) or not x.is_cuda:
        return bn_act_op(*args)
    return bn_act_cuda(*args)


bn_act.launches = 0
