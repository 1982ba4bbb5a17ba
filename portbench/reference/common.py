"""Shared pieces of the plain reference: the precision of its products,
state-dict specs and the weights drawn from a seed.

The reference computes in float32 with TF32 off.  ``Products`` decides how
the operands of every convolution and linear layer, forward and backward,
are rounded before the float32 product:

  * ``f32``: not at all (the reference);
  * ``tf32``: to TF32, nearest with ties away from zero, as the tensor
    cores' ``cvt.rna.tf32.f32`` does, the forward's operands and the
    backward's incoming gradient (the control of a float32 cell);
  * ``fp8``: the forward's operands to float8 e4m3 and the backward's
    incoming gradient to e5m2, each with one scale per tensor, amax over
    the format's largest value (the control of a bfloat16 cell).

Everything else (norms, losses, optimizers) is float32 on both sides.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32 on the card, the flags restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


# how each precision rounds the operands of a forward product and the
# incoming gradient of its backward products: TF32 both ways; float8 e4m3
# forward and e5m2 backward, one scale per tensor (amax / the format's max)
ROUNDING = {
    "tf32": (_tf32, _tf32),
    "fp8": (lambda t: _fp8(t, torch.float8_e4m3fn),
            lambda t: _fp8(t, torch.float8_e5m2)),
}


class _Conv(torch.autograd.Function):
    """conv2d of rounded operands, its backward products of the rounded
    gradient and the rounded saved operands."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, precision):
        fwd, _ = ROUNDING[precision]
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, dilation, precision, b is not None)
        return F.conv2d(xq, wq, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, precision, has_bias = ctx.conf
        gq = ROUNDING[precision][1](g)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding,
                                            dilation)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride,
                                             padding, dilation)
        if has_bias and ctx.needs_input_grad[2]:
            gb = g.sum((0, 2, 3))
        return gx, gw, gb, None, None, None, None


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, precision):
        fwd, _ = ROUNDING[precision]
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (precision, b is not None)
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        precision, has_bias = ctx.conf
        gq = ROUNDING[precision][1](g)
        gx = gq @ wq if ctx.needs_input_grad[0] else None
        gw = gq.T @ xq if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


@dataclass(frozen=True)
class Products:
    precision: str = "f32"

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r} is not one of "
                             f"{PRECISIONS}")

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        if self.precision == "f32":
            return F.conv2d(x, w, b, stride, padding, dilation)
        return _Conv.apply(x, w, b, stride, padding, dilation,
                           self.precision)

    def linear(self, x, w, b=None):
        if self.precision == "f32":
            return F.linear(x, w, b)
        return _Linear.apply(x, w, b, self.precision)


@dataclass(frozen=True)
class Spec:
    """One state-dict entry: ``init`` is 'normal' (std ``std``), 'zeros',
    'ones', 'const' (every entry ``value``), 'count' (an int64 0), 'u' (a
    random unit vector) or 'v' (the unit W^T u of the spectral weight
    ``of``)."""
    name: str
    shape: tuple
    init: str
    std: float = 0.0
    of: str = ""
    value: float = 0.0


def fan_in_std(shape: Sequence[int], gain: float = 1.0) -> float:
    return gain / math.sqrt(math.prod(shape[1:]))


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed`` (any whole
    number, larger than 32 bits too)."""
    import hashlib

    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


@torch.no_grad()
def make_state(specs: List[Spec], seed: int, device,
               tag: str = "weights") -> Dict[str, torch.Tensor]:
    """The state dict of ``specs`` drawn on ``device`` from stream ``tag``
    of ``seed``: every normal entry from one draw, then scaled; float32,
    counts int64.  On the ``meta`` device: the shapes alone."""
    device = torch.device(device)
    if device.type == "meta":
        return {s.name: torch.empty(s.shape, device=device,
                                    dtype=torch.long if s.init == "count"
                                    else torch.float32) for s in specs}
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, tag))
    drawn = [s for s in specs if s.init in ("normal", "u")]
    flat = torch.empty(sum(math.prod(s.shape) for s in drawn),
                       device=device).normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for s in drawn:
        n = math.prod(s.shape)
        t = flat[at:at + n].view(s.shape).clone()
        at += n
        out[s.name] = _l2n(t) if s.init == "u" else t.mul_(s.std)
    for s in specs:
        if s.init == "zeros":
            out[s.name] = torch.zeros(s.shape, device=device)
        elif s.init == "ones":
            out[s.name] = torch.ones(s.shape, device=device)
        elif s.init == "const":
            out[s.name] = torch.full(s.shape, s.value, device=device)
        elif s.init == "count":
            out[s.name] = torch.zeros((), dtype=torch.long, device=device)
    for s in specs:
        if s.init == "v":
            w = out[s.of + ".weight_orig"]
            u = out[s.of + ".weight_u"]
            out[s.name] = _l2n(w.reshape(w.shape[0], -1).T @ u)
    return {s.name: out[s.name] for s in specs}


def parameter_count(specs: List[Spec]) -> int:
    """Entries that are trained (not buffers)."""
    buffers = ("running_mean", "running_var", "num_batches_tracked",
               "weight_u", "weight_v")
    return sum(math.prod(s.shape) for s in specs
               if not s.name.endswith(buffers))
