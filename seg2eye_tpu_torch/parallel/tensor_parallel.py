"""Tensor parallelism over the model axis of the process grid (counterpart
of ``param_shardings`` in ``seg2eye_tpu/parallel/sharding.py``).

The rule is the JAX package's: every 4-D conv weight (OIHW here, dim 0 the
output channels) with at least ``min_channels`` outputs, a count that the
model degree M divides, is sharded on its outputs; model rank m keeps rows
[m O/M, (m+1) O/M) of it and of its two Adam moments.  Everything else
(biases, linears, spectral u/v, BN buffers) stays whole on every rank.
Every rank builds the full seeded state and then keeps its slice
(``shard_``), so the start is the one-process start bit for bit.

Activations stay whole and equal on the model ranks.  A sharded conv is
column-parallel: each rank convolves the whole input with its rows (and
its block of the bias, so that a bfloat16 output is rounded once, as one
process rounds it), and the output channels are gathered (``gather``).
Its backward keeps the rank's own channels of the output gradient, and
the input's gradient, partial on each rank, is summed over the model
group in at least float32 (``partial``): Megatron's f/g pair.  A whole
tensor read in blocks (the bias) gets its gradient summed likewise
(``my_block``).  So the gradient of a whole parameter is whole and equal
on every model rank.

Only ``all_reduce`` is used (gloo has no ``all_gather`` of CUDA tensors):
a gather all-reduces a zero-filled buffer in which each rank fills its
own block, which moves M times the bytes of the result where an
all-gather would move them once.  Every collective raises when it fails;
nothing falls back.

The slices are marked with ``ROWS``, the whole tensor's row count, which
checkpoints (``whole``), the replication check and the tests read.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from seg2eye_tpu_torch.parallel import mesh

ROWS = "tp_rows"        # attribute of a slice: the whole tensor's rows


def is_sharded(t: torch.Tensor) -> bool:
    return getattr(t, ROWS, None) is not None


def rule(t: torch.Tensor, model: int, min_channels: int) -> bool:
    """Whether ``param_shardings`` shards this tensor over ``model``
    ranks."""
    return (model > 1 and t.dim() == 4 and t.shape[0] >= min_channels
            and t.shape[0] % model == 0)


def rows(n: int, grid: Optional[mesh.Grid] = None) -> slice:
    """This model rank's block of ``n`` rows (or channels)."""
    grid = grid or mesh.current()
    per = n // grid.model
    return slice(grid.model_index * per, (grid.model_index + 1) * per)


@torch.no_grad()
def shard_(nets: Dict[str, torch.nn.Module],
           optimizers: Iterable[torch.optim.Optimizer],
           min_channels: int) -> int:
    """Keep this model rank's rows of every parameter that the rule
    reaches, in place (the Parameter objects stay, so the optimizers keep
    them), and of its Adam moments where they exist already (a resumed
    state).  -> the number of tensors sharded."""
    grid = mesh.current()
    n = 0
    states = [o.state for o in optimizers]
    for net in nets.values():
        for p in net.parameters():
            if not rule(p, grid.model, min_channels) or is_sharded(p):
                continue
            whole = p.shape[0]
            block = rows(whole, grid)
            p.data = p.data[block].clone()
            setattr(p, ROWS, whole)
            for state in states:
                for key, t in state.get(p, {}).items():
                    if torch.is_tensor(t) and t.dim() == 4:
                        state[p][key] = t[block].clone()
            n += 1
    return n


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.current().model_group)
    return t


def _gathered(local: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``dim`` side by side: an all-reduce of a
    zero-filled (M, ...) buffer in which this rank fills its own."""
    grid = mesh.current()
    buf = local.new_zeros((grid.model, *local.shape))
    buf[grid.model_index] = local
    _all_reduce(buf)
    return torch.cat(buf.unbind(0), dim)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A slice's whole tensor (not differentiable); other tensors as
    they are."""
    if not is_sharded(t):
        return t.detach()
    return _gathered(t.detach(), 0)


def whole_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with the moments of every slice
    gathered (every model rank calls it), every tensor a copy: an
    optimizer that loads it shares nothing with this one (a loaded state
    keeps the tensors it is given where their device and dtype match)."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        if i in sd["state"]:
            sd["state"][i] = {
                k: v if not torch.is_tensor(v) else _gathered(v, 0)
                if is_sharded(p) and v.dim() == 4 else v.clone()
                for k, v in sd["state"][i].items()}
    return sd


class _Partial(torch.autograd.Function):
    """Forward: the input.  Backward: the gradient summed over the model
    group (Megatron's f), for a whole tensor read by a computation that
    each model rank does for its own slice only."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        wide = torch.promote_types(grad.dtype, torch.float32)
        return _all_reduce(grad.to(wide, copy=True).contiguous()).to(
            grad.dtype)


class _Gather(torch.autograd.Function):
    """Forward: the model ranks' blocks of ``dim`` gathered.  Backward:
    this rank's block of the gradient, which is whole and equal on every
    model rank (Megatron's g)."""

    @staticmethod
    def forward(ctx, local, dim):
        ctx.dim, ctx.n = dim, local.shape[dim]
        return _gathered(local, dim)

    @staticmethod
    def backward(ctx, grad):
        start = mesh.current().model_index * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n), None


class _Sum(torch.autograd.Function):
    """Forward: the sum over the model group.  Backward: the gradient
    summed too; for a scalar that each model rank uses for its own slice
    only (the spectral sigma of a sharded weight)."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


def partial(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole for a computation whose gradient each model rank
    computes for its own slice: a slice is gathered, and the backward
    sums the gradient over the model group (then keeps a slice's rows)."""
    if is_sharded(t):
        t = _Gather.apply(t, 0)
    return _Partial.apply(t)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole for a computation that every model rank does alike: a
    slice is gathered, and the backward keeps its rows; a whole tensor as
    it is."""
    return _Gather.apply(t, 0) if is_sharded(t) else t


def my_block(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of ``dim`` of a whole tensor, as a view;
    the backward sums the zero-filled gradient over the model group."""
    n = t.shape[dim] // mesh.current().model
    return _Partial.apply(t).narrow(dim, rows(t.shape[dim]).start, n)


def gather(local: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The output channels (``dim``) of every model rank's slice."""
    return _Gather.apply(local, dim)


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, differentiably (``_Sum``)."""
    return _Sum.apply(t)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride=1, padding=0
           ) -> torch.Tensor:
    """``F.conv2d`` in x's dtype; column-parallel when ``weight`` is a
    slice (this rank's block of the bias in its conv, the output channels
    gathered)."""
    import torch.nn.functional as F

    sharded = is_sharded(weight)
    if bias is not None:
        bias = (my_block(bias, 0) if sharded else bias).to(x.dtype)
    if not sharded:
        return F.conv2d(x, weight.to(x.dtype), bias, stride, padding)
    return gather(F.conv2d(partial(x), weight.to(x.dtype), bias, stride,
                           padding))
