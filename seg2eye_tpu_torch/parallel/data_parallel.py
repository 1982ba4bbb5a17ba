"""Data parallelism over processes, one per GPU (counterpart of the data
axis of ``seg2eye_tpu/parallel/sharding.py``).

The JAX package shards the batch over a 'data' mesh axis and lets GSPMD
turn every reduction over the batch into a psum.  Here each process holds
one GPU (``torchrun --nproc_per_node N``) and the reductions that cross
the batch are explicit:

  * each rank holds B/N contiguous samples of every global batch of B
    (the loaders shard, ``data.openeds.DataLoader``);
  * batch statistics are global: ``synced_var_mean`` all-reduces the sums
    of the forward and, in its backward, the gradient sums (what
    ``SyncBatchNorm`` does; that module is not used because it refuses CPU
    tensors and cannot hand the statistics to the SPADE+Style kernel);
  * gradients are averaged over the global batch between ``backward()``
    and ``step()`` (``all_reduce_grads``), one flat buffer per dtype.  Not
    DDP: the generator's step backpropagates through D, whose gradients
    DDP's hooks would reduce there, and which parameters go unused changes
    with ``--D_steps_per_G``/``--reuse_fake``;
  * every rank starts from the same seeded state (``check_replicated``)
    and so keeps identical parameters; only rank 0 writes files.

Only ``all_reduce`` and ``broadcast`` are used: gloo has no ``all_gather``
of CUDA tensors, so a gather all-reduces a zero-filled buffer in which
each rank fills its own rows (``gather_rows``).

Collectives run while a process group is initialised (``active``), at
world size 1 too; ``local()`` turns them off inside, for work that one
rank does alone (rank 0's Testers).  Without a process group nothing here
communicates and the trainers take their single-process path.

Under a process grid (``parallel.mesh``, ``--model_axis`` > 1) every
collective here acts over this rank's data group, the ranks that share
the batch: the model ranks of one data index hold the same samples, so
the statistics, gathers and means see each sample once.  ``rank`` and
``world_size`` are then the data index and degree; the model ranks'
collectives are ``parallel.tensor_parallel``'s.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Iterable, Tuple

import torch
import torch.distributed as dist

from seg2eye_tpu_torch.parallel import mesh
from seg2eye_tpu_torch.parallel import tensor_parallel as tp

_local_depth = 0


def init_from_env(device: str | torch.device) -> torch.device:
    """The device of this process, with the process group initialised
    when torchrun's environment asks for more than one process
    (``WORLD_SIZE`` > 1): NCCL on ``cuda:LOCAL_RANK``, gloo with a CPU
    ``device``.  Without it the run is one process and nothing is
    initialised.  A failed initialisation raises; there is no fallback to
    one process."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return device


def rank() -> int:
    """This process's index on the data axis (``jax.process_index`` of a
    data mesh): its rank without a grid, 0 without a group."""
    return mesh.current().data_index


def world_size() -> int:
    """The number of processes that share each batch here (the data
    degree, ``jax.process_count`` of a data mesh): 1 without a group or
    inside ``local()``."""
    return mesh.current().data if active() else 1


def group():
    """The data group of this rank (None: the default group)."""
    return mesh.current().data_group


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0 of the world,
    the first model rank of data index 0."""
    return rank() == 0 and mesh.current().model_index == 0


def active() -> bool:
    """Whether reductions over the batch cross processes here: a process
    group is initialised and no ``local()`` is open."""
    return dist.is_initialized() and _local_depth == 0


@contextlib.contextmanager
def local():
    """Inside, this process computes as if it were alone: no collective
    (rank 0's evaluations, which the other ranks do not join)."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


def check_batch(batch: int, world: int) -> int:
    """-> the local batch, batch // world.  A global batch that ``world``
    does not divide is an error, as ``make_mesh`` refuses it for an
    explicit data axis; a process cannot idle itself, so the JAX package's
    single-process shrink of the data axis has no counterpart."""
    if batch % world:
        raise ValueError(f"the global batch {batch} is not divisible by the "
                         f"{world} data-parallel processes; pick a batch "
                         f"that is a multiple of the world size")
    return batch // world


def local_rows(arrays: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s contiguous B/N rows of each array of a global batch
    of B (arrays of another length, and other values, unchanged)."""
    n = len(next(iter(v for v in arrays.values() if hasattr(v, "shape"))))
    b = check_batch(n, world)
    return {k: v[rank * b:(rank + 1) * b]
            if hasattr(v, "shape") and len(v) == n else v
            for k, v in arrays.items()}


class _SyncedVarMean(torch.autograd.Function):
    """Global mean and biased variance over ``dims`` of every rank's x, in
    two passes (the sums and the count, then the squared deviations); the
    backward all-reduces the gradients of both before it distributes
    them, as each rank's loss reaches every rank's statistics."""

    @staticmethod
    def forward(ctx, x, dims, group):
        ctx.group = group
        kept = [s for d, s in enumerate(x.shape) if d not in dims]
        count = torch.full((1,), x.numel() // math.prod(kept),
                           dtype=x.dtype, device=x.device)
        buf = torch.cat([x.sum(dims).reshape(-1), count])
        dist.all_reduce(buf, group=ctx.group)
        total = buf[-1]
        mean = (buf[:-1] / total).reshape(kept)
        shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
        sq = (x - mean.reshape(shape)).square().sum(dims)
        dist.all_reduce(sq, group=ctx.group)
        var = sq / total
        ctx.shape = shape
        ctx.mark_non_differentiable(total)
        ctx.save_for_backward(x, mean, total)
        return var, mean, total

    @staticmethod
    def backward(ctx, grad_var, grad_mean, _grad_count):
        x, mean, total = ctx.saved_tensors
        grad_var = torch.zeros_like(mean) if grad_var is None else grad_var
        grad_mean = torch.zeros_like(mean) if grad_mean is None \
            else grad_mean
        buf = torch.cat([grad_var.reshape(-1), grad_mean.reshape(-1)])
        dist.all_reduce(buf, group=ctx.group)
        g_var, g_mean = (t.reshape(ctx.shape) for t in buf.chunk(2))
        dx = (g_mean + 2.0 * g_var * (x - mean.reshape(ctx.shape))) / total
        return dx, None, None


def synced_var_mean(x: torch.Tensor, dims: Tuple[int, ...], over=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (biased variance, mean, count): over ``dims`` of the global
    batch, every rank's x together (``torch.var_mean(x, dims,
    correction=0)`` of the concatenated batch, up to summation order), and
    the global number of elements behind each statistic (a 0-d tensor),
    for the unbiased running variance.  Differentiable.  ``over``: the
    process group whose x's are parts of one tensor (the data group by
    default; the H bands' group in ``parallel.spatial``)."""
    return _SyncedVarMean.apply(x, tuple(dims),
                                group() if over is None else over)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Every gradient replaced by its mean over the data ranks: one
    all-reduce of one flat buffer per dtype.  Under a process grid a whole
    parameter's gradient is averaged over every rank, the model ranks
    too: each model rank computes it alike, but the card's kernels may
    sum in another order on each (cuDNN's nondeterministic algorithms),
    and the ranks' copies must stay bit for bit equal.  A model slice's is
    averaged over its data group.  Parameters without a gradient have
    none on every rank (every rank runs the same graph).  No-op unless
    ``active()``."""
    if not active():
        return
    grid = mesh.current()
    by_kind: Dict[Tuple[torch.dtype, bool], list] = {}
    for p in params:
        if p.grad is not None:
            by_kind.setdefault((p.grad.dtype, tp.is_sharded(p)),
                               []).append(p.grad)
    for (_, sharded), grads in by_kind.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        if sharded:
            dist.all_reduce(flat, group=grid.data_group)
            flat.div_(grid.data)
        else:
            dist.all_reduce(flat)
            flat.div_(grid.data * grid.model)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view(g.shape))


@torch.no_grad()
def broadcast_buffers(modules: Iterable[torch.nn.Module]) -> None:
    """Under a process grid, every buffer of ``modules`` (spectral u/v,
    running statistics, ``num_batches_tracked``) set to the first model
    rank's of this rank's model group: one broadcast per dtype.  The model
    ranks compute them alike from whole activations, but the card's
    kernels may take another algorithm on each (cuDNN falls back to
    another one where a workspace cannot be allocated, and the ranks of
    one card see different free memory), and the ranks' copies must stay
    bit for bit equal.  No-op at model 1 and unless ``active()``."""
    grid = mesh.current()
    if grid.model == 1 or not active():
        return
    by_kind: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for m in modules:
        for b in m.buffers():
            by_kind.setdefault((b.dtype, b.device), []).append(b)
    src = grid.data_index * grid.model
    for bufs in by_kind.values():
        flat = torch.cat([b.reshape(-1) for b in bufs])
        dist.broadcast(flat, src=src, group=grid.model_group)
        for b, part in zip(bufs, flat.split([b.numel() for b in bufs])):
            b.copy_(part.view(b.shape))


def mean_over_ranks(values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The mean of each tensor's mean over the ranks, by one all-reduce
    (logged losses, which are means over equal local batches); the means
    themselves without ``active()``."""
    keys = list(values)
    if not keys:
        return {}
    means = torch.stack([values[k].detach().double().mean() for k in keys])
    if active():
        dist.all_reduce(means, group=group())
        means = means / world_size()
    return dict(zip(keys, means.unbind()))


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, in place (confusion matrices); t without
    ``active()``."""
    if active():
        dist.all_reduce(t, group=group())
    return t


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank.  Backward: each rank's gradient of
    all the rows summed over the ranks, then its own rows kept; a loss
    that every rank computes alike over the gathered rows then reaches
    each rank's rows N times, which ``all_reduce_grads``' mean undoes."""

    @staticmethod
    def forward(ctx, local):
        b = ctx.b = local.shape[0]
        out = local.new_zeros((b * world_size(), *local.shape[1:]))
        out[rank() * b:(rank() + 1) * b] = local
        dist.all_reduce(out, group=group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group())
        return grad[rank() * ctx.b:(rank() + 1) * ctx.b]


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every rank's (b, ...) rows stacked in rank order -> (N b, ...): an
    all-reduce of a zero-filled buffer in which each rank fills its own.
    Differentiable (see ``_GatherRows``); ``local`` itself without
    ``active()``."""
    if not active():
        return local
    return _GatherRows.apply(local)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, the same on every rank; differentiable
    (through ``gather_rows``), for losses that normalise by a count of the
    whole batch.  t without ``active()``."""
    if not active():
        return t
    return gather_rows(t[None]).sum(0)


@torch.no_grad()
def check_replicated(tensors: Dict[str, torch.Tensor], what: str) -> None:
    """Rank 0's ``tensors`` broadcast to every rank, which must hold the
    same values already (each rank builds its state from the same seed or
    checkpoint); a rank that differs raises, naming the first tensor.  A
    tensor-parallel slice (``tensor_parallel.is_sharded``) is held to the
    first rank of this rank's data group instead, which holds the same
    slice.  No-op unless ``active()``."""
    if not active():
        return
    grid = mesh.current()
    sharded = {k: t for k, t in tensors.items() if tp.is_sharded(t)}
    whole = {k: t for k, t in tensors.items() if k not in sharded}
    _check_equal(whole, what, src=0, group=None)
    _check_equal(sharded, what, src=grid.model_index, group=grid.data_group)


def _check_equal(tensors: Dict[str, torch.Tensor], what: str, src: int,
                 group) -> None:
    """The ``tensors`` of global rank ``src`` broadcast over ``group``;
    a rank whose own differ raises."""
    by_dtype: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for name, t in tensors.items():
        by_dtype.setdefault((t.dtype, t.device), []).append((name, t))
    for items in by_dtype.values():
        mine = torch.cat([t.reshape(-1) for _, t in items])
        theirs = mine.clone()
        dist.broadcast(theirs, src=src, group=group)
        if torch.equal(mine, theirs):
            continue
        sizes = [t.numel() for _, t in items]
        for (name, _), a, b in zip(items, mine.split(sizes),
                                   theirs.split(sizes)):
            if not torch.equal(a, b):
                raise RuntimeError(
                    f"rank {dist.get_rank()}: {what} {name} differs from "
                    f"rank {src}'s; every rank must start from the same "
                    "state")


def module_tensors(modules: Dict[str, torch.nn.Module]
                   ) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``modules``, by '{key}.{name}'."""
    return {f"{key}.{name}": t for key, m in modules.items()
            for name, t in m.state_dict(keep_vars=True).items()}
