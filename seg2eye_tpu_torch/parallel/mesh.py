"""The process grid (counterpart of ``make_mesh`` in
``seg2eye_tpu/parallel/sharding.py``).

One process per GPU; the world is data x model, and rank = d M + m, the
model index the fast axis, as ``np.asarray(devices).reshape(data,
model)`` lays out the JAX mesh.  The ranks of one data index form a model
group (they hold the slices of the tensor-parallel weights and see the
same samples); the ranks of one model index form a data group (they hold
the same slices and share each global batch).  At model 1 the data group
is the default group and nothing else is created, so a data-parallel run
is what it was without a grid.

The grid is process-wide, as the process group it is carved from is:
``make_grid`` sets it (every rank calls it, in the same order, as
``dist.new_group`` requires) and ``current`` reads it.  Without a grid
the world is the data axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    data: int
    model: int
    data_index: int
    model_index: int
    # None: the default group (data) or no group (model at model 1)
    data_group: Optional[object] = None
    model_group: Optional[object] = None


_grid: Optional[Grid] = None


def current() -> Grid:
    """The grid ``make_grid`` set, else the world on the data axis."""
    if _grid is not None:
        return _grid
    if not dist.is_initialized():
        return Grid(1, 1, 0, 0)
    return Grid(dist.get_world_size(), 1, dist.get_rank(), 0)


def grid_shape(model: int = 1, data: int = 0, world: Optional[int] = None
               ) -> tuple:
    """-> (data, model) for ``world`` processes (the process group's size
    by default), refusing what ``make_mesh`` refuses: more model ranks
    than processes, a model degree that does not divide them (a process
    cannot idle itself), an explicit data degree that is not world /
    model."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if model > world:
        raise ValueError(f"mesh 1x{model} needs {model} devices, have "
                         f"{world} process(es)")
    if world % model:
        raise ValueError(f"--model_axis {model} does not divide the {world} "
                         "processes: every process must hold a model slice")
    if data and data != world // model:
        raise ValueError(f"--data_axis {data}: the data-parallel degree is "
                         f"the world size over --model_axis, "
                         f"{world} / {model} = {world // model}")
    return world // model, model


def make_grid(model: int = 1, data: int = 0) -> Grid:
    """The grid of ``model`` x (world / model) ranks (``grid_shape``),
    with one data and one model group per rank at model > 1, set as
    ``current()``."""
    global _grid
    data, model = grid_shape(model, data)
    if model == 1:
        _grid = None
        return current()
    rank = dist.get_rank()
    data_index, model_index = divmod(rank, model)
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == model_index:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == data_index:
            model_group = g
    _grid = Grid(data, model, data_index, model_index, data_group,
                 model_group)
    return _grid
