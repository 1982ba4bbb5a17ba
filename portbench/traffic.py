"""The one traffic generator: a seeded ring of distinct uint8 host batches.

A cell's file (``workloads/<cell>.json``) describes its traffic as data:

    "sizes":  {"batch": 16, "height": 320, ...},
    "arrays": {"label": [["batch", "height", "width"], 4],
               "input": [["batch", "height", "width", 3], 256,
                         [1, 16, 16, 1]], ...},
    "ring":   8

Each array is uniform uint8 in [0, high) at a shape whose entries are
numbers or names from ``sizes``; an optional third entry gives a block per
axis: the values are drawn at the shape divided by it (rounded up) and
each repeated over its block (piecewise-constant regions, as masks and
smooth images have).  Slot r of the ring is drawn from stream
``traffic/r/<array>`` of the run's seed, on the device with a
``torch.Generator`` and copied once into pinned host memory, so every
seed gives batches of the same shapes in another content, and steps walk
the ring in order (step i takes slot i mod ring).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.common import seed_of


def shape_of(spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    return tuple(int(sizes[d]) if isinstance(d, str) else int(d)
                 for d in spec)


def draw(shape, high: int, gen: torch.Generator, device,
         block=None) -> torch.Tensor:
    """Uniform uint8 in [0, high), constant over blocks of ``block``."""
    if block is None:
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=torch.uint8)
    low = tuple(-(-n // b) for n, b in zip(shape, block))
    t = torch.randint(0, high, low, generator=gen, device=device,
                      dtype=torch.uint8)
    for axis, b in enumerate(block):
        if b > 1:
            t = t.repeat_interleave(b, dim=axis)
    return t[tuple(slice(0, n) for n in shape)].contiguous()


class Ring:
    """``ring`` host batches: dicts of numpy uint8 arrays over pinned
    tensors (kept alive here), as the program's loaders hand them out."""

    def __init__(self, cell: Dict, seed: int, device):
        device = torch.device(device)
        sizes = cell["sizes"]
        self._tensors: List[Dict[str, torch.Tensor]] = []
        for r in range(cell["ring"]):
            slot = {}
            for name, (spec, high, *blocks) in cell["arrays"].items():
                gen = torch.Generator(device=device).manual_seed(
                    seed_of(seed, f"traffic/{r}/{name}"))
                t = draw(shape_of(spec, sizes), high, gen, device,
                         blocks[0] if blocks else None)
                if device.type == "cuda":
                    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    slot[name] = host.copy_(t)
                else:
                    slot[name] = t
            self._tensors.append(slot)
        self.batches = [{k: t.numpy() for k, t in slot.items()}
                        for slot in self._tensors]

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, i: int) -> Dict:
        return self.batches[i % len(self.batches)]

    def cycle(self):
        i = 0
        while True:
            yield self[i]
            i += 1


def meta_batch(cell: Dict) -> Dict[str, torch.Tensor]:
    """The cell's batch as shapes alone (``meta``), for counting FLOPs."""
    return {k: torch.empty(shape_of(spec, cell["sizes"]), dtype=torch.uint8,
                           device="meta")
            for k, (spec, *_) in cell["arrays"].items()}
