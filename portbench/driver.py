"""What every driver (``drivers/<name>.py``) provides, and the comparisons
that decide ``correct``.

A driver builds the program's objects for one entry point from the
benchmark's seeded weights and ring, and runs one timed step at a time.
Two kinds:

  * ``TrainDriver``: ``setup`` drives the one train state from the seed
    through its first ``CHECKED_STEPS`` steps with the window's own call
    and feed, and records what the check compares: each step's losses, the
    first gradient as the optimizer got it (read from its state after one
    step), each leaf's change after the last checked step, and the buffers
    then; the window continues with the same state.
  * ``ServeDriver``: each step ends with its outputs on the host; a
    reservoir drawn from the seed keeps ``sample`` of the window's batches,
    which the reference recomputes from the same host batches.

The reference (``reference_readings``) runs after the window, once the
program's state is freed, from weights drawn again from the seed.  Its
control is the same reference with the products of the precision below
the cell's (``Products``).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference.common import seed_of
from portbench.traffic import Ring

CHECKED_STEPS = 3
# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam or momentum by round-off alone: left out of the change
ROUND_OFF_LEAF = 1e-3
# the control's precision below each cell dtype
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


class Driver:
    training = False

    def __init__(self, cell: Dict, cfg: Dict, seed: int, device):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.ring: Optional[Ring] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_ring(self) -> None:
        self.ring = Ring(self.cell, self.seed, self.device)

    # the program: overridden
    def setup(self) -> None:
        raise NotImplementedError

    def step(self, i: int):
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    # the check
    def readings(self) -> Dict:
        raise NotImplementedError

    def reference_readings(self, precision: str) -> Dict:
        raise NotImplementedError

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        raise NotImplementedError

    def model_flops(self) -> float:
        """FLOPs of one step, counted on the reference (``roofline``)."""
        raise NotImplementedError

    def check(self) -> List[Dict]:
        """Each number compared, beside its limit (``cell['limits']``)."""
        prog = self.readings()
        ref = self.reference_readings("f32")
        got = self.compare(prog, ref)
        limits = self.cell["limits"]
        return [{"name": k, "value": got[k], "limit": limits[k]}
                for k in limits]


class TrainDriver(Driver):
    """A subclass builds the program (``build``), runs a step (``step``:
    -> the step's losses), and reads the program's state: ``loss_values``,
    ``named_params``, ``named_buffers``, ``first_gradients`` (the gradient
    as the optimizer got it, from its state after one step) and
    ``initial_params`` (drawn again from the seed)."""
    training = True

    def build(self) -> None:
        raise NotImplementedError

    def setup(self) -> None:
        self.build()
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(self.loss_values(self.step(i)))
            if i == 0:
                grad1 = norms(self.first_gradients())
        p0 = self.initial_params()
        params = self.named_params()
        change = norms({k: params[k].detach() - p0[k] for k in p0})
        del p0
        buffers = {k: v.detach().clone()
                   for k, v in self.named_buffers().items()}
        self._readings = {"losses": losses, "grad1": grad1,
                          "change": change, "buffers": buffers}
        self.start = CHECKED_STEPS

    def readings(self) -> Dict:
        return self._readings

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        return compare_training(prog, ref)


class ServeDriver(Driver):
    """A subclass builds the program (``build``), runs one batch (``run``:
    step -> outputs on the host) and recomputes sampled batches on the
    reference (``reference_outputs``: precision, ring slots -> outputs)."""

    def build(self) -> None:
        raise NotImplementedError

    def run(self, i: int) -> Dict:
        raise NotImplementedError

    def reference_outputs(self, precision: str, slots: List[int]) -> List:
        raise NotImplementedError

    def compare_outputs(self, prog: List, ref: List) -> Dict[str, float]:
        raise NotImplementedError

    def setup(self) -> None:
        self.build()
        self.sampling = False
        self.reservoir = Reservoir(int(self.cell["sample"]), self.seed)
        for i in range(int(self.cell["warmup"])):
            self.step(i)
        self.start = int(self.cell["warmup"])

    def step(self, i: int) -> Dict:
        out = self.run(i)
        if self.sampling:
            self.reservoir.offer(i, i % len(self.ring), out)
        return out

    def readings(self) -> List:
        return [(slot, out) for _, slot, out in self.reservoir.kept]

    def reservoir_from_slots(self, slots) -> None:
        """A sample of the given ring slots without a window (a control
        read on its own)."""
        self.reservoir = Reservoir(len(slots), self.seed)
        self.reservoir.kept = [(s, s, None) for s in slots]

    def reference_readings(self, precision: str) -> List:
        slots = [slot for slot, _ in self.readings()]
        return list(zip(slots, self.reference_outputs(precision, slots)))

    def compare(self, prog: List, ref: List) -> Dict[str, float]:
        return self.compare_outputs([o for _, o in prog],
                                    [o for _, o in ref])


def correct(numbers: List[Dict]) -> bool:
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"]
               for n in numbers)


# ----------------------------------------------------------------- training
def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= ROUND_OFF_LEAF * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """|prog - ref| / max(ref, median of ref) per leaf; a leaf the program
    lacks reads 1."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: (abs(prog[k] - ref[k]) if k in prog else ref[k])
            / max(ref[k], med) for k in leaves}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def buffer_gap(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> float:
    """Worst float buffer's ||prog - ref|| / max(||ref||, median ||ref||);
    an integer buffer that differs reads 1."""
    floats = {k: v for k, v in ref.items() if v.is_floating_point()}
    sizes = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in floats.items()}
    med = statistics.median(sizes.values())
    worst = 0.0
    for k, v in ref.items():
        if k not in prog:
            return 1.0
        if v.is_floating_point():
            d = float(torch.linalg.vector_norm(
                prog[k].double() - v.double().to(prog[k].device)))
            worst = max(worst, d / max(sizes[k], med))
        elif not torch.equal(prog[k].cpu(), v.cpu()):
            worst = max(worst, 1.0)
    return worst


def compare_training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Readings: 'losses' [{name: value} per step], 'grad1' {leaf: norm},
    'change' {leaf: norm}, 'buffers' {name: tensor}.  The first gradient
    is compared by its worst leaf and by its median leaf; a cell's limits
    name the numbers it holds."""
    loss_gap = max(abs(p[k] - r[k]) / abs(r[k])
                   for p, r in zip(prog["losses"], ref["losses"]) for k in r)
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    leaves = kept_leaves(ref["grad1"])
    grad1 = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    return {"loss_gap": loss_gap,
            "grad1_gap": max(grad1.values()),
            "grad1_median_gap": statistics.median(grad1.values()),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"],
                                         leaves),
            "buffer_gap": buffer_gap(prog["buffers"], ref["buffers"])}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors.values()]).cpu().tolist()
    return dict(zip(tensors, vals))


# ----------------------------------------------------------------- serving
class Reservoir:
    """A uniform sample of ``size`` of the window's steps, drawn from the
    seed: (step, ring slot, outputs)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed_of(seed, "sample") % 2 ** 63)
        self.kept: List = []
        self.seen = 0

    def offer(self, step: int, slot: int, outputs: Dict) -> None:
        if len(self.kept) < self.size:
            self.kept.append((step, slot, outputs))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (step, slot, outputs)
        self.seen += 1


def rms_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The worst image's RMS gap over the RMS of the reference's image, of
    (B, ...) batches."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    d = (prog - ref).reshape(len(ref), -1)
    r = ref.reshape(len(ref), -1)
    return float(np.max(np.sqrt(np.mean(d ** 2, 1))
                        / np.sqrt(np.mean(r ** 2, 1))))
