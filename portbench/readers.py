"""The arithmetic behind the metric files (``metrics/<name>.py``): each
takes a ``harness.Run`` and returns a number, or None where the run has
nothing to read (no traced slice, no such op on the path)."""
from __future__ import annotations

import math
from typing import Optional

from portbench import roofline
from portbench.trace import BACKWARD_RANGE, K1_OP

GIB = 2.0 ** 30


# ---- end to end, from the host clock
def images_per_s(run) -> float:
    """Images of every step of the window over the window's seconds."""
    return run.images / run.seconds


def p95_ms(run) -> float:
    """The 95th percentile (nearest rank) of every step's latency."""
    ordered = sorted(run.latencies)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] * 1e3


def setup_s(run) -> float:
    """From the process's start to the first step of the window."""
    return run.setup_s


# ---- per layer, from the traced slice and the window
def idle_share(run) -> Optional[float]:
    """% of the traced slice in which no kernel or copy ran on the card."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)


def mfu(run) -> Optional[float]:
    """% of the card's peak: the reference's model FLOPs of every step of
    the window over the window's seconds."""
    if run.trace is None:
        return None
    peak, _ = roofline.peaks(run.card, run.cell["dtype"])
    return 100.0 * run.model_flops * run.steps / run.seconds / peak


def k1_roofline(run) -> Optional[float]:
    """% of K1's bound: the least time of every ``seg2eye::spade_style``
    forward call in the slice over the device time of all kernels under
    those calls.  The calls come in generator forwards, each over the
    configuration's norm sites in order (``reference.seg2eye.site_shapes``
    at the cell's batch), whose work ``roofline.k1_work`` counts."""
    if run.trace is None:
        return None
    from portbench.reference.seg2eye import site_shapes

    calls = [e for e in run.trace.ops_named(K1_OP)
             if not (e.cpu_parent is not None and e.cpu_parent.name == K1_OP)]
    device_s = sum(e.device_time_total for e in calls) / 1e6
    if not calls or device_s <= 0:
        return None
    sites = site_shapes(run.cfg, int(run.cell["sizes"]["batch"]))
    if len(calls) % len(sites):
        raise RuntimeError(f"{len(calls)} K1 calls are not whole forwards "
                           f"of {len(sites)} sites")
    dtype = run.cell["dtype"]
    per_forward = sum(roofline.bound_s(*roofline.k1_work(
        shape, run.cfg["label_nc"], dtype), run.card, dtype)
        for shape in sites)
    return 100.0 * per_forward * len(calls) / len(sites) / device_s


def norm_backward_ms(run) -> Optional[float]:
    """Device ms per step inside the port's norm-site backward range."""
    if run.trace is None:
        return None
    ranges = run.trace.ops_named(BACKWARD_RANGE)
    if not ranges:
        return None
    return sum(e.device_time_total for e in ranges) / 1e3 / run.trace.steps


def group_ms(run, group: str) -> Optional[float]:
    """Device ms per step of one kernel group (``trace.GROUPS``)."""
    if run.trace is None:
        return None
    s = run.trace.group_s().get(group, 0.0)
    return s * 1e3 / run.trace.steps if s > 0 else None


def peak_gib(run) -> Optional[float]:
    """``max_memory_allocated`` over the window, GiB."""
    return run.peak_bytes / GIB if run.peak_bytes else None
