"""Readers of the program's phase spans in a traced slice.

The port opens named ``torch.profiler`` ranges at the boundaries of its
timed paths while a profiler records (``seg2eye_tpu_torch/utils/spans.py``);
the names below are copies of the program's, as ``trace.BACKWARD_RANGE``
is, so that the benchmark imports nothing of the port to read them.  A
program without a span (an older checkout) gives the readers nothing to
read: they return None.  A counter reads 0 where the slice holds the
program's other spans but none of its own: the program has spans and
recorded no such event.

A span's device time is the device time of every CPU op that starts
inside the span's host interval, on any thread: on a card the backward's
kernels are launched from the autograd engine's device thread, not from
the thread that holds the ``train.backward`` span, so the span's own
``device_time_total`` would read about 0 there.  Each op counts its own
kernels and copies (``self_device_time_total``), so nested ops count
once.  The profiler hangs an op's kernels on every event that shares the
op's id: under a full launch queue CUPTI records "Command Buffer Full"
events inside the launching op with its id (on an H100 they carried
5.5-8.3 ms of RefineNet f32 training's 181 ms a step twice).  So each
id's device time counts once, held by its first event.  The host interval is
the outermost span of the name: spans of the name that overlap (nested,
or on two threads) are merged first.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

FORWARD = "train.forward"
BACKWARD = "train.backward"
OPTIMIZER = "train.optimizer"
TO_DEVICE = "input.to_device"
K1_PACK = "seg2eye.k1_pack"
# no reader here: the G and D updates (read in ``--profile_steps``' chrome
# trace), and the inference paths whole (``trace.breakdown`` names the idle
# gaps inside them); all mark a slice that holds the program's spans
G_STEP = "seg2eye.g_step"
D_STEP = "seg2eye.d_step"
REFINENET_SERVE = "refinenet.serve"
SCORE = "seg2eye.score"

NAMES = (G_STEP, D_STEP, FORWARD, BACKWARD, OPTIMIZER, REFINENET_SERVE,
         SCORE, TO_DEVICE, K1_PACK)


def host_intervals(ops, name: str) -> List[Tuple[float, float]]:
    """(start us, end us) of the outermost spans named ``name``, in order:
    overlapping spans of the name merged into one."""
    merged: List[List[float]] = []
    for s, e in sorted((o.time_range.start, o.time_range.end)
                       for o in ops if o.name == name):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def holders(ops) -> List:
    """The ops that hold device time, one per profiler id (its first)."""
    seen, out = set(), []
    for o in sorted(ops, key=lambda o: o.time_range.start):
        if o.self_device_time_total and o.id not in seen:
            seen.add(o.id)
            out.append(o)
    return out


def device_us(ops, name: str) -> Optional[float]:
    """Device us of every op that starts inside a span named ``name``, or
    None where no such span was recorded."""
    spans = host_intervals(ops, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for o in holders(ops):
        t = o.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            total += o.self_device_time_total
    return total


def span_ms(run, name: str) -> Optional[float]:
    """Device ms per step of the slice inside the spans named ``name``."""
    if run.trace is None:
        return None
    us = device_us(run.trace.ops, name)
    return None if us is None else us / 1e3 / run.trace.steps


def span_count(run, name: str) -> Optional[float]:
    """Spans named ``name`` per step of the slice (a counter the program
    records as one span per event): 0 where the slice holds other program
    spans only, None where it holds none."""
    if run.trace is None:
        return None
    n = sum(1 for o in run.trace.ops if o.name == name)
    if not n and not any(o.name in NAMES for o in run.trace.ops):
        return None
    return n / run.trace.steps
