"""The traced slice of a run and what the per-layer readers see.

``profile_slice`` runs one untimed step under ``torch.profiler`` (the
profiler's own start-up), then ``steps`` steps inside the
``portbench.slice`` range, ending synchronised.  ``Slice`` holds the
device activity inside that range (kernels, copies and sets; the device
side of user annotations left out, since it spans kernels counted on their
own) and the CPU ops.  Kernels are grouped by
name as the port's profilers group them (``tools/profile_torch_train.py``).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from portbench.roofline import busy_us

SLICE = "portbench.slice"
K1_OP = "seg2eye::spade_style"
# the port's profiler range around the norm sites' backward recompute
BACKWARD_RANGE = "spade_style backward (plain recompute)"
# idle gaps named in the breakdown, longest first
LONGEST_GAPS = 400

# (group, substrings of the kernel name); the first match wins, so the K1
# kernels come before the cuDNN group, whose "conv" would take them
GROUPS = [
    ("k1", ("spade_style_sm90_kernel", "spade_style_3xtf32_sm90_kernel")),
    ("conv", ("cudnn", "xmma", "cutlass", "fft", "DSE::",
              "pointwise_mult_and_sum", "nchwToNhwc", "nhwcToNchw",
              "implicit_gemm", "conv", "gemm", "dgrad", "wgrad", "sm90_",
              "nvjet")),
    ("copy", ("Memcpy", "Memset")),
    ("optimizer", ("multi_tensor_apply",)),
    ("memory_pass", ("",)),
]


def group_of(name: str) -> str:
    return next(g for g, keys in GROUPS if any(k in name for k in keys))


@dataclass
class Slice:
    """What a metric reader reads of the trace.  Times in seconds."""
    steps: int                        # steps inside the traced slice
    wall_s: float                     # the slice's length
    kernels: List[Tuple[str, float, float]]   # (name, start s, end s)
    ops: List = field(default_factory=list)   # CPU FunctionEvents inside

    @property
    def busy_s(self) -> float:
        return busy_us((s * 1e6, e * 1e6) for _, s, e in self.kernels) / 1e6

    def group_s(self) -> Dict[str, float]:
        out = collections.defaultdict(float)
        for name, s, e in self.kernels:
            out[group_of(name)] += e - s
        return out

    def ops_named(self, name: str) -> List:
        return [e for e in self.ops if e.name == name]


def profile_slice(step, start: int, steps: int, sync) -> Tuple:
    """-> (events, (start us, end us) of the slice); ``step(i)`` runs step
    i, ``sync()`` waits for the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        step(start)
        sync()
        with record_function(SLICE):
            for i in range(steps):
                step(start + 1 + i)
            sync()
    events = prof.events()
    mark = [e for e in events if e.name == SLICE
            and e.device_type == torch.autograd.DeviceType.CPU]
    if len(mark) != 1:
        raise RuntimeError(f"the profiler recorded {len(mark)} slice ranges")
    return events, (mark[0].time_range.start, mark[0].time_range.end)


def make_slice(events, span, steps: int) -> Slice:
    import torch

    lo, hi = span
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels, ops = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda and not getattr(e, "is_user_annotation",
                                                 False):
            s, t = max(start, lo), min(end, hi)
            if t > s:
                kernels.append((e.name, s / 1e6, t / 1e6))
        elif e.device_type == cpu and lo <= start and end <= hi \
                and e.name != SLICE:
            ops.append(e)
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "traced slice")
    return Slice(steps=steps, wall_s=(hi - lo) / 1e6, kernels=kernels,
                 ops=ops)


def breakdown(sl: Slice, top: int = 10) -> Dict:
    """The device ops that took most time, and the longest idle gaps by the
    innermost CPU op running on the launching thread when each began."""
    per = collections.defaultdict(float)
    for name, s, e in sl.kernels:
        per[name] += e - s
    device_ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e) for _, s, e in sl.kernels)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    main = collections.Counter(o.thread for o in sl.ops).most_common(1)
    cpu = [o for o in sl.ops if main and o.thread == main[0][0]]
    starts = np.array([o.time_range.start / 1e6 for o in cpu])
    ends = np.array([o.time_range.end / 1e6 for o in cpu])
    by_host = collections.defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:LONGEST_GAPS]:
        inside = np.flatnonzero((starts <= g0) & (g0 < ends))
        name = "(no op: Python)"
        if inside.size:
            name = cpu[inside[np.argmin(ends[inside] - starts[inside])]].name
        by_host[name] += g1 - g0
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[n, s] for n, s in idle]}
