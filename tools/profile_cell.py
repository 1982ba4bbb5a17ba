#!/usr/bin/env python3
"""Where the time goes in one cell of the port's benchmark, on the card.

    python3 tools/profile_cell.py --workload <cell> [--seed N] [--steps N]
        [--ops N]

From the root of a checkout.  The cell is built as ``portbench/run.py``
builds it (``harness.find_cell``, ``find_config``, ``load_driver``, then
the driver's ``setup``: its seeded weights, ring and checked steps), and
``--steps`` of its steps (the cell's ``trace_steps`` by default) are traced
as the benchmark traces them (``portbench.trace``).  No window is timed
and nothing is checked: the benchmark measures, this tool says where.

Exits 1 where the slice holds another number of the eval BN-ReLU
kernels (``ops.bn_act``) than of their ``layers.bn_act`` spans: the
profiler lost kernel records.

Printed: the card, its power limit and the cell; wall, device busy and
idle share of the traced steps; device ms per step of each kernel group
(``portbench.trace.group_of``: the groups the per-layer metrics read, so
``conv`` is ``conv_ms.train``); the heaviest device ops and the longest
idle gaps by the host op running as each began (``trace.breakdown``).

``--ops N`` also records input shapes and names the ops behind the device
time: each kernel charged to the op that launched it, the outermost aten
op around that, the autograd node it ran under in the backward
(``VarMeanBackward0``, ...) or "forward", and the outer op's first input
shape.  Printed: the N heaviest (node, op) pairs, then the N heaviest
(node, op, shape) triples, each in ms and launches per step.
"""
import argparse
import collections
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402

BACKWARD_OP = "autograd::engine::evaluate_function"
SEED = 2147483711


def node_of(e):
    """The autograd node an op ran under (its evaluate_function range), or
    'forward'."""
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith(BACKWARD_OP):
            return p.name.split(": ", 1)[-1]
        p = p.cpu_parent
    return "forward"


def op_of(e):
    """The outermost aten op around e, '>' e where they differ
    ('aten::to > aten::copy_'), and its first input shape."""
    outer = e
    while (outer.cpu_parent is not None
           and outer.cpu_parent.name.startswith("aten::")):
        outer = outer.cpu_parent
    name = outer.name if outer is e else f"{outer.name} > {e.name}"
    return name, str(outer.input_shapes[0]) if outer.input_shapes else ""


def op_table(ops, steps):
    """{(node, op, first input shape): [us, launches]} per step, each
    kernel charged to the CPU op the profiler links it to."""
    table = collections.defaultdict(lambda: [0.0, 0])
    for e in ops:
        if not e.kernels:
            continue
        row = table[(node_of(e), *op_of(e))]
        for k in e.kernels:
            row[0] += k.duration / steps
            row[1] += 1
    return table


def print_ops(table, steps, top):
    pairs = collections.defaultdict(lambda: [0.0, 0])
    for (node, op, _), (us, n) in table.items():
        pairs[(node, op)][0] += us
        pairs[(node, op)][1] += n
    print("  the heaviest ops (node, op), ms and kernel launches per step:")
    for (node, op), (us, n) in sorted(pairs.items(),
                                      key=lambda kv: -kv[1][0])[:top]:
        print(f"    {us / 1e3:9.3f} ms {n // steps:5d}x  {node} / {op}")
    print("  the heaviest (node, op, first input shape):")
    for (node, op, shape), (us, n) in sorted(table.items(),
                                             key=lambda kv: -kv[1][0])[:top]:
        print(f"    {us / 1e3:9.3f} ms {n // steps:5d}x  {node} / {op} "
              f"{shape[:70]}")


def profile_with_shapes(driver, steps):
    """``trace.profile_slice`` with input shapes recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=True) as prof:
        driver.step(driver.start)
        driver.sync()
        with record_function(trace.SLICE):
            for i in range(steps):
                driver.step(driver.start + 1 + i)
            driver.sync()
    events = prof.events()
    (mark,) = [e for e in events if e.name == trace.SLICE
               and e.device_type == torch.autograd.DeviceType.CPU]
    return events, (mark.time_range.start, mark.time_range.end)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps traced (default: the cell's trace_steps)")
    ap.add_argument("--ops", type=int, default=0,
                    help="name the N heaviest ops (records input shapes)")
    args = ap.parse_args(argv)
    # the caches of portbench/run.py, in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)

    bench = harness.benchmark()
    cell = harness.find_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"profile_cell: cell {args.workload} needs {cell['chips']} "
              "CUDA card(s)", file=sys.stderr)
        return 2
    cfg = harness.find_config(cell["config"])
    driver = harness.load_driver(cell["driver"])(cell, cfg, args.seed, "cuda")
    driver.setup()
    driver.sync()
    steps = args.steps or int(cell["trace_steps"])
    if args.ops:
        events, span = profile_with_shapes(driver, steps)
    else:
        events, span = trace.profile_slice(driver.step, driver.start, steps,
                                           driver.sync)
    sl = trace.make_slice(events, span, steps)
    del events
    driver.release()
    # each launch of the eval BN-ReLU kernel opens one span: a slice with
    # fewer of its kernels than spans lost kernel records, and their time
    # would be missing from memory_pass
    from seg2eye_tpu_torch.ops.bn_act import KERNEL
    from seg2eye_tpu_torch.utils.spans import BN_ACT

    fused = sum(KERNEL in name for name, _, _ in sl.kernels)
    spans = len(sl.ops_named(BN_ACT))
    if fused != spans:
        print(f"profile_cell: {fused} {KERNEL} kernels profiled, {spans} "
              f"{BN_ACT} spans: the profiler lost kernel records",
              file=sys.stderr)
        return 1

    print(f"== {args.workload} on {harness.card_name('cuda')} "
          f"({harness.power_limit()}), seed {args.seed}, {steps} steps: wall "
          f"{sl.wall_s / steps * 1e3:.3f} ms/step, device busy "
          f"{sl.busy_s / steps * 1e3:.3f} ms/step, idle share "
          f"{1 - sl.busy_s / sl.wall_s:.4f}")
    groups = sl.group_s()
    print("  device ms per step by group (portbench.trace.group_of):")
    for g, _ in trace.GROUPS:
        print(f"  {groups.get(g, 0.0) / steps * 1e3:10.3f}  {g}")
    print(f"  {sum(groups.values()) / steps * 1e3:10.3f}  all kernels")
    bd = trace.breakdown(sl)
    print("  the heaviest device ops, ms per step:")
    for name, s in bd["device_ops"]:
        print(f"    {s / steps * 1e3:9.3f}  {name[:110]}")
    print("  the longest idle gaps by the host op as each began, ms per step:")
    for name, s in bd["idle_gaps"]:
        print(f"    {s / steps * 1e3:9.3f}  {name[:110]}")
    if args.ops:
        print_ops(op_table(sl.ops, steps), steps, args.ops)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
