#!/usr/bin/env python3
"""Readings that the limits of the check are set from, for one cell, in
one process: for each seed, the program's numbers against the reference
(a short window at the cell's load fills a serving cell's sample) and the
control's (the reference with the products of the precision below the
cell's, ``driver.CONTROL``) against the same reference.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--seconds 2] \
        [--out FILE]

With ``--fault-seeds``, the program runs again on those seeds with each
fault of ``faults.FAULTS`` planted.  One JSON line per seed and side on
standard output (and appended to ``--out``): {"seed", "side": "program" |
"control" | "fault:<name>", <number>: value, ...}.  Needs the cell's CUDA
card; not run by the benchmark's runs.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def worst(d, prog, ref) -> dict:
    """The leaves behind a training cell's worst gaps, for reading."""
    if not d.training:
        return {}
    from portbench.driver import kept_leaves, leaf_gaps

    import statistics

    leaves = kept_leaves(ref["grad1"])
    out = {}
    for key in ("grad1", "change"):
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        out[f"worst_{key}"] = sorted(gaps, key=gaps.get)[-3:]
        out[f"median_{key}_gap"] = statistics.median(gaps.values())
    out["losses"] = [prog["losses"], ref["losses"]]
    out["left_out"] = sorted(set(ref["grad1"]) - set(leaves))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.driver import CONTROL
    from portbench.faults import FAULTS, plant

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload, harness.benchmark())
    cfg = harness.find_config(cell["config"])
    Driver = harness.load_driver(cell["driver"])
    def program(seed):
        d = Driver(cell, cfg, seed, "cuda")
        d.setup()
        harness.window(d, args.seconds)
        d.release()
        gc.collect()
        torch.cuda.empty_cache()
        return d

    seeds = set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)
    for seed in sorted(seeds):
        t0 = time.perf_counter()
        d = Driver(cell, cfg, seed, "cuda")
        lines = []
        ref = None
        if seed in args.seeds:
            d = program(seed)
            ref = d.reference_readings("f32")
            lines.append({"side": "program", **d.compare(d.readings(), ref),
                          **worst(d, d.readings(), ref)})
        if seed in args.control_seeds:
            if ref is None:
                d.make_ring()
                if not d.training:
                    d.reservoir_from_slots(range(int(cell["sample"])))
                ref = d.reference_readings("f32")
            control = d.reference_readings(CONTROL[cell["dtype"]])
            lines.append({"side": "control", **d.compare(control, ref),
                          **worst(d, control, ref)})
        for fault in FAULTS[cell["driver"]] if seed in args.fault_seeds \
                else ():
            with plant(cell["driver"], fault):
                f = program(seed)
            if ref is None or not d.training:
                ref = f.reference_readings("f32")
            lines.append({"side": f"fault:{fault}",
                          **f.compare(f.readings(), ref)})
            del f
        for line in lines:
            text = json.dumps({"cell": args.workload, "seed": seed, **line,
                               "s": time.perf_counter() - t0})
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
        del d, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
