#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``seg2eye_tpu_torch``.  Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also end standard error.  Exits non-zero
and prints no result without the CUDA cards the cell asks for, and when
any module of jax, jaxlib, flax, optax or seg2eye_tpu was imported.
Kernel and extension caches live under ``build/portbench_cache/`` in the
checkout; the port builds its CUDA kernels under ``build/seg2eye_kernels/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.benchmark()
    if bench is None:
        print("portbench: no BENCHMARK.json at the checkout's root",
              file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0, bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    print("\n".join(harness.format_checks(result)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
