#!/usr/bin/env python3
"""Host-clock time of the PyTorch port's bs16 scored slice, for the checkout
at TREE (default: this one), on one CUDA card.

    python3 tools/time_torch_slice.py [--tree TREE] [--repeats 30]

To compare two commits on one card, unpack the other one into a directory
that .gitignore lists (``git archive REV | tar -x -C build/parent``) and
run, in one command, parent, this tree, this tree, parent.  The default
model, seeded random weights and ``chip_smoke.py``'s batch of TREE go
through ``Tester.score_batch`` (3 warm-up batches, then ``--repeats``
timed, each ending synchronised when the scores reach the host), in
bfloat16 and float32.  Both TF32 flags are set off for the process, as the
port's float32 forward sets them itself and older trees' ``chip_smoke.py``
did, so that float32 means the same on both sides.  Prints one line per
tree: the median, min and max ms/batch per dtype.
"""
import argparse
import os
import statistics
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=30)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_slice: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    import seg2eye_tpu_torch
    from chip_smoke import make_batch
    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    if not seg2eye_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {seg2eye_tpu_torch.__file__}, not the "
                         f"package of {tree}")
    opt = Options(isTrain=False).finalize()
    nets = init_networks(opt, torch.Generator().manual_seed(0), "cuda")
    batch = make_batch(opt, args.batch)
    line = [tree]
    for dtype in ("bfloat16", "float32"):
        model = Pix2Pix(opt.replace(compute_dtype=dtype), nets, "cuda")
        tester = Tester(model.opt)
        for _ in range(3):
            tester.score_batch(model, batch, need_fake=False)
        ms = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            tester.score_batch(model, batch, need_fake=False)
            ms.append((time.perf_counter() - t0) * 1e3)
        line.append(f"{dtype} bs{args.batch}: median "
                    f"{statistics.median(ms):.2f} ms/batch (min "
                    f"{min(ms):.2f}, max {max(ms):.2f}, {args.repeats} "
                    "batches)")
    print(" | ".join(line), flush=True)


if __name__ == "__main__":
    main()
