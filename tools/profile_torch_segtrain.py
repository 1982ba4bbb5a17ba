#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's segmentation trainer
(``seg2eye_tpu_torch.segtrain``), on one CUDA card.

    python3 tools/profile_torch_segtrain.py [--crops 513] [--modes eval train]
        [--dtypes bfloat16 float32] [--steps 3]

The CLI's pascal defaults as ``chip_smoke.py`` phase 9 runs them
(DeepLabV3+ ResNet-101 os16, 21 classes, batch 4, seeded weights, seeded
normalised batches on the card): ``eval`` is ``SegTrainer.eval_step``
(forward, loss, argmax, confusion matrix), ``train`` is
``SegTrainer.train_step`` with dropout on.  ``--crops`` sets the square
crop (the CLI's 513 by default).  After two warm-up calls,
``torch.profiler`` traces ``--steps`` calls per crop, mode and dtype.

Printed for each: wall ms per call (host clock around the traced calls),
device busy ms per call, the card's idle share, the device time per
kernel group (``profile_torch_refinenet.GROUPS``) and the heaviest
kernels.  The process keeps PyTorch's default TF32 flags.
"""
import argparse
import collections
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import SegData, seg_args, seg_batch, seg_trainer  # noqa: E402
from profile_torch_refinenet import GROUPS, group_of, profile  # noqa: E402
from seg2eye_tpu_torch.refinenet.training import \
    dropout_generator  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crops", nargs="+", type=int, default=[513])
    ap.add_argument("--modes", nargs="+", default=["eval", "train"],
                    choices=["eval", "train"])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_segtrain: no CUDA device")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)                    # the trainer's run/ directory
        try:
            for crop in args.crops:
                data = SegData(4, crop, seed=0)
                for dtype in args.dtypes:
                    t = seg_trainer(seg_args(tmp, "--precision", dtype,
                                             crop_size=crop), data, data)
                    bs = t.args.batch_size
                    x, y = seg_batch(data, 0, bs, t.device)
                    calls = {"eval": lambda: t.eval_step(x, y),
                             "train": lambda: t.train_step(
                                 x, y, t.args.lr,
                                 dropout_generator(t.args, 0, t.device))}
                    for mode in args.modes:
                        wall, busy, per_kernel = profile(calls[mode],
                                                         args.steps)
                        print(f"== segtrain {mode} {dtype}, crop {crop}, "
                              f"batch {bs}: wall {wall / 1e3:.3f} ms/call, "
                              f"device busy {busy / 1e3:.3f} ms/call, idle "
                              f"share {1 - busy / wall:.4f}")
                        groups = collections.defaultdict(float)
                        for kname, (us, _) in per_kernel.items():
                            groups[group_of(kname)] += us
                        for g, _ in GROUPS:
                            print(f"  {groups[g] / args.steps / 1e3:10.3f} "
                                  f"ms  {g}")
                        top = sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1][0])
                        for kname, (us, n) in top[:args.top]:
                            print(f"    {us / args.steps / 1e3:9.3f} ms "
                                  f"{n // args.steps:4d}x  {kname[:110]}")
                        sys.stdout.flush()
                    del t
                    torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)


if __name__ == "__main__":
    main()
