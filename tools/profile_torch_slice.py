#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's scored inference, on one CUDA
card.

    python3 tools/profile_torch_slice.py [--batch 16] [--steps 3]
        [--dtypes bfloat16 float32] [--routes kernel plain]

The default model (``Options()``: ngf 64, 320x256 images, k = 4), seeded
random weights and a numpy-seeded batch go through ``Tester.score_batch``
(encode, generate, resize to 640x400, per-image error).  After two
warm-up batches, ``torch.profiler`` traces ``--steps`` batches per dtype
and route.  Route ``kernel`` is the port as it runs; route ``plain`` sends
every generator norm site through ``spade_style_reference`` instead of the
CUDA kernel, everything else unchanged.

Printed per dtype and route: wall ms/batch (host clock around the traced
batches), device busy ms/batch (the union of the card's kernel and copy
intervals), the card's idle share (1 - busy / wall), then the device time
per group and the heaviest kernels.  TF32 is off, as in ``chip_smoke.py``.
"""
import argparse
import collections
import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import make_batch, plain_norm_sites  # noqa: E402
from seg2eye_tpu_torch.eval.tester import Tester  # noqa: E402
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix  # noqa: E402
from seg2eye_tpu_torch.options import Options  # noqa: E402
from seg2eye_tpu_torch.utils.weights import init_networks  # noqa: E402

# (group, substrings of the kernel name), first match wins
GROUPS = [
    ("spade_style kernel", ("spade_style_kernel",)),
    ("cuDNN convs and layout transposes",
     ("cudnn", "xmma", "cutlass", "fft", "DSE::", "pointwise_mult_and_sum",
      "nchwToNhwc", "nhwcToNchw", "implicit_gemm", "conv")),
    ("reductions (BN statistics, aggregation, metric)", ("reduce_kernel",)),
    ("host->device copies", ("Memcpy HtoD",)),
    ("other elementwise and copies", ("",)),
]


def group_of(name):
    return next(g for g, keys in GROUPS if any(k in name for k in keys))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(model, batch, steps):
    tester = Tester(model.opt)
    for _ in range(2):
        tester.score_batch(model, batch, need_fake=False)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tester.score_batch(model, batch, need_fake=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    return wall_us / steps, busy_us(spans) / steps, per_kernel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--routes", nargs="+", default=["kernel", "plain"],
                    choices=["kernel", "plain"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    opt = Options(isTrain=False).finalize()
    nets = init_networks(opt, torch.Generator().manual_seed(0), "cuda")
    batch = make_batch(opt, args.batch)
    for dtype in args.dtypes:
        model = Pix2Pix(opt.replace(compute_dtype=dtype), nets, "cuda")
        for name in args.routes:
            with (plain_norm_sites() if name == "plain"
                  else contextlib.nullcontext()):
                wall, busy, per_kernel = profile(model, batch, args.steps)
            print(f"== {dtype}, {name} route, batch {args.batch}: wall "
                  f"{wall / 1e3:.3f} ms/batch, device busy {busy / 1e3:.3f} "
                  f"ms/batch, idle share {1 - busy / wall:.4f}")
            groups = collections.defaultdict(float)
            for kname, (us, _) in per_kernel.items():
                groups[group_of(kname)] += us
            for g, _ in GROUPS:
                print(f"  {groups[g] / args.steps / 1e3:10.3f} ms  {g}")
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
            for kname, (us, n) in top[:args.top]:
                print(f"    {us / args.steps / 1e3:9.3f} ms {n // args.steps:4d}x"
                      f"  {kname[:110]}")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
