#!/usr/bin/env python3
"""Where the time goes in one training iteration of the PyTorch port, on
one CUDA card.

    python3 tools/profile_torch_train.py [--batch 16] [--steps 3]
        [--dtypes bfloat16 float32] [--routes kernel plain]

The default model (``Options()``: ngf 64, ndf 64, 320x256 images, k = 4),
seeded random G, E and D and a numpy-seeded batch go through
``train.steps.train_step`` (G step, then the D step with the fake
regenerated).  After two warm-up iterations, ``torch.profiler`` traces
``--steps`` iterations per dtype and route.  Route ``kernel`` is the port as
it runs; route ``plain`` sends every generator norm site through
``spade_style_reference`` instead of the CUDA kernels.

Printed per dtype and route: wall ms/iteration (host clock around the
traced iterations), device busy ms/iteration (the union of the card's
kernel and copy intervals), the card's idle share (1 - busy / wall), the
device time per group, all and launched by the backward (the kernels of
the ops on the autograd engine's thread), the device time of the norm
sites' backward (the kernels launched inside the ``spade_style``
backward's profiler range: in bfloat16 the seg MLP's recompute, the
backward kernel, dgrad and wgrad; in float32 the recompute through the
plain version and its gradient), and the heaviest kernels.  The bf16
kernel group holds the backward kernel (``spade_style_sm90_kernel_bwd``)
beside the forward's.  The process keeps PyTorch's default TF32 flags, as a user's
would: a float32 model turns TF32 off around its own steps.
"""
import argparse
import collections
import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (make_train_batch, plain_norm_sites,  # noqa: E402
                        train_state)
from profile_torch_slice import busy_us  # noqa: E402
from seg2eye_tpu_torch.utils.spans import BACKWARD_RANGE  # noqa: E402
from seg2eye_tpu_torch.options import Options  # noqa: E402
from seg2eye_tpu_torch.train import steps  # noqa: E402
from seg2eye_tpu_torch.utils.weights import init_networks  # noqa: E402

# (group, substrings of the kernel name), first match wins: the two
# spade_style kernels come before the cuDNN group, whose "conv" would
# otherwise take any kernel name that holds it
GROUPS = [
    ("spade_style tensor-core kernel (bf16)", ("spade_style_sm90_kernel",)),
    ("spade_style 3xTF32 tensor-core kernel (f32)",
     ("spade_style_3xtf32_sm90_kernel",)),
    ("cuDNN convs, GEMMs and layout transposes",
     ("cudnn", "xmma", "cutlass", "fft", "DSE::", "pointwise_mult_and_sum",
      "nchwToNhwc", "nhwcToNchw", "implicit_gemm", "conv", "gemm", "dgrad",
      "wgrad")),
    ("Adam (multi-tensor apply)", ("multi_tensor_apply",)),
    ("reductions (BN statistics, norms, losses)", ("reduce_kernel",)),
    ("host->device copies", ("Memcpy HtoD",)),
    ("other elementwise and copies", ("",)),
]
BACKWARD_OP = "autograd::engine::evaluate_function"


def group_of(name):
    return next(g for g, keys in GROUPS if any(k in name for k in keys))


def profile(state, batch, steps_n):
    """-> (wall us, device busy us, {kernel: [us, count]}, {group: us of
    kernels launched by the backward}, us of kernels the profiler links to
    a launching op, us inside the norm sites' backward, its ranges), each
    per iteration."""
    for _ in range(2):
        steps.train_step(state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps_n):
            steps.train_step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu_type = torch.autograd.DeviceType.CPU
    # the device side of record_function ranges (gpu_user_annotation) spans
    # kernels that are counted on their own: leave them out
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    # the backward runs on the autograd engine's thread: the kernels of the
    # ops on that thread, as the profiler links each kernel to its op
    cpu = [e for e in events if e.device_type == cpu_type]
    bwd_threads = {e.thread for e in cpu if e.name.startswith(BACKWARD_OP)}
    backward = collections.defaultdict(float)
    linked = 0.0
    for e in cpu:
        for k in e.kernels:
            linked += k.duration
            if e.thread in bwd_threads:
                backward[group_of(k.name)] += k.duration
    sites = [e for e in cpu if e.name == BACKWARD_RANGE]
    sites_us = sum(e.device_time_total for e in sites)
    return (wall_us / steps_n, busy_us(spans) / steps_n, per_kernel,
            {g: us / steps_n for g, us in backward.items()},
            linked / steps_n, sites_us / steps_n, len(sites) // steps_n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--routes", nargs="+", default=["kernel", "plain"],
                    choices=["kernel", "plain"])
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")

    opt = Options(batchSize=args.batch).finalize()
    nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
    batch = make_train_batch(opt, args.batch)
    for dtype in args.dtypes:
        for name in args.routes:
            state = train_state(opt.replace(compute_dtype=dtype), nets_cpu)
            with (plain_norm_sites() if name == "plain"
                  else contextlib.nullcontext()):
                (wall, busy, per_kernel, backward, linked, sites,
                 n_sites) = profile(state, batch, args.steps)
            del state
            torch.cuda.empty_cache()
            print(f"== {dtype}, {name} route, batch {args.batch}: wall "
                  f"{wall / 1e3:.3f} ms/iteration, device busy "
                  f"{busy / 1e3:.3f} ms/iteration, idle share "
                  f"{1 - busy / wall:.4f}")
            groups = collections.defaultdict(float)
            for kname, (us, _) in per_kernel.items():
                groups[group_of(kname)] += us
            kernels_us = sum(us for us, _ in per_kernel.values()) / args.steps
            print("  ms per iteration: all, launched by the backward (the "
                  "profiler links kernels of "
                  f"{linked / max(kernels_us, 1.0):.3f} of the device time "
                  "to their op)")
            for g, _ in GROUPS:
                print(f"  {groups[g] / args.steps / 1e3:10.3f} "
                      f"{backward.get(g, 0.0) / 1e3:10.3f}  {g}")
            print(f"  {sum(groups.values()) / args.steps / 1e3:10.3f} "
                  f"{sum(backward.values()) / 1e3:10.3f}  all kernels")
            print(f"  {sites / 1e3:10.3f} {sites / 1e3:10.3f}  of these, "
                  f"inside the norm sites' backward ({n_sites} per "
                  "iteration)")
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
            for kname, (us, n) in top[:args.top]:
                print(f"    {us / args.steps / 1e3:9.3f} ms "
                      f"{n // args.steps:4d}x  {kname[:110]}")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
