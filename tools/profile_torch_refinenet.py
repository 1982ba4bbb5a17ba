#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's RefineNet system, on one CUDA
card.

    python3 tools/profile_torch_refinenet.py [--models RefineNet SegNet]
        [--backbone resnet|xception|drn|mobilenet] [--modes serve train]
        [--dtypes bfloat16 float32] [--steps 3]

The full-width configurations of ``refinenet/configs/{segnet,refinenet}.json``
(DeepLabV3+, ResNet-101 unless ``--backbone`` says otherwise, os16 (DRN:
8), 640x400), seeded weights and seeded uint8
batches on the card, as ``chip_smoke.py`` phase 6 runs them: ``serve`` is
``Trainer.eval_step`` at batch 32 (SegNet without a target), ``train`` is
``Trainer.train_step`` at the config's batch (8), dropout on.  After two
warm-up calls, ``torch.profiler`` traces ``--steps`` calls per model, mode
and dtype.

Printed for each: wall ms per call (host clock around the traced calls),
device busy ms per call (the union of the card's kernel and copy
intervals), the card's idle share (1 - busy / wall), the device time per
kernel group and the heaviest kernels.  The process keeps PyTorch's
default TF32 flags: a float32 model turns TF32 off around its own steps.
"""
import argparse
import collections
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (DTYPES, RN_SERVE_BATCH, rn_batch,  # noqa: E402
                        rn_config, rn_model, rn_trainer)
from profile_torch_slice import busy_us  # noqa: E402
from seg2eye_tpu_torch.refinenet.training import \
    dropout_generator  # noqa: E402

# (group, substrings of the kernel name), first match wins
GROUPS = [
    ("depthwise convs", ("depthwise", "c1_k1")),
    ("batch norm (statistics, transform, backward)", ("batch_norm", "bn_")),
    ("convs, GEMMs and layout transposes",
     ("cudnn", "xmma", "cutlass", "fft", "DSE::", "nchwToNhwc", "nhwcToNchw",
      "implicit_gemm", "implicit_convolve", "conv", "gemm", "dgrad",
      "wgrad", "nvjet")),
    ("ReLU (clamp, threshold backward)", ("clamp_scalar", "threshold")),
    ("gathers and scatters (the align_corners resize)",
     ("index", "gather", "scatter")),
    ("SGD (multi-tensor apply)", ("multi_tensor_apply",)),
    ("reductions (losses, clip norm, pool mean)", ("reduce_kernel",)),
    ("host->device copies", ("Memcpy HtoD",)),
    ("other elementwise and copies", ("",)),
]


def group_of(name):
    return next(g for g, keys in GROUPS if any(k in name for k in keys))


def profile(call, steps):
    """-> (wall us, device busy us, {kernel: [us, count]}) per call."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    return wall_us / steps, busy_us(spans) / steps, per_kernel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=["RefineNet", "SegNet"],
                    choices=["RefineNet", "SegNet"])
    ap.add_argument("--backbone", default="resnet",
                    choices=["resnet", "xception", "drn", "mobilenet"])
    ap.add_argument("--modes", nargs="+", default=["serve", "train"],
                    choices=["serve", "train"])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_refinenet: no CUDA device")

    for name in args.models:
        cfg = rn_config(name, backbone=args.backbone)
        model = rn_model(name, cfg, "cuda")
        trainer = rn_trainer(name, model)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        serve = rn_batch(name, cfg, RN_SERVE_BATCH, seed=1)
        if name == "SegNet":
            del serve["target"]
        train = rn_batch(name, cfg, cfg.batch_size, seed=2)
        calls = {"serve": (RN_SERVE_BATCH,
                           lambda: trainer.eval_step(state, serve)),
                 "train": (cfg.batch_size, lambda: trainer.train_step(
                     state, train, cfg.learning_rate,
                     dropout_generator(cfg, state.step, "cuda")))}
        for mode in args.modes:
            batch, call = calls[mode]
            for dtype in args.dtypes:
                model.dtype = DTYPES[dtype]
                wall, busy, per_kernel = profile(call, args.steps)
                print(f"== {name} ({args.backbone}) {mode} {dtype}, batch "
                      f"{batch}: wall "
                      f"{wall / 1e3:.3f} ms/call, device busy "
                      f"{busy / 1e3:.3f} ms/call, idle share "
                      f"{1 - busy / wall:.4f}")
                groups = collections.defaultdict(float)
                for kname, (us, _) in per_kernel.items():
                    groups[group_of(kname)] += us
                for g, _ in GROUPS:
                    print(f"  {groups[g] / args.steps / 1e3:10.3f} ms  {g}")
                top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
                for kname, (us, n) in top[:args.top]:
                    print(f"    {us / args.steps / 1e3:9.3f} ms "
                          f"{n // args.steps:4d}x  {kname[:110]}")
                sys.stdout.flush()
        del model, trainer, state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
