#!/usr/bin/env python3
"""Where the main path's options spend their time: host-clock ms per
training iteration of the PyTorch port's default model at bs16, crop 256,
on one CUDA card, one option at a time.

    python3 tools/time_torch_options.py [--iters 5] [--dtypes bfloat16]

Configurations, each from the same seeded weights (``init_networks``,
seed 0) and ``chip_smoke.py``'s synthetic batch: the default model;
``norm_E = norm_D = spectralbatch`` with per-sample encoding (on through
'auto'); the same batch sub-norms with one fused (B*k) encoder batch
(``--per_sample_encode off``), which separates the per-sample loop from
the norms; the VGG loss alone (seeded VGG19); and both, as phase 7a of
``chip_smoke.py`` runs them.  Each configuration runs 2 warm-up
iterations of ``train.steps.train_step``, then ``--iters`` timed ones,
each synchronised; prints the median ms/iteration, img/s and the peak
memory per configuration and dtype, and the count of CUDA kernels one
iteration launches (``torch.profiler``, device events).
"""
import argparse
import statistics
import sys
import time

CONFIGS = {
    "default": {},
    "spectralbatch, per-sample encoding": dict(norm_E="spectralbatch",
                                               norm_D="spectralbatch"),
    "spectralbatch, fused encoding": dict(norm_E="spectralbatch",
                                          norm_D="spectralbatch",
                                          per_sample_encode="off"),
    "VGG loss": dict(no_vgg_loss=False, lambda_vgg=10.0),
    "spectralbatch, per-sample encoding, VGG loss": dict(
        norm_E="spectralbatch", norm_D="spectralbatch", no_vgg_loss=False,
        lambda_vgg=10.0),
}


def kernels_per_iteration(state, batch):
    import torch

    from seg2eye_tpu_torch.train import steps

    activity = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[activity]) as prof:
        steps.train_step(state, batch)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_torch_options: no CUDA device")
    sys.path.insert(0, ".")
    from chip_smoke import TRAIN_BATCH, make_train_batch, train_state
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.utils.weights import init_networks

    for name, options in CONFIGS.items():
        opt = Options(batchSize=TRAIN_BATCH, **options).finalize()
        nets = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
        batch = make_train_batch(opt, TRAIN_BATCH)
        for dtype in args.dtypes.split(","):
            state = train_state(opt.replace(compute_dtype=dtype), nets)
            for _ in range(2):
                steps.train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                steps.train_step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            n = kernels_per_iteration(state, batch)
            ms = statistics.median(times)
            print(f"{name}, {dtype}: {ms:.2f} ms/iteration "
                  f"({min(times):.2f}-{max(times):.2f}), "
                  f"{TRAIN_BATCH / ms * 1e3:.2f} img/s, peak {peak:.2f} GiB, "
                  f"{n} CUDA kernels per iteration (median of {args.iters})",
                  flush=True)
            del state
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
