"""Serving-artifact benchmark of the PyTorch port: the exported program
against the live model (counterpart of ``tools/bench_serving_artifact.py``).

Exports the default Seg2Eye model at full width (seeded weights, running
statistics) with ``seg2eye_tpu_torch.serving.export_inference``, reloads
it with ``load_serving`` (no model code), and times artifact and live
``Pix2Pix.inference`` in turns at each batch size: CUDA events around each
call, medians.

    python3 tools/bench_torch_serving.py [--batches 1 16 32] \
        [--dtype bfloat16|float32] [--iters 20] [--out_dir DIR]

Prints one JSON line: the card (``nvidia-smi`` name and power limit),
the dtype, the artifact's size, export and load seconds, and per batch
``artifact_ms``, ``live_ms`` (ms/batch), their img/s and the largest
|artifact - live| of the fake.  ``export_module_ms`` times, in the same
turns, the program as ``torch.export.export`` gives it, run as its
``.module()``: before the exporter drops its per-``.to`` metadata checks
and no-op ``.to``s, and ``ServingModel`` passes the weights to the graph
itself; what those steps save the host.  ``--device cpu --tiny`` runs
the same path on the CPU at a tiny configuration, to check the script;
its times are the host's, not a card's.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def timed_turns(fns, device, iters, warmup=3):
    """Median ms of each no-argument function, called in turns: CUDA
    events on the card, the host clock (synchronised) elsewhere."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, acc in zip(fns, times):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                acc.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                acc.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times]


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 32])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out_dir", default=None,
                    help="artifact directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny configuration, to check the script")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.serving import export, export_inference, \
        load_serving
    from seg2eye_tpu_torch.utils.precision import full_float32
    from seg2eye_tpu_torch.utils.weights import init_networks

    tiny = dict(ngf=4, crop_size=32, aspect_ratio=1.0, w_dim=8,
                input_ns=2) if args.tiny else {}
    opt = Options(isTrain=False, eval_use_running_stats=True,
                  compute_dtype=args.dtype, **tiny).finalize()
    nets = init_networks(opt, torch.Generator().manual_seed(0), device)
    model = Pix2Pix(opt, nets, device)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out_dir or tmp
        t0 = time.perf_counter()
        export_inference(model, out_dir)
        export_s = time.perf_counter() - t0
        size_mb = sum(os.path.getsize(os.path.join(out_dir, f))
                      for f in os.listdir(out_dir)) / 1e6
        t0 = time.perf_counter()
        served = load_serving(out_dir, device=str(device))
        load_s = time.perf_counter() - t0
        h, w = opt.image_height, opt.image_width
        example = (torch.zeros((2, h, w), dtype=torch.uint8, device=device),
                   torch.zeros((2, opt.input_ns, h, w, 1), dtype=torch.uint8,
                               device=device))
        with torch.no_grad():
            raw = torch.export.export(
                export._Seg2EyeProgram(model, 640, 400), example,
                dynamic_shapes=({0: export._batch_dim()},) * 2,
                strict=False).module()

        def export_module(label, style):
            with torch.no_grad(), full_float32(args.dtype == "float32"):
                return raw(label, style)

        rng = np.random.default_rng(0)
        rows = []
        for bs in args.batches:
            label = torch.from_numpy(rng.integers(
                0, opt.semantic_nc, (bs, h, w)).astype(np.uint8)).to(device)
            style = torch.from_numpy(rng.integers(
                0, 256, (bs, opt.input_ns, h, w, 1)).astype(
                    np.uint8)).to(device)
            batch = {"label": label, "style_image": style}
            t_art, t_live, t_raw = timed_turns(
                [lambda: served(label, style),
                 lambda: model.inference(batch),
                 lambda: export_module(label, style)], device, args.iters)
            diff = float((served(label, style)[0]
                          - model.inference(batch)).abs().max())
            rows.append({"bs": bs, "artifact_ms": t_art, "live_ms": t_live,
                         "export_module_ms": t_raw,
                         "artifact_img_s": bs / t_art * 1e3,
                         "live_img_s": bs / t_live * 1e3,
                         "max_abs_diff": diff})
            print(rows[-1], file=sys.stderr)
    result = {"device": str(device), "card": card(device),
              "dtype": args.dtype, "artifact_mb": size_mb,
              "export_s": export_s, "load_s": load_s, "rows": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
