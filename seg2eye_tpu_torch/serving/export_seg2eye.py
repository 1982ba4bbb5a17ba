"""Export a trained Seg2Eye checkpoint as a serving artifact (counterpart of
``tools/export_serving.py``).

    python -m seg2eye_tpu_torch.serving.export_seg2eye --name EXP \
        --checkpoints_dir CKPTS [--which_epoch latest] [--out_dir DIR] \
        [--device cuda] [--native_hw 640,400] [--stats running|batch] \
        [--verify]

Restores the run's options from ``opt.pkl`` and strict-loads
``{which_epoch}_net_{G,E}.pth``, as ``python -m seg2eye_tpu_torch.test``
does, then writes a batch-polymorphic artifact (``program.pt2`` +
``meta.json``) that ``seg2eye_tpu_torch.serving.load_serving`` runs with no
model code.  The artifact runs only on the device it was exported on
(``--device``, default cuda; a missing card is an error).

``--jax_artifact DIR`` exports a JAX package's serving artifact instead:
its ``variables.msgpack`` and ``meta.json`` (options, native size) make
the live model; ``--name`` then only names the default output directory
(``DIR/serving_torch``).

``--verify`` reloads the artifact and compares it with the live model on a
seeded batch of 2; exit code 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", default=None,
                    help="the run (required without --jax_artifact)")
    ap.add_argument("--jax_artifact", default=None,
                    help="a JAX package's serving artifact directory to "
                         "export from")
    ap.add_argument("--checkpoints_dir", default="./checkpoints")
    ap.add_argument("--which_epoch", default="latest")
    ap.add_argument("--out_dir", default=None,
                    help="default: <expr_dir>/serving_<which_epoch>")
    ap.add_argument("--device", default="cuda",
                    help="the device the artifact is exported for and runs "
                         "on")
    ap.add_argument("--native_hw", default="640,400",
                    help="native size H,W of the [0,255] output "
                         "(OpenEDS: 640,400)")
    ap.add_argument("--stats", choices=("running", "batch"),
                    default="running",
                    help="batch-norm statistics baked into the program: "
                         "'running' (default), per-sample outputs that do "
                         "not depend on the rest of the batch; 'batch', the "
                         "reference Tester's train-mode statistics")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and compare it with the live "
                         "model on a seeded batch")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
    from seg2eye_tpu_torch.ops.image import to_255resized
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.serving import export_inference, load_serving
    from seg2eye_tpu_torch.serving.from_jax import seg2eye_from_jax_artifact
    from seg2eye_tpu_torch.utils.checkpoint import load_networks

    if args.jax_artifact:
        model, (nh, nw) = seg2eye_from_jax_artifact(args.jax_artifact, device)
        opt = model.opt
        out_dir = args.out_dir or os.path.join(args.jax_artifact,
                                               "serving_torch")
    elif args.name:
        expr_dir = os.path.join(args.checkpoints_dir, args.name)
        opt = Options.load(expr_dir).replace(
            checkpoints_dir=args.checkpoints_dir, name=args.name,
            isTrain=False, eval_use_running_stats=args.stats == "running")
        nets = load_networks(build_networks(opt), opt, args.which_epoch)
        model = Pix2Pix(opt, nets, device)
        out_dir = args.out_dir or os.path.join(expr_dir,
                                               f"serving_{args.which_epoch}")
        nh, nw = (int(v) for v in args.native_hw.split(","))
    else:
        raise SystemExit("--name or --jax_artifact required")
    export_inference(model, out_dir, native_hw=(nh, nw))
    size = sum(os.path.getsize(os.path.join(out_dir, f))
               for f in os.listdir(out_dir))
    print(f"exported serving artifact -> {out_dir} ({size / 1e6:.1f} MB, "
          f"device {device}, batch-polymorphic)")
    if not args.verify:
        return 0

    served = load_serving(out_dir)
    rng = np.random.default_rng(0)
    h, w = opt.image_height, opt.image_width
    label = rng.integers(0, opt.semantic_nc, (2, h, w)).astype(np.uint8)
    style = rng.integers(0, 256, (2, opt.input_ns, h, w, 1)).astype(np.uint8)
    fake_s, f255_s = served(label, style)
    fake = model.inference({"label": label, "style_image": style})
    f255 = to_255resized(fake, w=nw, h=nh)
    diff = float((fake_s - fake).abs().max())
    # the resized [0,255] output: the same shape (H/W orientation
    # included) and at most one truncated-integer step apart
    d255 = (float((f255_s - f255).abs().max())
            if f255_s.shape == f255.shape else float("inf"))
    ok = diff < 1e-4 and d255 <= 1
    print(f"verify: max|artifact - live| = {diff:.2e}, fake_255 "
          f"{tuple(f255_s.shape)} drift {d255:.0f} "
          f"({'OK' if ok else 'MISMATCH'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
