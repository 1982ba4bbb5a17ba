"""Export a trained RefineNet or SegNet checkpoint as a serving artifact
(counterpart of ``tools/export_refinenet_serving.py``).

    python -m seg2eye_tpu_torch.serving.export_refiner --model refinenet \
        --resume_from OUTPUT_DIR [--out_dir DIR] [--device cuda] \
        [--verify] [other RefineNetConfig flags]

Loads the newest checkpoint under ``resume_from/checkpoints`` (refusing to
export random weights) and writes a batch-polymorphic artifact
(``program.pt2`` + ``meta.json``) that
``seg2eye_tpu_torch.serving.load_serving`` runs with no model code, on the
device it was exported on (``--device``, default cuda; a missing card is
an error).

``--jax_artifact DIR`` exports a JAX package's refiner artifact instead
(its ``variables.msgpack`` and ``meta.json``; default output
``DIR/serving_torch``); ``--model`` and the config flags are then taken
from its meta.

``--verify`` reloads the artifact and compares it with the live model's
``eval_step`` on a seeded batch of 2; exit code 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=("refinenet", "segnet"),
                     default="refinenet")
    pre.add_argument("--out_dir", default=None,
                     help="default: <resume_from>/serving_<model>")
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--verify", action="store_true")
    pre.add_argument("--jax_artifact", default=None)
    ns, rest = pre.parse_known_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager
    from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
    from seg2eye_tpu_torch.refinenet.model import RefineNetModel, SegNetModel
    from seg2eye_tpu_torch.refinenet.training import Trainer, TrainState
    from seg2eye_tpu_torch.serving import export_refiner, load_serving
    from seg2eye_tpu_torch.serving.from_jax import refiner_from_jax_artifact

    if ns.jax_artifact:
        model = refiner_from_jax_artifact(ns.jax_artifact, device)
        cfg = model.cfg
        ns.model = "refinenet" if isinstance(model, RefineNetModel) \
            else "segnet"
        trainer = Trainer(model, cfg, loss_key="eds_loss"
                          if ns.model == "refinenet" else "ce_loss")
        state = TrainState(model, None)
        out_dir = ns.out_dir or os.path.join(ns.jax_artifact, "serving_torch")
    else:
        cfg = RefineNetConfig.from_args(rest)
        if not cfg.resume_from:
            raise SystemExit("--resume_from OUTPUT_DIR or --jax_artifact "
                             "DIR required")
        if ns.model == "refinenet":
            trainer = Trainer(RefineNetModel(cfg, device), cfg,
                              loss_key="eds_loss")
        else:
            trainer = Trainer(SegNetModel(cfg, device), cfg,
                              loss_key="ce_loss")
        state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
        step, state = CheckpointManager(cfg.resume_from,
                                        cfg.checkpoints_keep_n
                                        ).load_last_checkpoint(state)
        if step is None:                  # never export random weights
            raise SystemExit(
                f"no checkpoint found under '{cfg.resume_from}/checkpoints': "
                "a serving artifact of random weights would be garbage; "
                "check --resume_from")
        print(f"loaded checkpoint at step {step}")
        out_dir = ns.out_dir or os.path.join(cfg.resume_from,
                                             f"serving_{ns.model}")
    export_refiner(state.model, out_dir)
    size = sum(os.path.getsize(os.path.join(out_dir, f))
               for f in os.listdir(out_dir))
    print(f"exported {ns.model} serving artifact -> {out_dir} "
          f"({size / 1e6:.1f} MB, device {device}, batch-polymorphic)")
    if not ns.verify:
        return 0

    served = load_serving(out_dir)
    rng = np.random.default_rng(0)
    h, w = cfg.input_height, cfg.input_width
    ch = 3 if ns.model == "refinenet" else 1
    x = rng.integers(0, 256, (2, h, w, ch)).astype(np.uint8)
    live = trainer.eval_step(state, {"input": torch.from_numpy(x).to(device)})
    if ns.model == "refinenet":
        pred_s, pred_u8_s = served(x)
        pred = live["prediction"].float()
        diff = float((pred_s - pred).abs().max())
        pred_u8 = torch.clamp((pred + 1.0) * (255.0 / 2.0), 0, 255).to(
            torch.uint8)[..., 0]
        d_u8 = int((pred_u8_s.int() - pred_u8.int()).abs().max())
        ok = diff < 1e-4 and d_u8 <= 1
        print(f"verify: max|artifact - live| = {diff:.2e}, submission-u8 "
              f"drift {d_u8} ({'OK' if ok else 'MISMATCH'})")
    else:
        pred_s = served(x)
        mismatch = int((pred_s != live["prediction"].to(torch.uint8)).sum())
        ok = mismatch == 0
        print(f"verify: class-map mismatches = {mismatch}/{pred_s.numel()} "
              f"({'OK' if ok else 'MISMATCH'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
