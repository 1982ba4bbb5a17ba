"""Predict masks for the unlabeled generative/sequence images with a
trained SegNet, on PyTorch (counterpart of ``refinenet/evaluate_segnet.py``;
reference: refinenet/evaluate_segnet.py:107-151): one H5 with a uint8
dataset of stacked masks per split and user, the file the RefineNet
dataset reads.

    python -m seg2eye_tpu_torch.refinenet.evaluate_segnet \
        --resume_from OUTPUT_DIR --dataroot DATA.h5 \
        [--image_key images_gen|images_seq] [--splits ...] [--output H5] \
        [--device cuda]

Refuses to run without a checkpoint under ``resume_from/checkpoints``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from seg2eye_tpu_torch.data.openeds import DataLoader, device_prefetch
from seg2eye_tpu_torch.refinenet.checkpoint_manager import CheckpointManager
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.model import SegNetModel
from seg2eye_tpu_torch.refinenet.segnet_dataset import SegNetEvalDataset
from seg2eye_tpu_torch.refinenet.training import (MODEL_KEYS, Trainer,
                                                  split_device_flag)


def main(argv=None) -> str:
    import h5py

    device, rest = split_device_flag(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--image_key", default="",
                     help="default: the split's style-image source, "
                          "images_gen (train/validation) or images_ss "
                          "(test), the images RefineNetDataset reads masks "
                          "for")
    pre.add_argument("--splits", default="train,validation,test")
    pre.add_argument("--output", default="")
    pre_ns, rest = pre.parse_known_args(rest)
    cfg = RefineNetConfig.from_args(rest)
    assert cfg.resume_from, "--resume_from OUTPUT_DIR required"

    trainer = Trainer(SegNetModel(cfg, device), cfg, loss_key="ce_loss")
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    step, state = CheckpointManager(cfg.resume_from, cfg.checkpoints_keep_n
                                    ).load_last_checkpoint(state)
    if step is None:                   # never run random weights
        raise SystemExit(
            f"no checkpoint found under '{cfg.resume_from}/checkpoints' — "
            "a random-weights mask H5 would silently poison the downstream "
            "ranking/refiner pipeline; check --resume_from")
    print(f"loaded checkpoint at step {step}")

    out_path = pre_ns.output or os.path.join(
        cfg.resume_from,
        "deeplab_predictions_%s.h5" % time.strftime("%y%m%d_%H%M%S"))
    with h5py.File(out_path, "w") as of:
        for split in pre_ns.splits.split(","):
            key = pre_ns.image_key or (
                "images_ss" if split == "test" else "images_gen")
            ds = SegNetEvalDataset(cfg, split, key)
            if len(ds) == 0:
                continue
            loader = DataLoader(ds, batch_size=cfg.test_batch_size,
                                prefetch=cfg.prefetch)
            og = of.create_group(split)
            per_user = {}
            for batch, db in device_prefetch(loader, device, MODEL_KEYS):
                out = trainer.eval_step(state, db)
                preds = out["prediction"].cpu().numpy().astype(np.uint8)
                for b, pid in enumerate(batch["person_id"]):
                    per_user.setdefault(pid, []).append(preds[b])
            for pid, plist in per_user.items():
                og.create_dataset(pid, data=np.asarray(plist))
                print(f"Stored {len(plist)} entries to {split}/{pid}")
            print(f"Wrote split: {split}")
    print("output:", out_path)
    return out_path


if __name__ == "__main__":
    main()
