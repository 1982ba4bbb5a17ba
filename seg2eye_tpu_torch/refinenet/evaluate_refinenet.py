"""Challenge-submission predictions of a trained RefineNet on PyTorch
(counterpart of ``refinenet/evaluate_refinenet.py``; reference:
refinenet/evaluate_refinenet.py:83-128): one ``.npy`` per test image,
clip((pred + 1) * 255/2, 0, 255) as uint8, under
``resume_from/predictions``, listed in ``pred_npy_list.txt``.

    python -m seg2eye_tpu_torch.refinenet.evaluate_refinenet \
        --resume_from OUTPUT_DIR --dataroot ... --distances_and_indices ... \
        --segmentations_generative ... --segmentations_sequence ... \
        [--device cuda]

Refuses to run without a checkpoint under ``resume_from/checkpoints``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from seg2eye_tpu_torch.data.openeds import DataLoader, device_prefetch
from seg2eye_tpu_torch.refinenet.checkpoint_manager import CheckpointManager
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.dataset import RefineNetDataset
from seg2eye_tpu_torch.refinenet.model import RefineNetModel
from seg2eye_tpu_torch.refinenet.training import (MODEL_KEYS, Trainer,
                                                  split_device_flag)


def main(argv=None) -> str:
    device, rest = split_device_flag(argv)
    cfg = RefineNetConfig.from_args(rest)
    assert cfg.resume_from, "--resume_from OUTPUT_DIR required"
    loader = DataLoader(RefineNetDataset(cfg, "test", pick1=True),
                        batch_size=cfg.test_batch_size, prefetch=cfg.prefetch)
    trainer = Trainer(RefineNetModel(cfg, device), cfg, loss_key="eds_loss")
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    step, state = CheckpointManager(cfg.resume_from, cfg.checkpoints_keep_n
                                    ).load_last_checkpoint(state)
    if step is None:                   # never run random weights
        raise SystemExit(
            f"no checkpoint found under '{cfg.resume_from}/checkpoints' — "
            "submission npys from random weights would be garbage; check "
            "--resume_from")
    print(f"loaded checkpoint at step {step}")
    out_dir = os.path.join(cfg.resume_from, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    filepaths = []
    for i, (batch, db) in enumerate(device_prefetch(loader, device,
                                                    MODEL_KEYS)):
        out = trainer.eval_step(state, db)
        # (pred+1)*255/2 as uint8 (evaluate_refinenet.py:104-112)
        preds = np.clip((out["prediction"].cpu().numpy() + 1.0) * 255.0
                        / 2.0, 0, 255).astype(np.uint8)
        for b, fname in enumerate(batch["fname"]):
            path = os.path.join(out_dir, fname + ".npy")
            np.save(path, preds[b, ..., 0])
            filepaths.append(path)
        if i % 10 == 0:
            print(f"batch {i}: {len(filepaths)} files")
    manifest = os.path.join(out_dir, "pred_npy_list.txt")
    with open(manifest, "w") as f:
        f.write(os.linesep.join(filepaths) + os.linesep)
    print(f"Written {len(filepaths)} files. Filepath: {manifest}")
    return manifest


if __name__ == "__main__":
    main()
