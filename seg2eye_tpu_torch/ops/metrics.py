"""OpenEDS challenge metric (counterpart of ``seg2eye_tpu/ops/metrics.py``).

  * ``openeds_accuracy`` = sqrt(sum((a-b)^2)) / (H*W) per image.
  * ``mse_for_images`` takes [0,255]-range 640x400 NHWC images.
  * ``mse_for_tensors`` takes [-1,1] tensors through the truncating
    ``to_255``; its batch mean is the ``lambda_openeds`` training loss.
  * ``error_statistics`` multiplies the mean by 1471, the test-set size.
"""
from __future__ import annotations

import numpy as np
import torch

from seg2eye_tpu_torch.models.layers import at_least_f32
from seg2eye_tpu_torch.ops.image import to_255

RELATIVE_FACTOR = 1471  # OpenEDS test-set size


def openeds_accuracy(produced: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """Per-image sqrt(SSE)/(H*W) over (B,H,W,C) batches."""
    p = at_least_f32(produced)
    t = at_least_f32(target)
    h, w = p.shape[-3], p.shape[-2]
    sq = (p - t) ** 2
    return torch.sqrt(sq.reshape(sq.shape[0], -1).sum(-1)) / (h * w)


def mse_for_images(produced: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """[0,255]-range NHWC image batches -> per-image OpenEDS error."""
    if produced.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(produced.shape)} vs "
                         f"{tuple(target.shape)}")
    return openeds_accuracy(produced, target)


def mse_for_tensors(produced: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """[-1,1]-range NHWC batches -> per-image OpenEDS error."""
    if produced.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(produced.shape)} vs "
                         f"{tuple(target.shape)}")
    return openeds_accuracy(to_255(produced), to_255(target))


def error_statistics(all_errors, mode: str, dataset_key: str) -> dict:
    """Relative (x1471) error dict."""
    all_errors = np.asarray(all_errors)
    relative = float(np.sum(all_errors) / len(all_errors) * RELATIVE_FACTOR)
    return {f"mse/{dataset_key}/{mode}/relative": relative}
