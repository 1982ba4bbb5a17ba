"""Class-axis head of the segmentation net (counterpart of
``seg2eye_tpu/ops/classhead.py``): argmax and per-pixel cross-entropy over
a trailing class axis (..., C), as the JAX package lays logits out.

The JAX package unrolls both over C to fill the TPU's lanes; here they are
plain torch reductions with the same results: argmax keeps the first
maximal index on ties, and the cross-entropy is logsumexp-stabilised.  An
out-of-range label (255, -1) gives NaN at that pixel, so corrupted labels
fail loudly.  ``F.cross_entropy`` is not used: on CUDA such a label trips a
device-side assert, which kills the process's CUDA context.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sliced_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (...) int32, the first maximal index on ties."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sliced_nll(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, argmax) of (..., C) logits and integer (...) labels; NaN where
    the label is outside 0..C-1."""
    nc = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < nc)
    picked = torch.gather(logits, -1, labels.clamp(0, nc - 1)[..., None])
    nll = torch.logsumexp(logits, dim=-1) - picked[..., 0]
    nll = torch.where(valid, nll, torch.full_like(nll, float("nan")))
    return nll, sliced_argmax(logits)
