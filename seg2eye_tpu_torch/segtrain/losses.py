"""Segmentation losses on NCHW logits (counterpart of
``seg2eye_tpu/segtrain/losses.py``; reference: refinenet/deeplab/utils/
loss.py).

  * CE is ``nn.CrossEntropyLoss(weight, ignore_index=255)``: the per-pixel
    NLL weighted by the target class's weight, summed over the valid
    pixels and divided by the sum of their weights, then divided again by
    the batch when ``batch_average``.
  * Focal transforms the already-aggregated scalar CE (a quirk of the
    reference, not per pixel): logpt = -ce, pt = e^logpt, logpt *= alpha,
    loss = -(1 - pt)^gamma logpt, / n.
  * A pixel is valid where its label t has t != 255 and 0 <= t < C, as in
    the JAX package: every other label is dropped.  ``F.cross_entropy``
    is not used: on CUDA a label in [C, 255) trips a device-side assert,
    which kills the process's CUDA context.  The loss is computed in at
    least float32: bfloat16 logits are widened, float64 ones kept (the
    JAX package casts to float32 also in a float64 run; the port's float64
    runs, which check it card against CPU, stay float64 throughout).

Both normalise by counts of the whole batch (its valid pixels' weights,
its size), so under data parallelism every rank computes the loss of the
global batch: the sums and counts of all ranks (``parallel.data_parallel.
global_sum``), over the global batch size.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from seg2eye_tpu_torch.models.layers import at_least_f32
from seg2eye_tpu_torch.parallel import data_parallel as dp


class SegmentationLosses:
    def __init__(self, weight=None, size_average: bool = True,
                 batch_average: bool = True, ignore_index: int = 255):
        self.ignore_index = ignore_index
        self.weight = None if weight is None else torch.as_tensor(
            weight, dtype=torch.float32)
        self.size_average = size_average
        self.batch_average = batch_average

    def build_loss(self, mode: str = "ce") -> Callable:
        """'ce' or 'focal' (loss.py:12-19)."""
        if mode == "ce":
            return self.cross_entropy
        if mode == "focal":
            return self.focal
        raise NotImplementedError(mode)

    def _aggregate_ce(self, logit: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
        """The CrossEntropyLoss scalar of (N,C,H,W) logits and (N,H,W)
        labels, before the batch_average division."""
        nc = logit.shape[1]
        t = target.long()
        valid = (t != self.ignore_index) & (t >= 0) & (t < nc)
        tc = t.clamp(0, nc - 1)
        logp = torch.log_softmax(at_least_f32(logit), dim=1)
        nll = -torch.gather(logp, 1, tc[:, None])[:, 0]
        w = valid.to(logp.dtype)
        if self.weight is not None:
            w = self.weight.to(logp.device, logp.dtype)[tc] * w
        total = dp.global_sum(torch.sum(nll * w))
        if self.size_average:
            return total / torch.clamp(dp.global_sum(torch.sum(w)),
                                       min=1e-12)
        return total

    def cross_entropy(self, logit: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
        loss = self._aggregate_ce(logit, target)
        if self.batch_average:
            loss = loss / _batch(logit)
        return loss

    def focal(self, logit: torch.Tensor, target: torch.Tensor,
              gamma: float = 2.0, alpha: Optional[float] = 0.5
              ) -> torch.Tensor:
        logpt = -self._aggregate_ce(logit, target)
        pt = torch.exp(logpt)
        if alpha is not None:
            logpt = logpt * alpha
        loss = -((1 - pt) ** gamma) * logpt
        if self.batch_average:
            loss = loss / _batch(logit)
        return loss


def _batch(logit: torch.Tensor) -> int:
    """The size of the global batch of which ``logit`` holds this rank's
    share."""
    return logit.shape[0] * dp.world_size()
