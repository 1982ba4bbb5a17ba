"""Confusion-matrix evaluator: pixel accuracy, class accuracy, mIoU,
fwIoU (counterpart of ``seg2eye_tpu/segtrain/metrics.py``; reference:
refinenet/deeplab/utils/metrics.py).

  * Rows are the ground truth, columns the prediction; pixels whose label
    is outside [0, num_class) (the 255 ignore index) are dropped.
  * Pixel_Accuracy = trace / sum; Pixel_Accuracy_Class = nanmean of the
    per-class recall; mIoU = nanmean of the IoU; FWIoU sums the
    frequency-weighted IoU over the classes with pixels.

``confusion_matrix`` runs where its inputs are: one ``torch.bincount``
with int64 counts, the dropped pixels sent to an extra bin, so its shape
does not depend on the data.  The evaluator accumulates in float64 on the
host.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor, num_class: int
                     ) -> torch.Tensor:
    """Integer gt and pred of one shape -> (num_class, num_class) int64
    counts (metrics.py:34-39 _generate_matrix)."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_class)
    idx = torch.where(valid, num_class * gt + pred,
                      torch.full_like(gt, num_class * num_class))
    counts = torch.bincount(idx, minlength=num_class * num_class + 1)
    return counts[:num_class * num_class].reshape(num_class, num_class)


class Evaluator:
    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion = np.zeros((num_class, num_class), np.float64)

    def reset(self) -> None:
        self.confusion = np.zeros((self.num_class,) * 2, np.float64)

    def add_batch(self, gt, pred) -> None:
        assert np.shape(gt) == np.shape(pred), (np.shape(gt), np.shape(pred))
        self.add_matrix(confusion_matrix(torch.as_tensor(np.asarray(gt)),
                                         torch.as_tensor(np.asarray(pred)),
                                         self.num_class))

    def add_matrix(self, matrix) -> None:
        """Accumulate a (num_class, num_class) matrix (a tensor on any
        device or an array)."""
        if isinstance(matrix, torch.Tensor):
            matrix = matrix.cpu().numpy()
        self.confusion += np.asarray(matrix, np.float64)

    def pixel_accuracy(self) -> float:
        return float(np.diag(self.confusion).sum() / self.confusion.sum())

    def pixel_accuracy_class(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion) / self.confusion.sum(axis=1)
        return float(np.nanmean(acc))

    def mean_intersection_over_union(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(self.confusion) / (
                self.confusion.sum(axis=1) + self.confusion.sum(axis=0)
                - np.diag(self.confusion))
        return float(np.nanmean(iou))

    def frequency_weighted_intersection_over_union(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            freq = self.confusion.sum(axis=1) / self.confusion.sum()
            iou = np.diag(self.confusion) / (
                self.confusion.sum(axis=1) + self.confusion.sum(axis=0)
                - np.diag(self.confusion))
        return float((freq[freq > 0] * iou[freq > 0]).sum())

    # the reference's method names (metrics.py:9-32)
    Pixel_Accuracy = pixel_accuracy
    Pixel_Accuracy_Class = pixel_accuracy_class
    Mean_Intersection_over_Union = mean_intersection_over_union
    Frequency_Weighted_Intersection_over_Union = \
        frequency_weighted_intersection_over_union
