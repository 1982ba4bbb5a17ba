"""Class-balanced loss weights from the label histogram (a copy of
``seg2eye_tpu/segtrain/weights.py``; reference: refinenet/deeplab/utils/
calculate_weights.py:6-29): one pass over a loader counting the valid
pixels of each class, then weight_c = 1 / ln(1.02 + freq_c / total),
cached as <db_root>/<dataset>_classes_weights.npy.
"""
from __future__ import annotations

import os

import numpy as np


def calculate_weights_labels(db_root: str, dataset: str, dataloader,
                             num_classes: int, save: bool = True
                             ) -> np.ndarray:
    """``dataloader`` covers the whole dataset (the reference's
    semantics).  The cache is written to a temporary name and renamed, so
    a reader never sees a partial file; ``save=False`` writes none (the
    ranks but 0 under data parallelism)."""
    z = np.zeros((num_classes,), np.float64)
    print("Calculating classes weights")
    for sample in dataloader:
        y = np.asarray(sample["label"])
        mask = (y >= 0) & (y < num_classes)
        z += np.bincount(y[mask].astype(np.int64), minlength=num_classes)
    total_frequency = z.sum()
    class_weights = 1.0 / np.log(1.02 + z / total_frequency)
    ret = class_weights.astype(np.float64)
    if save:
        os.makedirs(db_root, exist_ok=True)
        path = os.path.join(db_root, dataset + "_classes_weights.npy")
        tmp = path + ".tmp.npy"          # .npy suffix: np.save appends none
        np.save(tmp, ret)
        os.replace(tmp, path)
    return ret
