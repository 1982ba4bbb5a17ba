"""Segmentation label <-> color maps (a copy of
``seg2eye_tpu/segtrain/colormap.py``; reference: refinenet/deeplab/
dataloaders/utils.py).

  * pascal and coco share the 21-entry VOC palette, cityscapes has its own
    19 entries.
  * ``decode_segmap`` gives float RGB in [0, 1]; labels outside
    [0, n_classes), such as the 255 ignore index, are black.
  * ``encode_segmap`` maps a VOC-palette RGB image back to class indices;
    colors off the palette map to 0.
"""
from __future__ import annotations

import numpy as np

PASCAL_LABELS = np.asarray(
    [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
     [0, 0, 128], [128, 0, 128], [0, 128, 128], [128, 128, 128],
     [64, 0, 0], [192, 0, 0], [64, 128, 0], [192, 128, 0],
     [64, 0, 128], [192, 0, 128], [64, 128, 128], [192, 128, 128],
     [0, 64, 0], [128, 64, 0], [0, 192, 0], [128, 192, 0],
     [0, 64, 128]], dtype=np.uint8)

CITYSCAPES_LABELS = np.asarray(
    [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
     [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
     [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
     [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
     [0, 0, 230], [119, 11, 32]], dtype=np.uint8)


def get_labels(dataset: str) -> np.ndarray:
    if dataset in ("pascal", "coco", "sbd"):
        return PASCAL_LABELS
    if dataset == "cityscapes":
        return CITYSCAPES_LABELS
    raise NotImplementedError(f"no palette for dataset '{dataset}'")


def decode_segmap(label_mask: np.ndarray, dataset: str = "pascal"
                  ) -> np.ndarray:
    """(..., H, W) int labels -> (..., H, W, 3) float RGB in [0, 1]."""
    colors = get_labels(dataset)
    lab = np.asarray(label_mask).astype(np.int64)
    valid = (lab >= 0) & (lab < len(colors))
    rgb = colors[np.where(valid, lab, 0)].astype(np.float32) / 255.0
    return rgb * valid[..., None]


def decode_seg_map_batch(label_masks: np.ndarray, dataset: str = "pascal"
                         ) -> np.ndarray:
    """(N, H, W) -> (N, H, W, 3)."""
    return decode_segmap(label_masks, dataset)


def encode_segmap(mask: np.ndarray) -> np.ndarray:
    """(H, W, 3) VOC-palette RGB -> (H, W) int class map."""
    mask = np.asarray(mask).astype(np.int64)
    eq = (mask[..., None, :] == PASCAL_LABELS[None, None]).all(-1)
    hit = eq.any(-1)
    return np.where(hit, eq.argmax(-1), 0).astype(np.int64)
