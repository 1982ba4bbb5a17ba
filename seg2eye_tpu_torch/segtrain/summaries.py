"""Tensorboard image panels of the segmentation trainer (counterpart of
``seg2eye_tpu/segtrain/summaries.py``; reference: refinenet/deeplab/
utils/summaries.py).

``visualize_image`` logs three grids of the first three samples at each
call: the input images (min-max normalised together), the decoded argmax
predictions and the decoded ground truth.  Images and labels come from
the host batch (NHWC, as the loader gives them), the logits from the net
(NCHW, on any device); the writer gets CHW arrays, the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from seg2eye_tpu_torch.refinenet.loggers import Tensorboard
from seg2eye_tpu_torch.segtrain.colormap import decode_seg_map_batch


def _grid(images_nhwc: np.ndarray, normalize: bool = False) -> np.ndarray:
    """The first <= 3 images side by side -> (C, H, W n); min-max
    normalised together when ``normalize`` (torchvision make_grid)."""
    imgs = np.asarray(images_nhwc[:3], np.float32)
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-5)
    row = np.concatenate(list(imgs), axis=1)        # (H, W n, C)
    return np.clip(row, 0.0, 1.0).transpose(2, 0, 1)


class TensorboardSummary:
    def __init__(self, directory: str):
        self.directory = directory

    def create_summary(self) -> Tensorboard:
        return Tensorboard(self.directory)

    def visualize_image(self, writer: Tensorboard, dataset: str,
                        image: np.ndarray, target: np.ndarray,
                        output: torch.Tensor, global_step: int) -> None:
        """image (N,H,W,3) normalised, target (N,H,W) labels, output
        (N,C,H,W) logits."""
        writer.update_current_step(global_step)
        writer.add_image("Image", _grid(np.asarray(image), normalize=True))
        pred = torch.argmax(output[:3], dim=1).cpu().numpy()
        writer.add_image("Predicted label",
                         _grid(decode_seg_map_batch(pred, dataset)))
        gt = decode_seg_map_batch(np.asarray(target)[:3], dataset)
        writer.add_image("Groundtruth label", _grid(gt))
