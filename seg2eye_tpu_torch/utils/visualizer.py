"""Console, file and TensorBoard logging (counterpart of
``seg2eye_tpu/utils/visualizer.py``).

  * ``print_current_errors`` prints one line per report and appends it to
    ``expr_dir/loss_log.txt`` under a dated header.
  * ``--tf_log``: a ``tensorboardX.SummaryWriter`` under
    ``checkpoints_dir/name/logs`` takes the scalars of
    ``plot_current_errors`` and the images of ``display_current_results``.
  * ``visualize_sidebyside`` builds one (style grid | mask | target | fake
    | error heat map) panel per sample over a text footer, as the JAX
    package's (reference util/visualizer.py:131-186); the error-log H5
    stores them.  ``_to_img01`` and ``_text_strip`` also build the
    RefineNet trainer's prediction strips.

cv2 (resize, text, pupil marker) and tensorboardX are imported inside the
functions that use them; without cv2 panels keep their size, the footer
stays blank and no marker is drawn, as in the JAX package.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _to_img01(x: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,255] or class ids -> a [0,1] grayscale HW array."""
    x = np.asarray(x, np.float32)
    x = np.squeeze(x)
    if x.max() <= 1.0 + 1e-6 and x.min() >= -1.0 - 1e-6:
        return (x + 1.0) / 2.0
    if x.max() < 4:          # label map (postprocessor.py:64-66)
        return x / 3.0
    return x / 255.0


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None or img.shape == (h, w):
        return img
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def _text_strip(text: str, w: int, h: int = 60) -> np.ndarray:
    """A (h, w) [0,1] footer with ``text`` drawn by cv2.putText
    (util/image_annotate.py); blank without cv2."""
    strip = np.zeros((h, w), np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        cv2.putText(strip, text, (2, h - 10), cv2.FONT_HERSHEY_SIMPLEX,
                    0.35, 255, 1)
    return strip.astype(np.float32) / 255.0


def annotate_pupil(image01: np.ndarray, label: np.ndarray) -> np.ndarray:
    """A crosshair at the centroid of the pupil (class 3)."""
    img = np.ascontiguousarray(np.asarray(image01, np.float32))
    ys, xs = np.nonzero(np.squeeze(label) == 3)
    cv2 = _cv2()
    if len(ys) == 0 or cv2 is None:
        return img
    cy, cx = int(ys.mean()), int(xs.mean())
    u8 = (img * 255).astype(np.uint8)
    cv2.drawMarker(u8, (cx, cy), 255, markerType=cv2.MARKER_CROSS,
                   markerSize=9, thickness=1)
    return u8.astype(np.float32) / 255.0


def style_grid(style: np.ndarray, w: int, h: int, max_refs: int = 4
               ) -> np.ndarray:
    """At most 4 style references tiled 2x2 in a (h, w) cell."""
    k = min(style.shape[0], max_refs)
    cells = [_resize(_to_img01(style[i]), w // 2, h // 2) for i in range(k)]
    while len(cells) < 4:
        cells.append(np.zeros((h // 2, w // 2), np.float32))
    top = np.concatenate(cells[:2], axis=1)
    bot = np.concatenate(cells[2:4], axis=1)
    return np.concatenate([top, bot], axis=0)


def visualize_sidebyside(data: Dict, w: int = 200, h: int = 320,
                         error_list: Optional[np.ndarray] = None) -> Dict:
    """-> {"user/filename": (1,H,W) float panel in [-1,1]}, one per sample
    of ``data`` (a batch with its ``fake``)."""
    visuals = {}
    n = len(data["fake"])
    users = data.get("user", ["?"] * n)
    names = data.get("filename", ["?"] * n)
    for i in range(n):
        panels = [
            style_grid(np.asarray(data["style_image"][i]), w, h),
            _resize(_to_img01(np.asarray(data["label"][i])), w, h),
        ]
        if "target" in data:
            panels.append(_resize(_to_img01(np.asarray(data["target"][i])),
                                  w, h))
        fake = _resize(_to_img01(np.asarray(data["fake"][i])), w, h)
        panels.append(fake)
        if "target" in data:
            err = np.abs(fake - panels[2])
            err = err / max(err.max(), 1e-6)
            panels.append(err)
        row = np.concatenate(panels, axis=1)
        footer_txt = f"{users[i]} {names[i]}"
        if error_list is not None:
            footer_txt += f" err={float(np.ravel(error_list)[i]):.4f}"
        footer = _text_strip(footer_txt, row.shape[1])
        panel = np.concatenate([row, footer], axis=0)
        visuals[f"{users[i]}/{names[i]}"] = (panel * 2.0 - 1.0)[None]
    return visuals


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.log_dir = os.path.join(opt.checkpoints_dir, opt.name, "logs")
        self.writer = None
        if opt.tf_log:
            from tensorboardX import SummaryWriter
            os.makedirs(self.log_dir, exist_ok=True)
            self.writer = SummaryWriter(self.log_dir)
        self.log_name = None
        if opt.isTrain:
            os.makedirs(opt.expr_dir, exist_ok=True)
            self.log_name = os.path.join(opt.expr_dir, "loss_log.txt")
            with open(self.log_name, "a") as f:
                f.write("================ Training Loss (%s) ================\n"
                        % time.strftime("%c"))

    def print_current_errors(self, epoch, i, errors: Dict[str, float],
                             t: float) -> None:
        message = "(epoch: %d, iters: %d, time: %.3f) " % (epoch, i, t)
        for k, v in errors.items():
            message += "%s: %.3f " % (k, float(np.mean(np.asarray(v))))
        print(message)
        if self.log_name:
            with open(self.log_name, "a") as f:
                f.write("%s\n" % message)

    def plot_current_errors(self, errors: Dict[str, float], step: int) -> None:
        if self.writer is not None:
            for k, v in errors.items():
                self.writer.add_scalar(k, float(np.mean(np.asarray(v))), step)

    def display_current_results(self, visuals: Dict, epoch, step) -> None:
        if self.writer is not None:
            for k, v in visuals.items():
                img01 = np.clip((np.asarray(v) + 1.0) / 2.0, 0, 1)
                self.writer.add_image(k.replace("/", "_"), img01, step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
