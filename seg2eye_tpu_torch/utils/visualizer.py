"""Training-loss logging (the loss half of
``seg2eye_tpu/utils/visualizer.py``): ``print_current_errors`` prints one
line per report and appends it to ``expr_dir/loss_log.txt`` under a dated
header.  The TensorBoard images and scalars of ``--tf_log`` are not ported:
asking for them raises, it is never skipped.  ``_to_img01`` and
``_text_strip`` build the RefineNet trainer's prediction strips; cv2,
which draws the text, is imported inside ``_text_strip``, and without it
the strip stays blank.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np


def _to_img01(x: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,255] or class ids -> a [0,1] grayscale HW array."""
    x = np.asarray(x, np.float32)
    x = np.squeeze(x)
    if x.max() <= 1.0 + 1e-6 and x.min() >= -1.0 - 1e-6:
        return (x + 1.0) / 2.0
    if x.max() < 4:          # label map (postprocessor.py:64-66)
        return x / 3.0
    return x / 255.0


def _text_strip(text: str, w: int, h: int = 60) -> np.ndarray:
    """A (h, w) [0,1] footer with ``text`` drawn by cv2.putText
    (util/image_annotate.py); blank without cv2."""
    strip = np.zeros((h, w), np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cv2.putText(strip, text, (2, h - 10), cv2.FONT_HERSHEY_SIMPLEX,
                    0.35, 255, 1)
    return strip.astype(np.float32) / 255.0


class Visualizer:
    def __init__(self, opt):
        if opt.tf_log:
            raise NotImplementedError(
                "--tf_log (TensorBoard images and scalars) is not ported")
        self.opt = opt
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
            message += "%s: %.3f " % (k, v)
        print(message)
        if self.log_name:
            with open(self.log_name, "a") as f:
                f.write("%s\n" % message)
