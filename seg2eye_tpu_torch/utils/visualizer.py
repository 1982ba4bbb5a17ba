"""Training-loss logging (the loss half of
``seg2eye_tpu/utils/visualizer.py``): ``print_current_errors`` prints one
line per report and appends it to ``expr_dir/loss_log.txt`` under a dated
header.  The TensorBoard images and scalars of ``--tf_log`` are not ported:
asking for them raises, it is never skipped.
"""
from __future__ import annotations

import os
import time
from typing import Dict


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
