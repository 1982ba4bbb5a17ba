"""LR schedule of the segmentation trainer (a copy of
``seg2eye_tpu/segtrain/lr_scheduler.py``; reference: refinenet/deeplab/
utils/lr_scheduler.py).

  * poly: lr (1 - T/N)^0.9, cos: 0.5 lr (1 + cos(pi T/N)),
    step: lr 0.1^(epoch // lr_step), with T = epoch iters_per_epoch + i;
  * linear warmup over warmup_epochs iters_per_epoch steps;
  * 'step' asserts a nonzero lr_step at construction, as the reference
    does (its train.py passes none, so ``--lr-scheduler step`` aborts
    there too);
  * the head's 10x is the optimizer's second param group
    (``trainer.make_optimizer``): the schedule is a function of the step.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, mode: str, base_lr: float, num_epochs: int,
                 iters_per_epoch: int = 0, lr_step: int = 0,
                 warmup_epochs: int = 0):
        if mode not in ("cos", "poly", "step"):
            raise NotImplementedError(mode)
        print(f"Using {mode} LR Scheduler!")
        self.mode = mode
        self.lr = base_lr
        if mode == "step":
            assert lr_step
        self.lr_step = lr_step
        self.iters_per_epoch = iters_per_epoch
        self.N = num_epochs * iters_per_epoch
        self.warmup_iters = warmup_epochs * iters_per_epoch

    def __call__(self, i: int, epoch: int) -> float:
        T = epoch * self.iters_per_epoch + i
        if self.mode == "cos":
            lr = 0.5 * self.lr * (1 + math.cos(1.0 * T / self.N * math.pi))
        elif self.mode == "poly":
            lr = self.lr * pow(1 - 1.0 * T / self.N, 0.9)
        else:  # step
            lr = self.lr * (0.1 ** (epoch // self.lr_step))
        if self.warmup_iters > 0 and T < self.warmup_iters:
            lr = lr * 1.0 * T / self.warmup_iters
        assert lr >= 0
        return lr
