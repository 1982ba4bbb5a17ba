"""Iteration/epoch bookkeeping with iter.txt resume (the port's copy of
``seg2eye_tpu/utils/iter_counter.py``, the reference's
util/iter_counter.py): the same trigger semantics (modulo-window checks
against batchSize), the same iter.txt format "epoch,epoch_iter", the same
per-iteration and per-epoch timing surface.
"""
from __future__ import annotations

import os
import time

import numpy as np


class IterationCounter:
    def __init__(self, opt, dataset_size: int):
        self.opt = opt
        self.dataset_size = dataset_size
        self.first_epoch = 1
        self.total_epochs = opt.niter + opt.niter_decay
        self.epoch_iter = 0
        self.current_epoch = self.first_epoch
        self.iter_record_path = os.path.join(opt.expr_dir, "iter.txt")
        if opt.isTrain and opt.continue_train:
            try:
                self.first_epoch, self.epoch_iter = np.loadtxt(
                    self.iter_record_path, delimiter=",", dtype=int)
                print("Resuming from epoch %d at iteration %d"
                      % (self.first_epoch, self.epoch_iter))
            except Exception:
                print("Could not load iteration record at %s. "
                      "Starting from beginning." % self.iter_record_path)
        self.current_epoch = self.first_epoch
        self.total_steps_so_far = (
            (self.first_epoch - 1) * dataset_size + self.epoch_iter)
        self.last_iter_time = time.time()
        self.epoch_start_time = time.time()
        self.time_per_iter = 0.0

    def training_epochs(self):
        return range(self.first_epoch, self.total_epochs + 1)

    def record_epoch_start(self, epoch: int):
        self.epoch_start_time = time.time()
        self.epoch_iter = 0
        self.last_iter_time = time.time()
        self.current_epoch = epoch

    def record_one_iteration(self):
        now = time.time()
        self.time_per_iter = (now - self.last_iter_time) / self.opt.batchSize
        self.last_iter_time = now
        self.total_steps_so_far += self.opt.batchSize
        self.epoch_iter += self.opt.batchSize

    def record_epoch_end(self):
        now = time.time()
        self.time_per_epoch = now - self.epoch_start_time
        print("End of epoch %d / %d \t Time Taken: %d sec"
              % (self.current_epoch, self.total_epochs, self.time_per_epoch))
        if self.current_epoch % self.opt.save_epoch_freq == 0:
            np.savetxt(self.iter_record_path,
                       (self.current_epoch + 1, 0), delimiter=",", fmt="%d")

    def record_current_iter(self):
        np.savetxt(self.iter_record_path,
                   (self.current_epoch, self.epoch_iter),
                   delimiter=",", fmt="%d")

    def needs_saving(self) -> bool:
        return (self.total_steps_so_far % self.opt.save_latest_freq) \
            < self.opt.batchSize

    def needs_printing(self) -> bool:
        return (self.total_steps_so_far % self.opt.print_freq) \
            < self.opt.batchSize

    def needs_displaying(self) -> bool:
        return (self.total_steps_so_far % self.opt.display_freq) \
            < self.opt.batchSize

    def needs_full_validation(self) -> bool:
        return (self.total_steps_so_far % self.opt.full_val_freq) \
            < self.opt.batchSize
