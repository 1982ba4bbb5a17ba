"""Step-numbered checkpoints with retention (counterpart of
``seg2eye_tpu/refinenet/checkpoint_manager.py``, after the reference's
refinenet/core/checkpoint_manager.py): ``%07d.ckpt`` names under
``output_dir/checkpoints``, the newest ``keep_n`` kept, the step read back
from the name.

A checkpoint is ``torch.save`` of {"model": the DeepLab's state_dict (the
reference's keys), "optimizer": the SGD state, "step"}, written to a
temporary name and renamed, so a reader never sees a partial file.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import torch

from seg2eye_tpu_torch.utils.checkpoint import _atomic_save


class CheckpointManager:
    suffix = ".ckpt"

    def __init__(self, output_dir: str, keep_n: int = 3):
        self.dir = os.path.join(output_dir, "checkpoints")
        self.keep_n = keep_n

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, ("%07d" % step) + self.suffix)

    def save_at_step(self, step: int, state) -> str:
        """Save a ``training.TrainState``'s model, optimizer and step."""
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(step)
        _atomic_save({"model": {k: v.detach().cpu() for k, v in
                                state.model.net.state_dict().items()},
                      "optimizer": state.optimizer.state_dict(),
                      "step": state.step}, path)
        self._retain()
        return path

    def _available(self):
        return sorted(
            (int(os.path.split(fn)[-1].split(".")[0]), fn)
            for fn in glob.glob(os.path.join(self.dir, "*" + self.suffix)))

    def _retain(self):
        available = self._available()
        if len(available) > self.keep_n:
            for step, path in available[:-self.keep_n]:
                os.remove(path)

    def load_last_checkpoint(self, state) -> Tuple[Optional[int], object]:
        """Load the newest checkpoint into ``state`` (the model strictly,
        the optimizer, the step) -> (its step, state); (None, state)
        unchanged when there is none."""
        available = self._available()
        if not available:
            return None, state
        step, path = available[-1]
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.model.net.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return step, state
