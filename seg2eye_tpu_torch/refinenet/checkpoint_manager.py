"""Step-numbered checkpoints with retention (counterpart of
``seg2eye_tpu/refinenet/checkpoint_manager.py``, after the reference's
refinenet/core/checkpoint_manager.py): ``%07d.ckpt`` names under
``output_dir/checkpoints``, the newest ``keep_n`` kept, the step read back
from the name.

The port's checkpoint is ``torch.save`` of {"model": the DeepLab's
state_dict (the reference's keys), "optimizer": the SGD state, "step"}.
The JAX package's, under the same names, is flax msgpack of its train
state {"variables": {params, batch_stats}, "opt": the optax state, "step"}
(``utils.optim_state``: the trace is SGD's momentum_buffer); the manager
reads either (told apart by their first bytes) and writes the port's,
or the JAX package's with ``fmt="flax"``.
Loading a JAX checkpoint checks its structure against the model and, with
``lr_at``, its learning rate against the port's schedule.  Files are
written to a temporary name and renamed, so a reader never sees a partial
one.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from seg2eye_tpu_torch.utils import flax_msgpack, optim_state, weights
from seg2eye_tpu_torch.utils.checkpoint import _atomic_save


def jax_train_state(state) -> dict:
    """A ``training.TrainState`` as the JAX package's train state."""
    net, cfg = state.model.net, state.model.cfg
    return {"variables": weights.deeplab_to_jax_variables(net, cfg.backbone),
            "opt": optim_state.refinenet_sgd_to_jax(state.optimizer, net, cfg,
                                                    state.step),
            "step": np.asarray(state.step, np.int32)}


def _load_jax_train_state(state, tree: dict) -> None:
    """The JAX package's train state (its structure checked) -> ``state``
    (model strictly, momentum, step)."""
    net, backbone = state.model.net, state.model.cfg.backbone
    net.load_state_dict(weights.deeplab_from_jax_variables(
        tree["variables"], backbone), strict=True)
    optim_state.sgd_from_jax(state.optimizer, net, backbone, tree["opt"])
    state.step = int(tree["step"])


class CheckpointManager:
    suffix = ".ckpt"

    def __init__(self, output_dir: str, keep_n: int = 3):
        self.dir = os.path.join(output_dir, "checkpoints")
        self.keep_n = keep_n

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, ("%07d" % step) + self.suffix)

    def save_at_step(self, step: int, state, fmt: str = "torch") -> str:
        """Save a ``training.TrainState``'s model, optimizer and step, in
        the port's format or (``fmt="flax"``) the JAX package's."""
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(step)
        if fmt == "flax":
            flax_msgpack.write(path, jax_train_state(state))
        else:
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

    def load_last_checkpoint(self, state,
                             lr_at: Optional[Callable[[int], float]] = None
                             ) -> Tuple[Optional[int], object]:
        """Load the newest checkpoint into ``state`` (the model strictly,
        the optimizer, the step) -> (its step, state); (None, state)
        unchanged when there is none.  ``lr_at(i)``: the port's learning
        rate at step index i, which a JAX checkpoint's must equal at its
        last step."""
        available = self._available()
        if not available:
            return None, state
        step, path = available[-1]
        if flax_msgpack.is_flax_msgpack(path):
            tree = flax_msgpack.read(path)
            flax_msgpack.check_like(tree, jax_train_state(state), path)
            if lr_at is not None and step > 0:
                optim_state.check_lr(tree["opt"], lr_at(step - 1), path)
            _load_jax_train_state(state, tree)
            return step, state
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.model.net.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return step, state
