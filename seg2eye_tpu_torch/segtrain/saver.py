"""Experiment directory with best-run tracking (counterpart of
``seg2eye_tpu/segtrain/saver.py``; reference: refinenet/deeplab/utils/
saver.py).

  * run/<dataset>/<checkname>/experiment_<id>, id = the last existing + 1.
    The glob is sorted lexicographically, as the reference's: with 11 or
    more runs experiment_9 sorts after experiment_10, the id collides with
    an existing directory and its checkpoint.ckpt is overwritten (the
    reference's quirk, kept).
  * ``save_checkpoint`` writes checkpoint.ckpt, ``torch.save`` of the
    reference's {"epoch", "best_pred", "state_dict", "optimizer"},
    through a temporary name and a rename; when ``is_best``, best_pred.txt,
    and the checkpoint is copied to <directory>/model_best.ckpt when it
    beats the best_pred.txt of every earlier run.
    With ``fmt="flax"`` the state is the JAX package's payload {"epoch",
    "best_pred", "params", "batch_stats", "opt"}, written as flax msgpack,
    as its Saver writes it; ``load_checkpoint`` reads either format (told
    apart by the first bytes), a JAX one as its plain tree.
  * ``save_experiment_config`` writes parameters.txt with the
    reference's 'datset' key.
"""
from __future__ import annotations

import glob
import os
import shutil
from collections import OrderedDict
from typing import Dict

import torch

from seg2eye_tpu_torch.utils import flax_msgpack
from seg2eye_tpu_torch.utils.checkpoint import _atomic_save


class Saver:
    def __init__(self, args):
        self.args = args
        self.directory = os.path.join("run", args.dataset, args.checkname)
        self.runs = sorted(glob.glob(
            os.path.join(self.directory, "experiment_*")))
        run_id = int(self.runs[-1].split("_")[-1]) + 1 if self.runs else 0
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_checkpoint(self, state: Dict, is_best: bool,
                        filename: str = "checkpoint.ckpt",
                        fmt: str = "torch") -> str:
        """``state``: {"epoch", "best_pred", "state_dict", "optimizer"}, or
        with ``fmt="flax"`` the JAX package's payload."""
        filename = os.path.join(self.experiment_dir, filename)
        if fmt == "flax":
            flax_msgpack.write(filename, state)
        else:
            _atomic_save(state, filename)
        if is_best:
            best_pred = float(state["best_pred"])
            with open(os.path.join(self.experiment_dir,
                                   "best_pred.txt"), "w") as f:
                f.write(str(best_pred))
            if self.runs:
                previous_miou = [0.0]
                for run in self.runs:
                    run_id = run.split("_")[-1]
                    path = os.path.join(self.directory,
                                        f"experiment_{run_id}",
                                        "best_pred.txt")
                    if os.path.exists(path):
                        with open(path) as f:
                            previous_miou.append(float(f.readline()))
                if best_pred > max(previous_miou):
                    shutil.copyfile(filename, os.path.join(
                        self.directory, "model_best.ckpt"))
            else:
                shutil.copyfile(filename, os.path.join(
                    self.directory, "model_best.ckpt"))
        return filename

    @staticmethod
    def load_checkpoint(path: str) -> Dict:
        """The resume path (train.py:74-87): a saved state, its tensors on
        the CPU; a JAX package's checkpoint as its tree of numpy arrays."""
        if not os.path.isfile(path):
            raise RuntimeError(f"=> no checkpoint found at '{path}'")
        if flax_msgpack.is_flax_msgpack(path):
            return flax_msgpack.read(path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def save_experiment_config(self) -> None:
        p = OrderedDict()
        p["datset"] = self.args.dataset          # the reference's key
        p["backbone"] = self.args.backbone
        p["out_stride"] = self.args.out_stride
        p["lr"] = self.args.lr
        p["lr_scheduler"] = self.args.lr_scheduler
        p["loss_type"] = self.args.loss_type
        p["epoch"] = self.args.epochs
        p["base_size"] = self.args.base_size
        p["crop_size"] = self.args.crop_size
        with open(os.path.join(self.experiment_dir, "parameters.txt"),
                  "w") as f:
            for key, val in p.items():
                f.write(f"{key}:{val}\n")
