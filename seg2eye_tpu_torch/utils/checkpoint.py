"""Checkpoint loading (counterpart of the load side of
``seg2eye_tpu/utils/checkpoint.py``).

The files are the reference's ``{which_epoch}_net_{G,E}.pth`` state_dicts in
``checkpoints_dir/name``: what the reference saves, and what
``tools/export_torch_checkpoint.py`` writes from a JAX checkpoint.
"""
from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn


def network_path(opt, which_epoch: str, net: str) -> str:
    return os.path.join(opt.expr_dir, f"{which_epoch}_net_{net}.pth")


def load_networks(nets: Dict[str, nn.Module], opt,
                  which_epoch: str) -> Dict[str, nn.Module]:
    """Strict-load every network of ``nets`` in place.  A missing file is
    an error: evaluation must never run random weights."""
    for name, net in nets.items():
        path = network_path(opt, which_epoch, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No checkpoint for net{name} at {path} "
                f"(which_epoch='{which_epoch}')")
        state = torch.load(path, map_location="cpu", weights_only=True)
        net.load_state_dict(state, strict=True)
    return nets
