"""Checkpoints (counterpart of ``seg2eye_tpu/utils/checkpoint.py``).

The networks are the reference's ``{which_epoch}_net_{G,D,E}.pth``
state_dicts in ``checkpoints_dir/name``: what the reference saves, and
what ``tools/export_torch_checkpoint.py`` writes from a JAX checkpoint.
Training also saves ``{which_epoch}_optim.pth``: the step count and both
Adam states (the reference saves none), so that a resumed run continues
the unbroken one bit for bit.  Every file is written to a temporary name
and renamed, so a reader never sees a partial checkpoint.  ``load_vgg``
reads the frozen VGG19 of the VGG loss from ``--vgg_weights``: a
torchvision ``vgg19`` or ``vgg19.features`` state_dict, never part of a
checkpoint.
"""
from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn


def network_path(opt, which_epoch: str, net: str) -> str:
    return os.path.join(opt.expr_dir, f"{which_epoch}_net_{net}.pth")


def optim_path(opt, which_epoch: str) -> str:
    return os.path.join(opt.expr_dir, f"{which_epoch}_optim.pth")


def _atomic_save(obj, path: str) -> None:
    # a pid-unique temporary name: two writers on one host never truncate
    # each other's file, and the last rename wins with an intact one
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


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


def save_state(state, opt, which_epoch) -> None:
    """The networks of a ``train.state.TrainState`` (as CPU tensors) and
    its optimizers."""
    model = state.model
    os.makedirs(opt.expr_dir, exist_ok=True)
    for name, net in (("G", model.netG), ("D", model.netD),
                      ("E", model.netE)):
        _atomic_save({k: v.detach().cpu() for k, v in
                      net.state_dict().items()},
                     network_path(opt, which_epoch, name))
    _atomic_save({"step": state.step, "opt_g": state.opt_g.state_dict(),
                  "opt_d": state.opt_d.state_dict()},
                 optim_path(opt, which_epoch))


def load_state(state, opt, which_epoch) -> None:
    """Strict-load the three networks into ``state`` and, when saved, the
    optimizers and the step count."""
    model = state.model
    load_networks({"G": model.netG, "E": model.netE, "D": model.netD}, opt,
                  which_epoch)
    path = optim_path(opt, which_epoch)
    if os.path.exists(path):
        aux = torch.load(path, map_location="cpu", weights_only=True)
        state.opt_g.load_state_dict(aux["opt_g"])
        state.opt_d.load_state_dict(aux["opt_d"])
        state.step = int(aux["step"])


def has_checkpoint(opt, which_epoch) -> bool:
    return os.path.exists(network_path(opt, which_epoch, "G"))


def load_vgg(net: nn.Module, opt) -> nn.Module:
    """Strict-load ``opt.vgg_weights`` into the VGG19 of the VGG loss;
    without it, refuse: a random perceptual net silently corrupts the
    loss."""
    from seg2eye_tpu_torch.models.vgg import load_vgg19

    if not opt.vgg_weights:
        raise ValueError("--no_vgg_loss False needs --vgg_weights: a "
                         "torchvision vgg19 (or vgg19.features) state_dict")
    return load_vgg19(net, torch.load(opt.vgg_weights, map_location="cpu",
                                      weights_only=True))
