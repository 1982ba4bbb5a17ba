"""Checkpoints (counterpart of ``seg2eye_tpu/utils/checkpoint.py``).

The port's own files are the reference's ``{which_epoch}_net_{G,D,E}.pth``
state_dicts in ``checkpoints_dir/name``: what the reference saves, and
what ``tools/export_torch_checkpoint.py`` writes from a JAX checkpoint.
Training also saves ``{which_epoch}_optim.pth``: the step count and both
Adam states (the reference saves none), so that a resumed run continues
the unbroken one bit for bit.  Every file is written to a temporary name
and renamed, so a reader never sees a partial checkpoint.

The JAX package's files are read and written as well:
``{which_epoch}_net_{G,D,E}.ckpt`` (flax msgpack of each network's
variables) and ``{which_epoch}_optim.ckpt`` ({step, opt_g, opt_d}, the
optax states; ``utils.optim_state``).  A network or the optimizers are
read from whichever of the two files of that epoch exists; with both
there, loading raises rather than guess.  A ``.ckpt`` of another layout
or configuration is refused (``flax_msgpack.check_like``), and its
learning rates must be the port's schedule's at some epoch of the run.
``save_state_jax`` writes the JAX package's files, which its
``load_state(strict=True)`` restores; ``num_batches_tracked``, a counter
that no forward reads, is not in that format and comes back as 0.

Under tensor parallelism (``parallel.tensor_parallel``) ``save_state``
gathers the slices of the networks and of the Adam moments on every rank
(a collective over each model group) and rank 0 writes the files of a
one-process run, in either format; a run loads them whole and then keeps
its slices (``train.loop``), so a tensor-parallel run and a one-process
run resume from each other's files.

``load_vgg`` reads the frozen VGG19 of the VGG loss from
``--vgg_weights``: a torchvision ``vgg19`` or ``vgg19.features``
state_dict, never part of a checkpoint.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.parallel import tensor_parallel as tp
from seg2eye_tpu_torch.utils import flax_msgpack, optim_state, weights

TORCH, JAX = ".pth", ".ckpt"


def network_path(opt, which_epoch: str, net: str, ext: str = TORCH) -> str:
    return os.path.join(opt.expr_dir, f"{which_epoch}_net_{net}{ext}")


def optim_path(opt, which_epoch: str, ext: str = TORCH) -> str:
    return os.path.join(opt.expr_dir, f"{which_epoch}_optim{ext}")


def _atomic_save(obj, path: str) -> None:
    # a pid-unique temporary name: two writers on one host never truncate
    # each other's file, and the last rename wins with an intact one
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _pick(torch_path: str, jax_path: str) -> Optional[str]:
    """The one of the two files that exists; None when neither does."""
    there = [p for p in (torch_path, jax_path) if os.path.exists(p)]
    if len(there) > 1:
        raise ValueError(f"both {torch_path} and {jax_path} exist: remove "
                         "the one not to load")
    return there[0] if there else None


def checkpoint_format(opt, which_epoch) -> Optional[str]:
    """"torch" or "flax": the format of the epoch's generator file; None
    without one."""
    path = _pick(network_path(opt, which_epoch, "G"),
                 network_path(opt, which_epoch, "G", JAX))
    return None if path is None else ("flax" if path.endswith(JAX)
                                      else "torch")


def load_jax_network(net: nn.Module, name: str, variables: Dict,
                     where: str) -> None:
    """Strict-load the JAX package's variables of network ``name`` ("G",
    "E" or "D") into ``net``."""
    flax_msgpack.check_like(
        variables, weights.IMPORTERS[name](weights.numpy_state_dict(net)),
        where)
    net.load_state_dict(weights.from_jax_variables({name: variables})[name],
                        strict=True)


def load_networks(nets: Dict[str, nn.Module], opt,
                  which_epoch: str) -> Dict[str, nn.Module]:
    """Strict-load every network of ``nets`` in place, from its ``.pth``
    or its ``.ckpt``.  A missing file is an error: evaluation must never
    run random weights."""
    for name, net in nets.items():
        path = _pick(network_path(opt, which_epoch, name),
                     network_path(opt, which_epoch, name, JAX))
        if path is None:
            raise FileNotFoundError(
                f"No checkpoint for net{name} at "
                f"{network_path(opt, which_epoch, name)} or "
                f"{network_path(opt, which_epoch, name, JAX)} "
                f"(which_epoch='{which_epoch}')")
        if path.endswith(JAX):
            load_jax_network(net, name, flax_msgpack.read(path), path)
        else:
            net.load_state_dict(torch.load(path, map_location="cpu",
                                           weights_only=True), strict=True)
    return nets


def _nets(state) -> Dict[str, nn.Module]:
    model = state.model
    return {"G": model.netG, "D": model.netD, "E": model.netE}


def whole_networks(nets: Dict[str, nn.Module], opt,
                   device: str | torch.device = "cpu"
                   ) -> Dict[str, nn.Module]:
    """Copies of ``nets`` ("G", "E", "D") on ``device`` with every
    tensor-parallel slice gathered: every rank of each model group must
    call it."""
    from seg2eye_tpu_torch.models.pix2pix import build_networks

    built = build_networks(opt.replace(isTrain="D" in nets))
    out = {}
    for name, net in nets.items():
        sd = {k: tp.whole(v) for k, v in
              net.state_dict(keep_vars=True).items()}
        out[name] = built[name].to(device)
        out[name].load_state_dict(sd, strict=True)
    return out


def whole_state(state, device: str | torch.device = "cpu"):
    """``state`` itself, or under tensor parallelism a copy of it on
    ``device`` with whole networks and Adam moments (``whole_networks``;
    every model rank must call it), sharing no tensor with it."""
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.train import state as state_lib

    if not any(tp.is_sharded(p) for net in _nets(state).values()
               for p in net.parameters()):
        return state
    opt = state.model.opt
    whole = state_lib.create_state(Pix2Pix(
        opt, whole_networks(_nets(state), opt, device), device))
    whole.opt_g.load_state_dict(tp.whole_optimizer_state(state.opt_g))
    whole.opt_d.load_state_dict(tp.whole_optimizer_state(state.opt_d))
    whole.step = state.step
    return whole


def save_state(state, opt, which_epoch, fmt: str = "torch",
               optim: bool = True) -> None:
    """The networks of a ``train.state.TrainState`` (as CPU tensors) and,
    with ``optim``, its optimizers, in the port's format or
    (``fmt="flax"``) the JAX package's.  Every rank calls it (the slices
    of a tensor-parallel state are gathered); rank 0 writes."""
    state = whole_state(state)
    if not dp.is_primary():
        return
    if fmt == "flax":
        save_state_jax(state, opt, which_epoch, optim)
        return
    os.makedirs(opt.expr_dir, exist_ok=True)
    for name, net in _nets(state).items():
        _atomic_save({k: v.detach().cpu() for k, v in
                      net.state_dict().items()},
                     network_path(opt, which_epoch, name))
    if optim:
        _atomic_save({"step": state.step, "opt_g": state.opt_g.state_dict(),
                      "opt_d": state.opt_d.state_dict()},
                     optim_path(opt, which_epoch))


def jax_optim_state(state, opt) -> Dict:
    """{step, opt_g, opt_d} as the JAX package's ``save_state`` writes
    them."""
    model = state.model
    return {"step": np.asarray(state.step, np.int32),
            "opt_g": optim_state.adam_to_jax(
                state.opt_g, {"G": model.netG, "E": model.netE},
                opt.weight_decay, masked=True),
            "opt_d": optim_state.adam_to_jax(
                state.opt_d, {"D": model.netD}, opt.weight_decay,
                masked=False)}


def save_state_jax(state, opt, which_epoch,
                   optim: bool = True) -> Dict[str, int]:
    """The JAX package's ``{which_epoch}_net_{G,D,E}.ckpt`` and (with
    ``optim``) ``{which_epoch}_optim.ckpt`` -> {file name: bytes
    written}."""
    os.makedirs(opt.expr_dir, exist_ok=True)
    sizes = {}
    for name, net in _nets(state).items():
        path = network_path(opt, which_epoch, name, JAX)
        sizes[os.path.basename(path)] = flax_msgpack.write(
            path, weights.IMPORTERS[name](weights.numpy_state_dict(net)))
    if optim:
        path = optim_path(opt, which_epoch, JAX)
        sizes[os.path.basename(path)] = flax_msgpack.write(
            path, jax_optim_state(state, opt))
    return sizes


def _check_schedule(aux: Dict, opt, where: str) -> None:
    """The checkpoint's (G, D) learning rates must be the port's schedule's
    at some epoch of the run."""
    from seg2eye_tpu_torch.train import state as state_lib

    got = tuple(np.float32(aux[k]["hyperparams"]["learning_rate"])
                for k in ("opt_g", "opt_d"))
    for epoch in range(1, opt.niter + opt.niter_decay + 1):
        lrs = state_lib.ttur_lrs(opt, state_lib.epoch_lr(opt, epoch))
        if all(np.isclose(g, np.float32(w), rtol=1e-6, atol=0)
               for g, w in zip(got, lrs)):
            return
    raise ValueError(f"{where}: learning rates (G, D) {got} are not the "
                     "port's schedule's at any epoch: another lr, no_TTUR, "
                     "niter or niter_decay")


def load_state(state, opt, which_epoch) -> None:
    """Strict-load the three networks into ``state`` and, when saved, the
    optimizers and the step count."""
    load_networks(_nets(state), opt, which_epoch)
    path = _pick(optim_path(opt, which_epoch),
                 optim_path(opt, which_epoch, JAX))
    if path is None:
        return
    model = state.model
    if path.endswith(JAX):
        aux = flax_msgpack.read(path)
        flax_msgpack.check_like(aux, jax_optim_state(state, opt), path)
        _check_schedule(aux, opt, path)
        optim_state.adam_from_jax(state.opt_g, {"G": model.netG,
                                                "E": model.netE},
                                  aux["opt_g"], opt.weight_decay, masked=True)
        optim_state.adam_from_jax(state.opt_d, {"D": model.netD},
                                  aux["opt_d"], opt.weight_decay,
                                  masked=False)
        state.step = int(aux["step"])
        return
    aux = torch.load(path, map_location="cpu", weights_only=True)
    state.opt_g.load_state_dict(aux["opt_g"])
    state.opt_d.load_state_dict(aux["opt_d"])
    state.step = int(aux["step"])


def has_checkpoint(opt, which_epoch) -> bool:
    return checkpoint_format(opt, which_epoch) is not None


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
