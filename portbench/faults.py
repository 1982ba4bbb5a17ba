"""Faults planted in the program's timed path, to show that the check
catches them (``tests/test_portbench_checks.py``; on the card at the cells'
sizes, ``calibrate.py --faults``).

  * ``unchanged``: a training step that returns its state unchanged (the
    step runs, and every weight and buffer is put back);
  * ``half``: half of the batch left out, the mean taken over the rest
    (training), or served from the first half alone (serving);
  * ``altered``: one answer altered where it is produced (serving: the
    first image's output replaced by the second image's).

No cell spans chips, so no exchange between chips can be left out.
``plant(driver, fault)`` is a context manager that patches what the
driver calls; the driver builds and runs inside it as it does on the card.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = {"seg2eye_train": ("unchanged", "half"),
          "refinenet_train": ("unchanged", "half"),
          "seg2eye_score": ("half", "altered"),
          "refinenet_serve": ("half", "altered")}


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def _twice(x):
    if torch.is_tensor(x):
        return torch.cat([x, x]) if x.dim() else x
    return np.concatenate([x, x])


@contextlib.contextmanager
def _patched(owner, name, replacement):
    real = getattr(owner, name)
    setattr(owner, name, replacement(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def _seg2eye_train(fault):
    from seg2eye_tpu_torch.train import steps

    def make(real):
        def step(state, batch):
            if fault == "half":
                return real(state, _half(batch))
            nets = [state.model.netG, state.model.netE, state.model.netD]
            saved = [{k: v.clone() for k, v in n.state_dict().items()}
                     for n in nets]
            out = real(state, batch)
            for n, sd in zip(nets, saved):
                n.load_state_dict(sd)
            return out
        return step
    return _patched(steps, "train_step", make)


def _refinenet_train(fault):
    from seg2eye_tpu_torch.refinenet import training

    def make(real):
        def step(self, state, batch, lr, generator=None):
            if fault == "half":
                return real(self, state, _half(batch), lr, generator)
            net = state.model.net
            saved = {k: v.clone() for k, v in net.state_dict().items()}
            out = real(self, state, batch, lr, generator)
            net.load_state_dict(saved)
            return out
        return step
    return _patched(training.Trainer, "train_step", make)


def _refinenet_serve(fault):
    from seg2eye_tpu_torch.refinenet import training

    def make(real):
        def step(self, state, batch):
            if fault == "half":
                return {k: _twice(v)
                        for k, v in real(self, state, _half(batch)).items()}
            out = dict(real(self, state, batch))
            out["prediction"] = out["prediction"].clone()
            out["prediction"][0] = out["prediction"][1]
            return out
        return step
    return _patched(training.Trainer, "eval_step", make)


def _seg2eye_score(fault):
    from seg2eye_tpu_torch.eval.tester import Tester

    def make(real):
        def score(self, model, batch, need_fake=True):
            if fault == "half":
                errors, fake = real(self, model, _half(batch), need_fake)
                return _twice(errors), _twice(fake)
            errors, fake = real(self, model, batch, need_fake)
            errors, fake = errors.copy(), fake.copy()
            errors[0], fake[0] = errors[1], fake[1]
            return errors, fake
        return score
    return _patched(Tester, "score_batch", make)


PATCHERS = {"seg2eye_train": _seg2eye_train,
            "refinenet_train": _refinenet_train,
            "seg2eye_score": _seg2eye_score,
            "refinenet_serve": _refinenet_serve}


def plant(driver_name: str, fault: str):
    if fault not in FAULTS[driver_name]:
        raise ValueError(f"{driver_name} has no fault {fault!r}")
    return PATCHERS[driver_name](fault)
