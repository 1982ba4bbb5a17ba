"""GauGAN training: ``seg2eye_tpu_torch.train.steps.train_step`` (the G step
with the hinge, feature-matching and VGG losses, then the D step with the
fake regenerated) on a train state of the seeded weights (G, D and the
frozen VGG19, loaded ``strict=True``), built by ``models.pix2pix.
build_networks`` from the configuration's options (``netG`` 'spade'), fed
by ``data.openeds.device_prefetch`` from the ring: uint8 label maps,
instance maps and RGB targets, made into one-hot maps, instance edges and
images on the card by ``Pix2Pix.preprocess``.

Importing this module adds its faults (``unchanged``, ``half``) to
``portbench.faults``, which ``calibrate.py`` plants by the cell's driver
name.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench import faults, roofline
from portbench.driver import CHECKED_STEPS, TrainDriver, norms
from portbench.drivers import _seg2eye as s2e
from portbench.reference import gaugan as ref
from portbench.reference.common import Products, make_state, tf32_off
from portbench.reference.seg2eye import trained_keys
from portbench.traffic import meta_batch

TRAINED = ("G", "D")
KEYS = ("label", "instance", "target")


def weights(cfg: Dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state dict} drawn on ``device`` from the seed."""
    return {net: make_state(s, seed, device, f"weights/{net}")
            for net, s in ref.specs(cfg).items()}


def _totals(losses: Dict) -> Dict[str, float]:
    """The G and D totals, and the VGG term on its own (the one loss that
    reads VGG19)."""
    vgg = float(losses["VGG/weighted"] if "VGG/weighted" in losses
                else losses["VGG"])
    return {"G": float(losses["GAN"]) + float(losses["GAN_Feat"]) + vgg,
            "D": float(losses["D/Fake"]) + float(losses["D/real"]),
            "VGG": vgg}


class Driver(TrainDriver):
    def build(self) -> None:
        from seg2eye_tpu_torch.data.openeds import device_prefetch
        from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
        from seg2eye_tpu_torch.train import state as state_lib
        from seg2eye_tpu_torch.train import steps

        self._train_step = steps.train_step
        opt = s2e.options(self.cfg, self.cell, train=True)
        nets = s2e.port_nets(opt, weights(self.cfg, self.seed, self.device),
                             self.device)
        self.state = state_lib.create_state(Pix2Pix(opt, nets, self.device))
        self.make_ring()
        self.feed = device_prefetch(self.ring.cycle(), self.device, KEYS)

    def step(self, i: int):
        _, batch = next(self.feed)
        losses, _ = self._train_step(self.state, batch)
        return losses

    def loss_values(self, out) -> Dict[str, float]:
        return _totals(out)

    def _nets(self):
        m = self.state.model
        return {"G": m.netG, "D": m.netD}

    def named_params(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": p for n, net in self._nets().items()
                for k, p in net.named_parameters()}

    def named_buffers(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": b for n, net in self._nets().items()
                for k, b in net.named_buffers()}

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment after one step is (1 - beta1) g."""
        names = {id(p): k for k, p in self.named_params().items()}
        out = {}
        for opt in (self.state.opt_g, self.state.opt_d):
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p)
                    if st:
                        out[names[id(p)]] = st["exp_avg"] / (
                            1.0 - group["betas"][0])
        return out

    def initial_params(self) -> Dict[str, torch.Tensor]:
        sd = weights(self.cfg, self.seed, self.device)
        return {f"{n}.{k}": sd[n][k] for n in TRAINED
                for k in trained_keys(sd[n])}

    def release(self) -> None:
        self.state = self.feed = None

    def reference_readings(self, precision: str) -> Dict:
        sd = weights(self.cfg, self.seed, self.device)
        p0 = {(n, k): sd[n][k].clone() for n in TRAINED
              for k in trained_keys(sd[n])}
        trainer = ref.Trainer(self.cfg, sd, Products(precision))
        losses = []
        with tf32_off():
            for i in range(CHECKED_STEPS):
                out, grads = trainer.step(self.ring[i], self.device)
                losses.append(_totals(out))
                if i == 0:
                    grad1 = norms({f"{n}.{k}": g
                                   for (n, k), g in grads.items()})
                del grads
        change = norms({f"{n}.{k}": sd[n][k] - v for (n, k), v in p0.items()})
        buffers = {f"{n}.{k}": v for n in TRAINED for k, v in sd[n].items()
                   if (n, k) not in p0}
        return {"losses": losses, "grad1": grad1, "change": change,
                "buffers": buffers}

    def model_flops(self) -> float:
        sd = {n: make_state(s, 0, "meta") for n, s in ref.specs(self.cfg).items()}
        trainer = ref.Trainer(self.cfg, sd)
        return roofline.count_flops(trainer.step, meta_batch(self.cell),
                                    "meta")


# ---- faults in the timed path (``portbench.faults``' two training faults)
def _plant(fault: str):
    from seg2eye_tpu_torch.train import steps

    def make(real):
        def step(state, batch):
            if fault == "half":
                return real(state, faults._half(batch))
            nets = [state.model.netG, state.model.netD]
            saved = [{k: v.clone() for k, v in n.state_dict().items()}
                     for n in nets]
            out = real(state, batch)
            for n, sd in zip(nets, saved):
                n.load_state_dict(sd)
            return out
        return step
    return faults._patched(steps, "train_step", make)


faults.FAULTS.setdefault("gaugan_train", ("unchanged", "half"))
faults.PATCHERS.setdefault("gaugan_train", _plant)
