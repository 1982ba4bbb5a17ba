"""RefineNet training: ``seg2eye_tpu_torch.refinenet.training.Trainer.
train_step`` (forward with batch statistics and dropout, the eds loss's
backward, the global-norm clip, SGD with Nesterov momentum and weight
decay), fed by ``data.openeds.device_prefetch``.  Step i's dropout comes
from a generator seeded from (seed, i), handed to both sides."""
from __future__ import annotations

from typing import Dict

import torch

from portbench import roofline
from portbench.driver import CHECKED_STEPS, TrainDriver, norms
from portbench.drivers import _refinenet as rn
from portbench.reference import deeplab as ref
from portbench.reference.common import (Products, make_state, seed_of,
                                        tf32_off)
from portbench.traffic import meta_batch


class Driver(TrainDriver):
    def dropout(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, f"dropout/{i}"))

    def build(self) -> None:
        from seg2eye_tpu_torch.data.openeds import device_prefetch
        from seg2eye_tpu_torch.refinenet import training

        self.make_ring()
        model, rcfg = rn.port_model(self.cfg, self.cell, rn.weights(
            self.cfg, self.seed, self.device), self.device)
        self.trainer = training.Trainer(model, rcfg, "eds_loss",
                                        momentum=self.cfg["momentum"])
        self.state = training.TrainState(model, training.make_optimizer(
            model.net.parameters(), rcfg, self.cfg["momentum"]))
        self.lr = rcfg.learning_rate
        self.feed = device_prefetch(self.ring.cycle(), self.device,
                                    training.MODEL_KEYS)

    def step(self, i: int):
        _, batch = next(self.feed)
        scalars, _ = self.trainer.train_step(self.state, batch, self.lr,
                                             self.dropout(i))
        return scalars

    def loss_values(self, out) -> Dict[str, float]:
        return {"eds_loss": float(out["eds_loss"])}

    def named_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.model.net.named_parameters())

    def named_buffers(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.model.net.named_buffers())

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """SGD's momentum buffer after one step is the clipped gradient
        plus weight_decay times the initial weight."""
        opt = self.state.optimizer
        p0 = self.initial_params()
        out = {}
        for k, p in self.named_params().items():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[k] = buf - self.cfg["weight_decay"] * p0[k]
        return out

    def initial_params(self) -> Dict[str, torch.Tensor]:
        sd = rn.weights(self.cfg, self.seed, self.device)
        return {k: sd[k] for k in ref.trained_keys(sd)}

    def release(self) -> None:
        self.trainer = self.state = self.feed = None

    def reference_readings(self, precision: str) -> Dict:
        sd = rn.weights(self.cfg, self.seed, self.device)
        keys = ref.trained_keys(sd)
        p0 = {k: sd[k].clone() for k in keys}
        trainer = ref.Trainer(self.cfg, sd, Products(precision))
        losses = []
        with tf32_off():
            for i in range(CHECKED_STEPS):
                loss, grads = trainer.step(self.ring[i], self.device,
                                           self.dropout(i))
                losses.append({"eds_loss": float(loss)})
                if i == 0:
                    grad1 = norms(grads)
        return {"losses": losses, "grad1": grad1,
                "change": norms({k: sd[k] - p0[k] for k in keys}),
                "buffers": {k: v for k, v in sd.items() if k not in p0}}

    def model_flops(self) -> float:
        trainer = ref.Trainer(self.cfg, make_state(ref.specs(self.cfg), 0,
                                                   "meta"))
        # dropout's masks cost no products: counted without them
        return roofline.count_flops(trainer.step, meta_batch(self.cell),
                                    "meta", None)
