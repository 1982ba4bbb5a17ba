"""RefineNet serving: ``seg2eye_tpu_torch.refinenet.training.Trainer.
eval_step`` (DeepLabV3+ on its running statistics, the residual head)
fed by ``data.openeds.device_prefetch``; each batch ends when its
prediction (the refined image) is on the host.

The running statistics are the benchmark's: the reference, in float32,
writes the batch statistics of the first ``calibrate`` images of ring slot
0 as the running ones (momentum 1), so that the eval forward of seeded
weights is well scaled; the same state dict goes to both sides."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import roofline
from portbench.driver import ServeDriver, rms_gap
from portbench.drivers import _refinenet as rn
from portbench.reference import deeplab as ref
from portbench.reference.common import Products, make_state, tf32_off
from portbench.traffic import meta_batch

OUTPUTS = ("prediction",)


class Driver(ServeDriver):
    def weights(self) -> Dict[str, torch.Tensor]:
        """The seeded weights with the calibrated running statistics, which
        are computed once and kept for the reference."""
        sd = rn.weights(self.cfg, self.seed, self.device)
        if getattr(self, "_stats", None) is None:
            n = int(self.cell["calibrate"])
            batch = {k: v[:n] for k, v in self.ring[0].items()}
            with torch.no_grad(), tf32_off():
                ref.refine(ref.DeepLab(self.cfg, sd), batch, "calibrate",
                           self.device)
            trained = set(ref.trained_keys(sd))
            self._stats = {k: v.clone() for k, v in sd.items()
                           if k not in trained}
        sd.update(self._stats)
        return sd

    def build(self) -> None:
        from seg2eye_tpu_torch.data.openeds import device_prefetch
        from seg2eye_tpu_torch.refinenet import training

        self.make_ring()
        model, rcfg = rn.port_model(self.cfg, self.cell, self.weights(),
                                    self.device)
        self.trainer = training.Trainer(model, rcfg, "eds_loss",
                                        momentum=self.cfg["momentum"])
        self.state = training.TrainState(model, training.make_optimizer(
            model.net.parameters(), rcfg, self.cfg["momentum"]))
        self.feed = device_prefetch(self.ring.cycle(), self.device,
                                    training.MODEL_KEYS)

    def run(self, i: int) -> Dict:
        _, batch = next(self.feed)
        out = self.trainer.eval_step(self.state, batch)
        return {k: out[k].cpu().numpy() for k in OUTPUTS}

    def release(self) -> None:
        self.trainer = self.state = self.feed = None

    def reference_outputs(self, precision: str, slots) -> List[Dict]:
        net = ref.DeepLab(self.cfg, self.weights(), Products(precision))
        out = []
        with torch.no_grad(), tf32_off():
            for slot in slots:
                got = ref.refine(net, self.ring[slot], "eval", self.device)
                out.append({k: got[k].cpu().numpy() for k in OUTPUTS})
        return out

    def compare_outputs(self, prog, ref_out) -> Dict[str, float]:
        return {"prediction_gap": rms_gap(
            np.concatenate([o["prediction"] for o in prog]),
            np.concatenate([o["prediction"] for o in ref_out]))}

    def model_flops(self) -> float:
        net = ref.DeepLab(self.cfg, make_state(ref.specs(self.cfg), 0, "meta"))
        batch = meta_batch(self.cell)
        return roofline.count_flops(torch.no_grad()(ref.refine), net, batch,
                                    "eval", "meta")
