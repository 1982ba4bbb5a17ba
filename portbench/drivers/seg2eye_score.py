"""Seg2Eye scored inference: ``seg2eye_tpu_torch.eval.tester.Tester.
score_batch`` (encode, generate with batch statistics, resize to the
native 640x400, truncate, per-image OpenEDS errors), host batches in, the
errors and the fakes back on the host."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import roofline
from portbench.driver import ServeDriver, rms_gap
from portbench.drivers import _seg2eye as s2e
from portbench.reference import seg2eye as ref
from portbench.reference.common import Products, make_state, tf32_off
from portbench.traffic import meta_batch


class Driver(ServeDriver):
    def build(self) -> None:
        from seg2eye_tpu_torch.eval.tester import Tester
        from seg2eye_tpu_torch.models.pix2pix import Pix2Pix

        opt = s2e.options(self.cfg, self.cell, train=False)
        nets = s2e.port_nets(opt, s2e.weights(self.cfg, self.seed,
                                              self.device, False), self.device)
        self.model = Pix2Pix(opt, nets, self.device)
        self.tester = Tester(opt)
        self.make_ring()

    def run(self, i: int) -> Dict:
        errors, fake = self.tester.score_batch(self.model, self.ring[i])
        return {"fake": fake, "errors": errors}

    def release(self) -> None:
        self.model = self.tester = None

    def reference_outputs(self, precision: str, slots) -> List[Dict]:
        nets = ref.Nets(self.cfg, s2e.weights(self.cfg, self.seed,
                                              self.device, False),
                        Products(precision))
        native = tuple(self.cell["sizes"][k]
                       for k in ("native_height", "native_width"))
        out = []
        with tf32_off():
            for slot in slots:
                fake, errors = ref.score(nets, self.ring[slot], self.device,
                                         native)
                out.append({"fake": fake.cpu().numpy(),
                            "errors": errors.cpu().numpy()})
        return out

    def compare_outputs(self, prog, ref_out) -> Dict[str, float]:
        fake_p = np.concatenate([o["fake"] for o in prog])
        fake_r = np.concatenate([o["fake"] for o in ref_out])
        err_p = np.concatenate([o["errors"] for o in prog]).astype(np.float64)
        err_r = np.concatenate([o["errors"] for o in ref_out]).astype(
            np.float64)
        return {"fake_gap": rms_gap(fake_p, fake_r),
                "error_gap": float(np.max(np.abs(err_p - err_r))
                                   / np.mean(err_r))}

    def model_flops(self) -> float:
        sd = {n: make_state(s, 0, "meta")
              for n, s in ref.specs(self.cfg, False).items()}
        nets = ref.Nets(self.cfg, sd)
        batch = meta_batch(self.cell)

        def forward():
            seg, style, _ = ref.preprocess(self.cfg, batch, "meta")
            w, _ = nets.encode_w(style, False)
            return nets.generate(seg, w, False)

        return roofline.count_flops(torch.no_grad()(forward))
