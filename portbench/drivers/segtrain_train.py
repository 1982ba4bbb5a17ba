"""segtrain training: ``seg2eye_tpu_torch.segtrain.trainer.SegTrainer.
train_step`` (forward with batch statistics and dropout, the CE loss with
255 ignored, its backward, SGD with momentum and weight decay, ASPP and
decoder at 10 lr) on the trainer the CLI builds, ``SegTrainer(args,
loaders=...)``, holding the benchmark's seeded weights (``strict=True``),
fed by ``data.openeds.device_prefetch`` from the ring.  The ring's labels
take ``void_label`` as 255; each step normalises its uint8 images on the
card as the VOC loader's Normalize does.  Step i's dropout comes from a
generator seeded from (seed, i), handed to both sides.

The trainer's run directory (the Saver's ``run/``) goes to a temporary
folder under ``build/portbench_cache/``, removed on release.  Importing
this module adds its faults (``unchanged``, ``half``) to ``portbench.
faults``, which ``calibrate.py`` plants by the cell's driver name.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict

import torch

from portbench import faults, roofline
from portbench.driver import CHECKED_STEPS, TrainDriver, norms
from portbench.reference import xception as ref
from portbench.reference.common import (Products, make_state, seed_of,
                                        tf32_off)
from portbench.traffic import meta_batch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKDIR = os.path.join(ROOT, "build", "portbench_cache")


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_state(ref.specs(cfg), seed, device, "weights/net")


def trainer_args(cfg: Dict, cell: Dict, device):
    """The CLI's arguments for the configuration at the cell's batch and
    dtype."""
    from seg2eye_tpu_torch.segtrain.trainer import (build_argparser,
                                                    finalize_args)

    sizes = cell["sizes"]
    if sizes["height"] != sizes["width"]:
        raise ValueError("segtrain crops are square")
    argv = ["--backbone", cfg["backbone"],
            "--out-stride", str(cfg["output_stride"]),
            "--dataset", cfg["dataset"],
            "--crop-size", str(sizes["height"]),
            "--batch-size", str(sizes["batch"]),
            "--lr", str(cfg["lr"]), "--lr-scheduler", cfg["lr_scheduler"],
            "--momentum", str(cfg["momentum"]),
            "--weight-decay", str(cfg["weight_decay"]),
            "--precision", cell["dtype"]]
    if cfg["nesterov"]:
        argv.append("--nesterov")
    if torch.device(device).type == "cpu":
        argv.append("--no-cuda")
    return finalize_args(build_argparser().parse_args(argv))


@contextlib.contextmanager
def _inside(path: str):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


class Driver(TrainDriver):
    def dropout(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, f"dropout/{i}"))

    def make_ring(self) -> None:
        super().make_ring()
        for batch in self.ring.batches:          # views of the ring's slots
            label = batch["label"]
            label[label == self.cell["void_label"]] = ref.IGNORE

    def build(self) -> None:
        from seg2eye_tpu_torch.data.openeds import device_prefetch
        from seg2eye_tpu_torch.segtrain.trainer import (BATCH_KEYS,
                                                        HEAD_LR_SCALE,
                                                        SegTrainer)

        if self.cfg["head_lr_scale"] != HEAD_LR_SCALE:
            raise ValueError(f"the trainer runs ASPP and decoder at "
                             f"{HEAD_LR_SCALE} lr")
        self.make_ring()
        args = trainer_args(self.cfg, self.cell, self.device)
        os.makedirs(WORKDIR, exist_ok=True)
        self.workdir = tempfile.TemporaryDirectory(prefix="segtrain-",
                                                   dir=WORKDIR)
        with _inside(self.workdir.name):
            self.trainer = SegTrainer(args, loaders=(
                self.ring, None, None, self.cfg["num_classes"]))
        self.trainer.net.load_state_dict(
            weights(self.cfg, self.seed, self.device), strict=True)
        self.lr = self.trainer.scheduler(0, 0)
        self.feed = device_prefetch(self.ring.cycle(), self.device,
                                    BATCH_KEYS)

    def step(self, i: int):
        _, batch = next(self.feed)
        loss, _ = self.trainer.train_step(ref.normalize(batch["image"]),
                                          batch["label"], self.lr,
                                          self.dropout(i))
        return loss

    def loss_values(self, out) -> Dict[str, float]:
        return {"ce_loss": float(out)}

    def named_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.trainer.net.named_parameters())

    def named_buffers(self) -> Dict[str, torch.Tensor]:
        return dict(self.trainer.net.named_buffers())

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """SGD's momentum buffer after one step is the gradient plus
        weight_decay times the initial weight."""
        opt = self.trainer.optimizer
        p0 = self.initial_params()
        out = {}
        for k, p in self.named_params().items():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[k] = buf - self.cfg["weight_decay"] * p0[k]
        return out

    def initial_params(self) -> Dict[str, torch.Tensor]:
        sd = weights(self.cfg, self.seed, self.device)
        return {k: sd[k] for k in ref.trained_keys(sd)}

    def release(self) -> None:
        self.trainer.writer.close()
        self.workdir.cleanup()
        self.trainer = self.feed = None

    def reference_readings(self, precision: str) -> Dict:
        sd = weights(self.cfg, self.seed, self.device)
        keys = ref.trained_keys(sd)
        p0 = {k: sd[k].clone() for k in keys}
        trainer = ref.Trainer(self.cfg, sd, Products(precision))
        losses = []
        with tf32_off():
            for i in range(CHECKED_STEPS):
                loss, grads = trainer.step(self.ring[i], self.device,
                                           self.dropout(i))
                losses.append({"ce_loss": float(loss)})
                if i == 0:
                    grad1 = norms(grads)
                del grads
        return {"losses": losses, "grad1": grad1,
                "change": norms({k: sd[k] - p0[k] for k in keys}),
                "buffers": {k: v for k, v in sd.items() if k not in p0}}

    def model_flops(self) -> float:
        trainer = ref.Trainer(self.cfg, make_state(ref.specs(self.cfg), 0,
                                                   "meta"))
        # dropout's masks cost no products: counted without them
        return roofline.count_flops(trainer.step, meta_batch(self.cell),
                                    "meta", None)


# ---- faults in the timed path (``portbench.faults``' two training faults)
def _plant(fault: str):
    from seg2eye_tpu_torch.segtrain import trainer

    def make(real):
        def step(self, image, target, lr, generator=None):
            if fault == "half":
                n = image.shape[0] // 2
                return real(self, image[:n], target[:n], lr, generator)
            saved = {k: v.clone() for k, v in self.net.state_dict().items()}
            out = real(self, image, target, lr, generator)
            self.net.load_state_dict(saved)
            return out
        return step
    return faults._patched(trainer.SegTrainer, "train_step", make)


faults.FAULTS.setdefault("segtrain_train", ("unchanged", "half"))
faults.PATCHERS.setdefault("segtrain_train", _plant)
