"""Scored evaluation (counterpart of ``seg2eye_tpu/eval/tester.py``).

  * ``score_batch``: inference -> bilinear resize to the native 640x400 ->
    truncating [0,255] conversion -> per-image OpenEDS error, on the device;
    only the error vector (and, when asked, the fake) comes back.
  * ``run(mode=full|rand|fix)``: the reference's index selection, the
    ``counter > limit`` break, "Error so far" prints, and the relative
    (x1471) error statistics; ``run_partial_modes``, the training loop's
    periodic check (mode 'rand', as the JAX package runs it).
  * ``run_test``: one uint8 .npy per image plus ``pred_npy_list.txt``.

The dataloader is passed in (the CLI builds it from the H5 file), so that
scoring tensors already in memory needs no H5 stack.  The error-log H5 and
the visualiser are not ported yet.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from seg2eye_tpu_torch.ops import metrics
from seg2eye_tpu_torch.ops.image import to_255resized

NATIVE_HW = (640, 400)      # OpenEDS native resolution (H, W)


class Tester:
    def __init__(self, opt, dataset_key: str = "test", dataloader=None):
        self.opt = opt.replace(serial_batches=True, no_flip=True,
                               isTrain=False, dataset_key=dataset_key)
        self.dataloader = dataloader
        self.results_dir = os.path.join(
            opt.checkpoints_dir, opt.name, self.opt.results_dir, dataset_key)
        self._rng = np.random.default_rng(self.opt.seed)

    @property
    def N(self) -> int:
        return self.dataloader.dataset.N

    @staticmethod
    def _native_hw(batch: Dict):
        """Score at the native size of ``target_original`` (640x400 for
        OpenEDS), so synthetic fixtures score at their own size."""
        if "target_original" in batch:
            return tuple(batch["target_original"].shape[1:3])
        return NATIVE_HW

    @torch.no_grad()
    def infer_batch(self, model, batch: Dict):
        """-> (fake (B,H,W,1) float32, fake resized to native and truncated
        to [0,255]), both on the device."""
        fake = model.inference(batch)
        h, w = self._native_hw(batch)
        return fake, to_255resized(fake, w=w, h=h)

    @torch.no_grad()
    def score_batch(self, model, batch: Dict, need_fake: bool = True):
        """-> (per-image errors as numpy, fake as numpy or None)."""
        fake, fake_resized = self.infer_batch(model, batch)
        target = torch.as_tensor(batch["target_original"]).to(
            device=fake.device, dtype=torch.float32)
        errors = metrics.mse_for_images(fake_resized, target)
        return (errors.cpu().numpy(),
                fake.cpu().numpy() if need_fake else None)

    # ------------------------------------------------------------------ #
    def _iterator(self, indices: Optional[List[int]]):
        if indices is None:
            yield from self.dataloader
        else:
            for i in indices:
                yield self.dataloader.get_particular(int(i))

    def _validation_indices(self, mode: str, limit: int):
        if "rand" in mode:
            return self.dataloader.dataset.get_random_indices(limit, self._rng)
        if "fix" in mode:
            return self.dataloader.dataset.get_validation_indices()[:limit]
        if "full" in mode:
            return None
        raise ValueError(f"Invalid mode: {mode}")

    def run_validation(self, model, batches, limit: int = -1) -> List[float]:
        all_errors: List[float] = []
        counter = 0
        for i, batch in enumerate(batches):
            counter += batch["label"].shape[0]
            if limit > 0 and counter > limit:
                break
            if i % 10 == 9:
                print(f"Processing batch {i}")
                print(f"Error so far: "
                      f"{np.sum(all_errors) / max(len(all_errors), 1) * metrics.RELATIVE_FACTOR}")
            errors, _ = self.score_batch(model, batch, need_fake=False)
            all_errors += list(errors)
        return all_errors

    def run(self, model, mode: str, epoch=None, n_steps=None,
            limit: int = -1) -> Dict:
        print(f"Running validation for mode '{mode}'...")
        limit = limit if limit > 0 else self.N
        indices = self._validation_indices(mode, limit)
        all_errors = self.run_validation(model, self._iterator(indices),
                                         limit=limit)
        errors_dict = metrics.error_statistics(
            all_errors, mode=mode, dataset_key=self.opt.dataset_key)
        self.print_results(all_errors, errors_dict, epoch, n_steps)
        return errors_dict

    def run_partial_modes(self, model, epoch, n_steps,
                          limit: int) -> Dict[str, Dict]:
        """The training loop's periodic check: ``run`` in mode 'rand' on at
        most ``limit`` samples (the JAX package runs no other mode there;
        ``run(mode='fix')`` is the fixed-index one)."""
        return {"rand": self.run(model, mode="rand", epoch=epoch,
                                 n_steps=n_steps, limit=limit)}

    def print_results(self, all_errors, errors_dict, epoch="n.a.",
                      n_steps="n.a."):
        print("Validation Results")
        print("------------------")
        print(f"Error calculated on {len(all_errors)} / {self.N} samples")
        for k in sorted(errors_dict):
            print(f"  {k}, {errors_dict[k]:.2f}")
        print(f"  dataset_key: {self.opt.dataset_key}, "
              f"model: {self.opt.name}, epoch: {epoch}, n_steps: {n_steps}")

    # ------------------------------------------------------------------ #
    def run_test(self, model, limit: int = -1) -> str:
        os.makedirs(self.results_dir, exist_ok=True)
        filepaths = []
        bs = self.opt.batchSize
        for i, batch in enumerate(self.dataloader):
            if limit > 0 and i * bs >= limit:
                break
            if i % 10 == 0:
                print(f"Processing batch {i} (processed {bs * i} images)")
            names = [re.sub(r"\.", "", f) for f in batch["filename"]]
            _, fake_resized = self.infer_batch(model, batch)
            fake_resized = fake_resized.cpu().numpy()
            for b, name in enumerate(names):
                arr = fake_resized[b]
                if arr.min() < 0 or arr.max() > 255:
                    raise ValueError(f"{name}: values outside [0, 255]")
                path = os.path.join(self.results_dir, name + ".npy")
                np.save(path, arr.astype(np.uint8)[..., 0])
                filepaths.append(path)
        manifest = os.path.join(self.results_dir, "pred_npy_list.txt")
        with open(manifest, "w") as f:
            for line in filepaths:
                f.write(line + os.linesep)
        print(f"Written {len(filepaths)} files. Filepath: {manifest}")
        return manifest
