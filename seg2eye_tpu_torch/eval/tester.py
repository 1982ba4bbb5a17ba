"""Scored evaluation (counterpart of ``seg2eye_tpu/eval/tester.py``).

  * ``score_batch``: inference -> bilinear resize to the native 640x400 ->
    truncating [0,255] conversion -> per-image OpenEDS error, on the device;
    only the error vector (and, when asked, the fake) comes back.
  * ``run(mode=full|rand|fix)``: the reference's index selection, the
    ``counter > limit`` break, "Error so far" prints, and the relative
    (x1471) error statistics; with ``write_error_log`` the error-log H5
    ``results_dir/error_log_{key}.h5`` (per-sample error, user, filename
    and a (1,380,1000) uint8 side-by-side visualisation; reference
    tester.py:67-90); with ``log`` the statistics go to the visualiser.
  * ``run_partial_modes``: the training loop's periodic check (mode
    'rand', as the JAX package runs it), and with ``visualize_images``
    (``--tf_log``) the side-by-side panels of a few samples to the
    visualiser (``run_visual_validation``).
  * ``run_test``: one uint8 .npy per image plus ``pred_npy_list.txt``.

The dataloader is passed in (the CLI builds it from the H5 file), so that
scoring tensors already in memory needs no H5 stack; h5py is imported only
to write the error log.

With ``bands`` (``parallel.spatial.Bands``, ``--spatial_shard``) every
rank of the bands' group runs the Tester on the same batches: inference
computes H bands of each map and gathers the fake, the resize and the
errors then run whole on every rank, and rank 0 alone writes (the error
log, the .npy files and the manifest).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from seg2eye_tpu_torch.ops import metrics
from seg2eye_tpu_torch.ops.image import to_255resized
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.utils.visualizer import (Visualizer,
                                                visualize_sidebyside)

NATIVE_HW = (640, 400)      # OpenEDS native resolution (H, W)


class Tester:
    def __init__(self, opt, dataset_key: str = "test", dataloader=None,
                 visualizer: Optional[Visualizer] = None, bands=None):
        self.opt = opt.replace(serial_batches=True, no_flip=True,
                               isTrain=False, dataset_key=dataset_key)
        self.dataloader = dataloader
        self.bands = bands
        self.writes = dp.is_primary()
        self._visualizer = visualizer
        self.results_dir = os.path.join(
            opt.checkpoints_dir, opt.name, self.opt.results_dir, dataset_key)
        self._rng = np.random.default_rng(self.opt.seed)

    @property
    def N(self) -> int:
        return self.dataloader.dataset.N

    @property
    def visualizer(self) -> Visualizer:
        """The one given, else one made on first use."""
        if self._visualizer is None:
            self._visualizer = Visualizer(self.opt)
        return self._visualizer

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
        fake = model.inference(batch, bands=self.bands)
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

    def _prepare_error_log(self):
        import h5py

        os.makedirs(self.results_dir, exist_ok=True)
        log = h5py.File(os.path.join(
            self.results_dir, f"error_log_{self.opt.dataset_key}.h5"), "w")
        log.create_dataset("error", shape=(self.N,), dtype=np.float64)
        log.create_dataset("user", shape=(self.N,), dtype="S4")
        log.create_dataset("filename", shape=(self.N,), dtype="S13")
        log.create_dataset("visualisation", shape=(self.N, 1, 380, 1000),
                           dtype=np.uint8)
        return log

    @staticmethod
    def _write_error_log_batch(log, batch, lo: int, fake, errors) -> None:
        """Rows from ``lo``, the count of samples written so far: 'rand'
        and 'fix' iterate one-sample batches, so batch index times
        batchSize would scatter the rows and overrun the datasets."""
        vis = visualize_sidebyside({**batch, "fake": fake},
                                   error_list=errors)
        hi = lo + len(errors)
        log["user"][lo:hi] = np.array(batch["user"], dtype="S4")
        log["filename"][lo:hi] = np.array(batch["filename"], dtype="S13")
        log["error"][lo:hi] = errors
        arr = np.array([np.copy(v) for v in vis.values()])
        log["visualisation"][lo:hi] = ((arr + 1) * 128).clip(
            0, 255).astype(np.uint8)

    def run_validation(self, model, batches, limit: int = -1,
                       write_error_log: bool = False) -> List[float]:
        log = (self._prepare_error_log()
               if write_error_log and self.writes else None)
        all_errors: List[float] = []
        counter = 0
        try:
            for i, batch in enumerate(batches):
                counter += batch["label"].shape[0]
                if limit > 0 and counter > limit:
                    break
                if i % 10 == 9:
                    print(f"Processing batch {i}")
                    print(f"Error so far: "
                          f"{np.sum(all_errors) / max(len(all_errors), 1) * metrics.RELATIVE_FACTOR}")
                errors, fake = self.score_batch(model, batch,
                                                need_fake=log is not None)
                if log is not None:
                    self._write_error_log_batch(log, batch, len(all_errors),
                                                fake, errors)
                all_errors += list(errors)
        finally:
            if log is not None:
                log.close()
        return all_errors

    def run(self, model, mode: str, epoch=None, n_steps=None,
            limit: int = -1, write_error_log: bool = False,
            log: bool = False) -> Dict:
        print(f"Running validation for mode '{mode}'...")
        limit = limit if limit > 0 else self.N
        indices = self._validation_indices(mode, limit)
        all_errors = self.run_validation(model, self._iterator(indices),
                                         limit=limit,
                                         write_error_log=write_error_log)
        errors_dict = metrics.error_statistics(
            all_errors, mode=mode, dataset_key=self.opt.dataset_key)
        self.print_results(all_errors, errors_dict, epoch, n_steps)
        if log and self.writes:
            self.visualizer.print_current_errors(epoch or 0, n_steps or 0,
                                                 errors_dict, t=0)
            self.visualizer.plot_current_errors(errors_dict, n_steps or 0)
        return errors_dict

    def run_partial_modes(self, model, epoch, n_steps, limit: int,
                          log: bool = False,
                          visualize_images: bool = False
                          ) -> Dict[str, Dict]:
        """The training loop's periodic check: ``run`` in mode 'rand' on at
        most ``limit`` samples (the JAX package runs no other mode there;
        ``run(mode='fix')`` is the fixed-index one), then, with
        ``visualize_images``, the panels of 4 samples."""
        out = {"rand": self.run(model, mode="rand", epoch=epoch,
                                n_steps=n_steps, limit=limit, log=log)}
        if visualize_images:
            self.run_visual_validation(model, "rand", epoch, n_steps,
                                       limit=4)
        return out

    def run_visual_validation(self, model, mode: str, epoch, n_steps,
                              limit: int) -> Dict:
        """Side-by-side panels of ``limit`` samples of ``mode`` to the
        visualiser; -> the panels."""
        indices = self._validation_indices(mode, limit)
        results, error_list = [], []
        for idx in (indices if indices is not None else range(limit)):
            batch = self.dataloader.get_particular(int(idx))
            errors, fake = self.score_batch(model, batch)
            batch["fake"] = fake
            results.append(batch)
            error_list.append(errors)
        merged = {k: ([x for r in results for x in r[k]]
                      if isinstance(results[0][k], list)
                      else np.concatenate([r[k] for r in results]))
                  for k in results[0].keys()}
        visuals = visualize_sidebyside(merged,
                                       error_list=np.concatenate(error_list))
        self.visualizer.display_current_results(visuals, epoch, n_steps)
        return visuals

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
        """One uint8 .npy per image and ``pred_npy_list.txt``, written by
        rank 0 alone; -> the manifest's path."""
        if self.writes:
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
                if self.writes:
                    np.save(path, arr.astype(np.uint8)[..., 0])
                filepaths.append(path)
        manifest = os.path.join(self.results_dir, "pred_npy_list.txt")
        if self.writes:
            with open(manifest, "w") as f:
                for line in filepaths:
                    f.write(line + os.linesep)
        print(f"Written {len(filepaths)} files. Filepath: {manifest}")
        return manifest
