"""Train the RefineNet residual refiner on PyTorch (counterpart of
``refinenet/train_refinenet.py``; reference: refinenet/train_refinenet.py).

    python -m seg2eye_tpu_torch.refinenet.train_refinenet \
        [refinenet/configs/refinenet.json ...] --dataroot DATA.h5 \
        --distances_and_indices DIST.h5 --segmentations_train SEGS.h5 \
        --segmentations_generative SEGS_GEN.h5 \
        --segmentations_sequence SEGS_SEQ.h5 [--device cuda]

The flags and JSON overlays of ``RefineNetConfig``, plus ``--device``
(default ``cuda``; a missing card is an error).  Data parallelism:
``torchrun --nproc_per_node N -m`` this module with the same flags;
``batch_size`` is the global batch.  The periodic tests run on
the validation split subsampled to ``test_num_samples``, with a random and
with the top-1 neighbour.
"""
from __future__ import annotations

import logging

from seg2eye_tpu_torch.data.openeds import DataLoader, subsample
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.dataset import RefineNetDataset
from seg2eye_tpu_torch.refinenet.model import RefineNetModel
from seg2eye_tpu_torch.refinenet.training import main_loop, split_device_flag


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    device, rest = split_device_flag(argv)
    device = dp.init_from_env(device)
    cfg = RefineNetConfig.from_args(rest)
    train_loader = DataLoader(RefineNetDataset(cfg, "train"),
                              batch_size=cfg.batch_size, shuffle=True,
                              drop_last=True, seed=cfg.seed,
                              prefetch=cfg.prefetch)
    test_data = {
        tag: DataLoader(subsample(RefineNetDataset(cfg, "validation",
                                                   pick1=pick1),
                                  cfg.test_num_samples, cfg.seed),
                        batch_size=cfg.test_batch_size,
                        prefetch=cfg.prefetch)
        for tag, pick1 in (("val", False), ("val/pick1", True))}
    result = main_loop(RefineNetModel(cfg, device), cfg, train_loader,
                       test_data, loss_key="eds_loss", model_name="RefineNet")
    print("output_dir:", result["output_dir"])
    return result


if __name__ == "__main__":
    main()
