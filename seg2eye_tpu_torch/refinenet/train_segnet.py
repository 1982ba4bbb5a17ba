"""Train the 4-class eye SegNet on PyTorch (counterpart of
``refinenet/train_segnet.py``; reference: refinenet/train_segnet.py).

    python -m seg2eye_tpu_torch.refinenet.train_segnet \
        [refinenet/configs/segnet.json ...] --dataroot DATA.h5 [--device cuda]

The flags and JSON overlays of ``RefineNetConfig``, plus ``--device``
(default ``cuda``; a missing card is an error).  Data parallelism:
``torchrun --nproc_per_node N -m`` this module with the same flags;
``batch_size`` is the global batch.  Momentum 0.9.
"""
from __future__ import annotations

import logging

from seg2eye_tpu_torch.data.openeds import DataLoader, subsample
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.model import SegNetModel
from seg2eye_tpu_torch.refinenet.segnet_dataset import SegNetDataset
from seg2eye_tpu_torch.refinenet.training import main_loop, split_device_flag


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    device, rest = split_device_flag(argv)
    device = dp.init_from_env(device)
    cfg = RefineNetConfig.from_args(rest)
    train_loader = DataLoader(SegNetDataset(cfg, "train"),
                              batch_size=cfg.batch_size, shuffle=True,
                              drop_last=True, seed=cfg.seed,
                              prefetch=cfg.prefetch)
    test_data = {
        "val": DataLoader(subsample(SegNetDataset(cfg, "validation"),
                                    cfg.test_num_samples, cfg.seed),
                          batch_size=cfg.test_batch_size,
                          prefetch=cfg.prefetch),
    }
    # momentum 0.9 (train_segnet.py:139), not RefineNet's 0.99
    result = main_loop(SegNetModel(cfg, device), cfg, train_loader,
                       test_data, loss_key="ce_loss", model_name="MyDeepLab",
                       momentum=0.9)
    print("output_dir:", result["output_dir"])
    return result


if __name__ == "__main__":
    main()
