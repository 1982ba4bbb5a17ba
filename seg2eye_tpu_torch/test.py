"""Seg2Eye evaluation CLI on PyTorch (counterpart of the root ``test.py``).

Same flags as the reference test.py, plus ``--device`` (default ``cuda``):

    python -m seg2eye_tpu_torch.test --dataroot H5 --name CHECKPOINT_NAME \
        --dataset_key validation|train|test [--produce_npy] [--device cuda]

Loads ``{which_epoch}_net_{G,E}.pth`` from ``checkpoints_dir/name``
strictly.  validation/train without --produce_npy -> full-dataset error
(with ``--write_error_log``, the error-log H5 under ``results``);
otherwise per-image uint8 .npy files plus pred_npy_list.txt.  There is no
automatic switch to the CPU: a missing card is an error.

H-band scoring over the GPUs of one job (``--spatial_shard``,
``parallel.spatial``; NCCL, or gloo with ``--device cpu``): every rank
scores every batch, each computing its bands of the maps, and rank 0
writes.  At one process the flag changes nothing:

    torchrun --nproc_per_node N -m seg2eye_tpu_torch.test --dataroot H5 \
        --name CHECKPOINT_NAME --spatial_shard
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from seg2eye_tpu_torch.data.openeds import DataLoader, OpenEDSDataset
from seg2eye_tpu_torch.eval.tester import Tester
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
from seg2eye_tpu_torch.options import parse_options
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.parallel import spatial
from seg2eye_tpu_torch.utils.checkpoint import load_networks


def make_dataloader(opt, dataset_key: str) -> DataLoader:
    """Serial batches of the H5 split ``dataset_key`` (the port's own
    evaluation loader; it needs h5py, cv2 and PIL)."""
    return DataLoader(OpenEDSDataset(opt, dataset_key=dataset_key),
                      batch_size=opt.batchSize, seed=opt.seed)


def main(argv=None) -> dict | str:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    device = dp.init_from_env(device)
    opt = parse_options(rest, is_train=False)
    nets = load_networks(build_networks(opt), opt, opt.which_epoch)
    print(f"loaded '{opt.which_epoch}' checkpoint from {opt.expr_dir}")
    model = Pix2Pix(opt, nets, device)
    tester_opt = opt.replace(serial_batches=True, no_flip=True)
    bands = (spatial.Bands() if opt.spatial_shard and dist.is_initialized()
             and dist.get_world_size() > 1 else None)
    tester = Tester(opt, dataset_key=opt.dataset_key,
                    dataloader=make_dataloader(tester_opt, opt.dataset_key),
                    bands=bands)
    limit = -1 if opt.how_many == float("inf") else int(opt.how_many)
    # every rank scores the same batches: nothing is data parallel here
    with dp.local():
        if opt.dataset_key in ("validation", "train") and not opt.produce_npy:
            return tester.run(model, mode="full", limit=limit,
                              write_error_log=opt.write_error_log)
        print("Running inference")
        return tester.run_test(model, limit=limit)


if __name__ == "__main__":
    main()
