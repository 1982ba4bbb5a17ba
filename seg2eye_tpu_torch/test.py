"""Seg2Eye evaluation CLI on PyTorch (counterpart of the root ``test.py``).

Same flags as the reference test.py, plus ``--device`` (default ``cuda``):

    python -m seg2eye_tpu_torch.test --dataroot H5 --name CHECKPOINT_NAME \
        --dataset_key validation|train|test [--produce_npy] [--device cuda]

Loads ``{which_epoch}_net_{G,E}.pth`` from ``checkpoints_dir/name``
strictly.  validation/train without --produce_npy -> full-dataset error;
otherwise per-image uint8 .npy files plus pred_npy_list.txt.  There is no
automatic switch to the CPU: a missing card is an error.
"""
from __future__ import annotations

import argparse

import torch

from seg2eye_tpu_torch.data.openeds import DataLoader, OpenEDSDataset
from seg2eye_tpu_torch.eval.tester import Tester
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
from seg2eye_tpu_torch.options import parse_options
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
    opt = parse_options(rest, is_train=False)
    nets = load_networks(build_networks(opt), opt, opt.which_epoch)
    print(f"loaded '{opt.which_epoch}' checkpoint from {opt.expr_dir}")
    model = Pix2Pix(opt, nets, device)
    tester_opt = opt.replace(serial_batches=True, no_flip=True)
    tester = Tester(opt, dataset_key=opt.dataset_key,
                    dataloader=make_dataloader(tester_opt, opt.dataset_key))
    limit = -1 if opt.how_many == float("inf") else int(opt.how_many)
    if opt.dataset_key in ("validation", "train") and not opt.produce_npy:
        return tester.run(model, mode="full", limit=limit)
    print("Running inference")
    return tester.run_test(model, limit=limit)


if __name__ == "__main__":
    main()
