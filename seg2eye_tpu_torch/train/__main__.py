"""Seg2Eye training CLI on PyTorch (counterpart of the root ``train.py``).

Same flags as the reference train.py, plus ``--device`` (default
``cuda``):

    python -m seg2eye_tpu_torch.train --dataroot H5 --name EXPERIMENT \
        [--batchSize 16] [--compute_dtype bfloat16|float32] [--device cuda]

Options are saved to ``checkpoints_dir/name`` (opt.txt, opt.pkl), then
``train.loop.train`` runs.  There is no automatic switch to the CPU: a
missing card is an error.  Data parallelism, one process per GPU, global
``--batchSize`` (NCCL; with ``--device cpu``, gloo):

    torchrun --nproc_per_node N -m seg2eye_tpu_torch.train --dataroot H5 \
        --name EXPERIMENT --batchSize 16
"""
from __future__ import annotations

import argparse

from seg2eye_tpu_torch.options import parse_options
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.train.loop import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    device = dp.init_from_env(ns.device)
    return train(parse_options(rest, is_train=True, save=dp.is_primary()),
                 device=device)


if __name__ == "__main__":
    main()
