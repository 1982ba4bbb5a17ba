"""Seg2Eye training CLI on PyTorch (counterpart of the root ``train.py``).

Same flags as the reference train.py, plus ``--device`` (default
``cuda``):

    python -m seg2eye_tpu_torch.train --dataroot H5 --name EXPERIMENT \
        [--batchSize 16] [--compute_dtype bfloat16|float32] [--device cuda]

Options are saved to ``checkpoints_dir/name`` (opt.txt, opt.pkl), then
``train.loop.train`` runs.  There is no automatic switch to the CPU: a
missing card is an error.
"""
from __future__ import annotations

import argparse

from seg2eye_tpu_torch.options import parse_options
from seg2eye_tpu_torch.train.loop import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    return train(parse_options(rest, is_train=True), device=ns.device)


if __name__ == "__main__":
    main()
