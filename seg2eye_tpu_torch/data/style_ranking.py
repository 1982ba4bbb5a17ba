"""The nearest-neighbour style-ranking H5 that ``--style_ref`` and
RefineNet's ``distances_and_indices`` read (counterpart of
``tools/build_style_ranking.py``).

For every labelled target image the same user's unlabelled images (the
generative subset, then the sequence subset) are ranked by the distance of
their segmentation masks: each mask is colorized (class -> the floor of the
class's mean intensity), nearest-resized to 64x64, and the distance is the
mean squared difference over the 4096 pixels.

The candidates of a user are colorized and downsampled once, and all of
its targets are compared with them in one batch.  The codes are int16, and
so is each squared difference (at most 91**2); they are summed in int32,
which is exact (at most 4096 * 91**2 < 2**31), and the sum is divided by
4096 in float32.  Where the sum is below 2**24 the JAX tool's
float32 mean is exact too, so the distances are the same bits and a stable
sort gives the same order, ties included.

Output, as the JAX tool writes it::

    <out.h5>/<split>/<user>/<target filename>/index     (R,) int64
    <out.h5>/<split>/<user>/<target filename>/subset    (R,) S1 b'g'|b's'
    <out.h5>/<split>/<user>/<target filename>/distance  (R,) float32

with sequence indices offset by the user's generative count, and target
names from ``labels_*_filenames`` with their dots removed.

    python tools/build_style_ranking_torch.py --dataroot data.h5 \\
        --segmentations_generative segs_gen.h5 \\
        --segmentations_sequence segs_seq.h5 \\
        --out distances_and_indices.h5 [--splits train,validation] \\
        [--top_k 100] [--device cuda|cpu]

``h5py`` is imported inside ``main``.
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from seg2eye_tpu_torch.data.schema import split_keys
from seg2eye_tpu_torch.ops.image import resize_nearest

# the class means of refinenet/dataset.py:61-71, truncated as its uint8 cast
CLASS_MEANS = (125, 103, 76, 34)
SIDE = 64
# elements of the (targets, candidates, 4096) int16 difference per chunk
CHUNK_ELEMENTS = 1 << 27


def mask_codes(masks: torch.Tensor) -> torch.Tensor:
    """(N,H,W) class-id masks -> (N, 4096) int16: colorized and
    nearest-resized to 64x64 (the resize is a gather, so it is done first,
    on the ids)."""
    small = resize_nearest(masks[..., None], SIDE, SIDE)[..., 0]
    lut = torch.tensor(CLASS_MEANS, dtype=torch.int16, device=masks.device)
    return lut[small.long()].reshape(masks.shape[0], -1)


def code_distances(targets: torch.Tensor, candidates: torch.Tensor
                   ) -> torch.Tensor:
    """(T, 4096) and (N, 4096) int16 codes -> (T, N) float32 mean squared
    differences, the sum exact in int32."""
    t_n, c_n = targets.shape[0], candidates.shape[0]
    step = max(1, CHUNK_ELEMENTS // max(1, c_n * targets.shape[1]))
    sums = torch.empty((t_n, c_n), dtype=torch.int32, device=targets.device)
    for i in range(0, t_n, step):
        diff = candidates[None] - targets[i:i + step, None]
        sums[i:i + step] = diff.mul_(diff).sum(-1, dtype=torch.int32)
    return sums.to(torch.float32) / float(SIDE * SIDE)


def mask_distances(targets: torch.Tensor, candidates: torch.Tensor
                   ) -> torch.Tensor:
    """(T,H,W) and (N,H',W') class-id masks -> (T, N) float32 distances."""
    return code_distances(mask_codes(targets), mask_codes(candidates))


def rank(distances: torch.Tensor) -> torch.Tensor:
    """(T, N) distances -> (T, N) int64 candidate orders, stable (ties keep
    the candidate order)."""
    return torch.sort(distances, dim=1, stable=True).indices


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataroot", required=True)
    p.add_argument("--segmentations_generative", required=True)
    p.add_argument("--segmentations_sequence", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--splits", default="train,validation,test")
    p.add_argument("--top_k", type=int, default=0, help="0 = keep all")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to rank on the CPU)")

    import h5py

    with contextlib.ExitStack() as files:
        data = files.enter_context(h5py.File(a.dataroot, "r"))
        segs_gen = files.enter_context(
            h5py.File(a.segmentations_generative, "r"))
        segs_seq = (files.enter_context(
            h5py.File(a.segmentations_sequence, "r"))
            if a.segmentations_sequence else None)
        out = files.enter_context(h5py.File(a.out, "w"))
        for split in a.splits.split(","):
            if split not in data:
                continue
            keys = split_keys(split)
            for user in data[split].keys():
                grp = data[split][user]
                if split not in segs_gen or user not in segs_gen[split]:
                    continue
                masks = [np.asarray(segs_gen[split][user])]
                n_gen = masks[0].shape[0]
                subsets = [np.full(n_gen, b"g", dtype="S1")]
                if (segs_seq is not None and split in segs_seq
                        and user in segs_seq[split]):
                    masks.append(np.asarray(segs_seq[split][user]))
                    subsets.append(np.full(masks[1].shape[0], b"s",
                                           dtype="S1"))
                # sequence indices follow the generative ones
                subset_all = np.concatenate(subsets)
                index_all = np.arange(subset_all.shape[0], dtype=np.int64)

                labels = np.asarray(grp[keys["labels"]])
                # the names the readers look up: labels_*_filenames,
                # index-aligned with the labels
                fname_key = keys["labels"] + "_filenames"
                fnames = [f.decode("utf-8").replace(".", "")
                          for f in grp[fname_key][:]]
                if len(fnames) != labels.shape[0]:
                    raise ValueError(f"{split}/{user}: {len(fnames)} "
                                     f"{fname_key} for {labels.shape[0]} "
                                     "labels")
                d = mask_distances(
                    torch.from_numpy(labels).to(device),
                    torch.from_numpy(np.concatenate(masks)).to(device))
                orders = rank(d)
                if a.top_k:
                    orders = orders[:, :a.top_k]
                d = torch.gather(d, 1, orders).cpu().numpy()
                orders = orders.cpu().numpy()
                for i, fname in enumerate(fnames):
                    g = out.create_group(f"{split}/{user}/{fname}")
                    g.create_dataset("index", data=index_all[orders[i]])
                    g.create_dataset("subset", data=subset_all[orders[i]])
                    g.create_dataset("distance", data=d[i])
                print(f"{split}/{user}: ranked {len(fnames)} targets over "
                      f"{index_all.shape[0]} candidates")
    print("wrote", a.out)
