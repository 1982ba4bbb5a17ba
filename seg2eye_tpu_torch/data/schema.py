"""OpenEDS H5 schema + synthetic fixture writers (the port's copy of
``seg2eye_tpu/data/schema.py``).

Schema (reference: data/prepare_openeds.py:77-138, data/openeds_dataset.py:44-66):

    <file.h5>
      train/ | validation/ | test/
        <user_id>/                       e.g. "U111"
          images_ss             (N, 640, 400) uint8   labeled images
          labels_ss             (N, 640, 400) uint8   4-class masks
          images_ss_filenames   (N,) S13
          images_gen            (M, 640, 400) uint8   unlabeled (generative)
          images_gen_filenames  (M,) S13
          images_seq            (K, 640, 400) uint8   sequence frames
          images_seq_filenames  (K,) S13
        -- test split instead has: images_ss, labels_gen, labels_gen_filenames,
           images_seq (openeds_dataset.py:46-48)

Style-ref ranking file (openeds_dataset.py:150-209):

    <style_ref.h5>
      <dataset_key>/<user>/<filename>/index   (R,) int     similarity ranking
      <dataset_key>/<user>/<filename>/subset  (R,) S1      b'g' | b's' (optional)

The synthetic writers emit schema-complete tiny files for tests, the same
bytes as the JAX package's for the same arguments.  ``h5py`` and ``PIL``
are imported inside the writers (the card's machine has neither).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

NATIVE_H, NATIVE_W = 640, 400  # OpenEDS native resolution (SURVEY.md §0)
TRAIN_KEYS = ("images_ss", "labels_ss", "images_ss_filenames",
              "images_gen", "images_gen_filenames",
              "images_seq", "images_seq_filenames")
TEST_KEYS = ("images_ss", "labels_gen", "labels_gen_filenames", "images_seq")


def split_keys(dataset_key: str) -> Dict[str, str]:
    """Split-dependent dataset names (openeds_dataset.py:44-48)."""
    if dataset_key == "test":
        return {"style_images": "images_ss", "labels": "labels_gen",
                "filenames": "labels_gen_filenames"}
    return {"style_images": "images_gen", "labels": "labels_ss",
            "filenames": "images_ss_filenames"}


def _blob_masks(rng, n, h, w):
    """Smooth blobby 4-class masks (concentric ellipses like an eye)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        cy = h / 2 + rng.uniform(-h / 6, h / 6)
        cx = w / 2 + rng.uniform(-w / 6, w / 6)
        r = min(h, w) * rng.uniform(0.2, 0.35)
        d = np.sqrt(((yy - cy) / 1.3) ** 2 + (xx - cx) ** 2)
        m = np.zeros((h, w), np.uint8)
        m[d < r] = 1
        m[d < r * 0.6] = 2
        m[d < r * 0.25] = 3
        out[i] = m
    return out


def _render(masks, rng):
    """Deterministic mask->image rendering (learnable target function):
    class mean intensity + smooth illumination gradient."""
    means = np.array([125, 103, 76, 34], np.float32)
    n, h, w = masks.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    illum = 30.0 * (xx / w - 0.5) + 20.0 * (yy / h - 0.5)
    img = means[masks.astype(np.int64)] + illum[None]
    return np.clip(img, 0, 255).astype(np.uint8)


def write_synthetic_h5(path: str, users: Sequence[str] = ("U001", "U002"),
                       n_ss: int = 3, n_gen: int = 4, n_seq: int = 2,
                       h: int = NATIVE_H, w: int = NATIVE_W,
                       splits: Sequence[str] = ("train", "validation", "test"),
                       seed: int = 0, learnable: bool = False) -> str:
    """Write a tiny schema-complete OpenEDS H5 fixture.  With
    ``learnable=True``, images are a deterministic rendering of blobby masks
    (for convergence smoke tests) instead of uniform noise."""
    import h5py

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for split in splits:
            for user in users:
                g = f.create_group(f"{split}/{user}")

                if learnable:
                    def masks(n):
                        return _blob_masks(rng, n, h, w)

                    def imgs(n):
                        return _render(_blob_masks(rng, n, h, w), rng)
                else:
                    def imgs(n):
                        return rng.integers(0, 256, (n, h, w), dtype=np.uint8)

                    def masks(n):
                        return rng.integers(0, 4, (n, h, w)).astype(np.uint8)

                def names(n, prefix):
                    return np.array([f"{prefix}{user}_{i:06d}.png".encode()
                                     for i in range(n)], dtype="S13")

                # the real builder writes <name>_filenames for EVERY dataset
                # (prepare_openeds.py:54-73); labels share the image ids
                if split == "test":
                    g.create_dataset("images_ss", data=imgs(n_gen))
                    g.create_dataset("images_ss_filenames",
                                     data=names(n_gen, "i"))
                    g.create_dataset("labels_gen", data=masks(n_ss))
                    g.create_dataset("labels_gen_filenames",
                                     data=names(n_ss, "t"))
                    g.create_dataset("images_seq", data=imgs(n_seq))
                    g.create_dataset("images_seq_filenames",
                                     data=names(n_seq, "s"))
                else:
                    nm = names(n_ss, "i")
                    lab = masks(n_ss)
                    # learnable mode: the image IS the rendering of the mask
                    im = _render(lab, rng) if learnable else imgs(n_ss)
                    g.create_dataset("images_ss", data=im)
                    g.create_dataset("labels_ss", data=lab)
                    g.create_dataset("images_ss_filenames", data=nm)
                    g.create_dataset("labels_ss_filenames", data=nm)
                    g.create_dataset("images_gen", data=imgs(n_gen))
                    g.create_dataset("images_gen_filenames",
                                     data=names(n_gen, "g"))
                    g.create_dataset("images_seq", data=imgs(n_seq))
                    g.create_dataset("images_seq_filenames",
                                     data=names(n_seq, "s"))
    return path


def write_synthetic_raw_tree(root: str,
                             users: Sequence[str] = ("U001", "U002"),
                             n_ss: int = 3, n_gen: int = 4, n_seq: int = 2,
                             h: int = NATIVE_H, w: int = NATIVE_W,
                             seed: int = 0, learnable: bool = False) -> str:
    """Write a tiny *raw* (pre-packing) OpenEDS folder tree — the form the
    challenge distributed and ``prepare_openeds.py`` consumes (reference:
    data/prepare_openeds.py:20-52): per-split Semantic_Segmentation_Dataset
    (images/ + labels/), Generative_Dataset, Sequence_Dataset folders plus
    the OpenEDS_<split>_userID_mapping_to_images.json files.  With
    ``learnable=True`` labeled images are the deterministic rendering of
    their masks (same target function as write_synthetic_h5)."""
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)

    def write_png(folder, fid, arr):
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(folder, fid))

    for split in ("train", "validation", "test"):
        mapping = []
        for user in users:
            ss_ids = [f"{user}_ss_{i:04d}.png" for i in range(n_ss)]
            gen_ids = [f"{user}_g_{i:05d}.png" for i in range(n_gen)]
            seq_ids = [f"{user}_s_{i:05d}.png" for i in range(n_seq)]
            mapping.append({"id": user,
                            "semantic_segmenation_images": ss_ids,
                            "generative_images": gen_ids,
                            "sequence_images": seq_ids})
            ss_dir = os.path.join(root, "Semantic_Segmentation_Dataset",
                                  split)
            lab = _blob_masks(rng, n_ss, h, w)
            im = _render(lab, rng) if learnable else \
                rng.integers(0, 256, (n_ss, h, w), dtype=np.uint8)
            for i, fid in enumerate(ss_ids):
                write_png(os.path.join(ss_dir, "images"), fid, im[i])
                os.makedirs(os.path.join(ss_dir, "labels"), exist_ok=True)
                np.save(os.path.join(ss_dir, "labels", fid[:-4] + ".npy"),
                        lab[i])
            gen_dir = os.path.join(root, "Generative_Dataset", split)
            gen_lab = _blob_masks(rng, n_gen, h, w)
            gen_im = _render(gen_lab, rng) if learnable else \
                rng.integers(0, 256, (n_gen, h, w), dtype=np.uint8)
            for i, fid in enumerate(gen_ids):
                write_png(gen_dir, fid, gen_im[i])
                if split == "test":
                    os.makedirs(os.path.join(gen_dir, "labels"),
                                exist_ok=True)
                    np.save(os.path.join(gen_dir, "labels",
                                         fid[:-4] + ".npy"), gen_lab[i])
            seq_dir = os.path.join(root, "Sequence_Dataset", split)
            seq_lab = _blob_masks(rng, n_seq, h, w)
            seq_im = _render(seq_lab, rng) if learnable else \
                rng.integers(0, 256, (n_seq, h, w), dtype=np.uint8)
            for i, fid in enumerate(seq_ids):
                write_png(seq_dir, fid, seq_im[i])
        with open(os.path.join(
                root, f"OpenEDS_{split}_userID_mapping_to_images.json"),
                "w") as f:
            json.dump(mapping, f)
    return root


def write_synthetic_style_ref(path: str, data_path: str,
                              use_subsets: bool = False, seed: int = 0) -> str:
    """Similarity-ranking fixture joined against a data H5 (the structure the
    reference documents at options/base_options.py:54-57)."""
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(data_path, "r") as data, h5py.File(path, "w") as ref:
        for split in data.keys():
            keys = split_keys(split)
            for user in data[split].keys():
                grp = data[split][user]
                n_style = grp[keys["style_images"]].shape[0]
                n_seq = grp["images_seq"].shape[0] if "images_seq" in grp else 0
                for raw in grp[keys["filenames"]][:]:
                    fname = raw.decode("utf-8").replace(".", "")
                    g = ref.create_group(f"{split}/{user}/{fname}")
                    total = n_style + (n_seq if use_subsets else 0)
                    order = rng.permutation(total)
                    if use_subsets:
                        subset = np.array(
                            [b"g" if i < n_style else b"s" for i in order])
                        # seq indices are offset by n_style in the ranking
                        # (openeds_dataset.py:195-199)
                        g.create_dataset("subset", data=subset)
                    g.create_dataset("index", data=order.astype(np.int64))
    return path
