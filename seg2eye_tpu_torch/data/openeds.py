"""OpenEDS H5 reader and batcher for evaluation (the port's own trim of
``seg2eye_tpu/data/{schema,transforms,openeds,loader}.py``).

What the evaluation CLI needs, and no more: the split-dependent keys, the
style-reference sampling (random, first, ref_first, ref_randomN) drawn
from the JAX package's per-sample generators, the 'fixed' resize (bicubic
with PIL's antialiasing for images, nearest for masks) and the uint8
transport, in serial batches without flips.  Given the same options and
file, it yields the same batches byte for byte as the JAX package's
``DataLoader`` (tested).  Training-time augmentation is not here.

``h5py``, ``cv2`` and ``PIL`` are imported inside the functions that use
them, so that ``import seg2eye_tpu_torch`` works without them.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np


def split_keys(dataset_key: str) -> Dict[str, str]:
    """Split-dependent dataset names (reference openeds_dataset.py:44-48)."""
    if dataset_key == "test":
        return {"style_images": "images_ss", "labels": "labels_gen",
                "filenames": "labels_gen_filenames"}
    return {"style_images": "images_gen", "labels": "labels_ss",
            "filenames": "images_ss_filenames"}


def resize_fixed(img: np.ndarray, w: int, h: int, is_mask: bool) -> np.ndarray:
    """The 'fixed' resize to (h, w): masks nearest (cv2), images bicubic
    through PIL, which antialiases the 640x400 -> 320x256 downscale as the
    reference's PIL path does."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if is_mask:
        import cv2
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC))


class OpenEDSDataset:
    """One split of an OpenEDS H5 file, items for scored evaluation."""

    def __init__(self, opt, dataset_key: Optional[str] = None):
        import h5py

        if opt.preprocess_mode != "fixed" or not opt.device_normalize:
            raise NotImplementedError(
                "the port's evaluation loader takes preprocess_mode 'fixed' "
                "with uint8 transport (device_normalize) only")
        if opt.isTrain and not opt.no_flip:
            raise NotImplementedError("flips are training-time augmentation, "
                                      "which the port's loader does not do")
        self.opt = opt
        self.dataset_key = dataset_key or opt.dataset_key
        self.keys = split_keys(self.dataset_key)
        self._h5 = None
        self._style_refs = None
        with h5py.File(opt.dataroot, "r") as f:
            grp = f[self.dataset_key]
            self.user_ids = list(grp.keys())
            self.N = 0
            self.N_start: List[int] = []
            for user in self.user_ids:
                self.N_start.append(self.N)
                if self.keys["filenames"] in grp[user]:
                    self.N += grp[user][self.keys["filenames"]].shape[0]

    @property
    def h5(self):
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.opt.dataroot, "r")
        return self._h5[self.dataset_key]

    @property
    def style_refs(self):
        if self._style_refs is None:
            import h5py
            assert self.opt.style_ref, \
                "You need to provide a h5 file for style references."
            self._style_refs = h5py.File(self.opt.style_ref, "r")
        return self._style_refs[self.dataset_key]

    def __len__(self) -> int:
        return self.N

    def _resize(self, img, is_mask: bool) -> np.ndarray:
        return resize_fixed(np.asarray(img), self.opt.image_width,
                            self.opt.image_height, is_mask)

    def _style_indices(self, n_images: int, rng: np.random.Generator,
                       user: str, filename: str):
        """-> (indices, subsets or None) (reference openeds_dataset.py:
        150-188)."""
        method, n = self.opt.style_sample_method, self.opt.input_ns
        if method == "random":
            return list(rng.choice(n_images, n)), None
        if method == "first":
            return list(range(min(n, n_images))), None
        if "ref" not in method:
            raise ValueError(f"Invalid style sampling method: {method}")
        node = self.style_refs[user][filename]
        subsets = node["subset"] if "subset" in node.keys() else None
        if "random" not in method:                      # ref_first
            return (list(node["index"][:n]),
                    None if subsets is None else list(subsets[:n]))
        digits = re.sub(r"[^\d]", "", method)
        picks = [int(i) for i in rng.choice(int(digits or 40), n)]
        return ([node["index"][i] for i in picks],
                None if subsets is None else [subsets[i] for i in picks])

    def _style_images(self, user: str, rng: np.random.Generator,
                      filename: str) -> np.ndarray:
        grp = self.h5[user]
        key_style = self.keys["style_images"]
        n_images = grp[key_style].shape[0]
        indices, subsets = self._style_indices(n_images, rng, user, filename)
        images = []
        for i, sel in enumerate(indices):
            key, sel = key_style, int(sel)
            if subsets is not None and subsets[i] == b"s":
                # sequence frames are ranked after the generative images
                key, sel = "images_seq", sel - n_images
            images.append(self._resize(grp[key][sel], is_mask=False))
        return np.ascontiguousarray(np.stack(images))[..., None]

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        u = int(np.searchsorted(np.asarray(self.N_start), index,
                                side="right") - 1)
        user, within = self.user_ids[u], index - self.N_start[u]
        grp = self.h5[user]
        mask = grp[self.keys["labels"]][within]
        # the JAX package's get_params draws a crop position even in 'fixed'
        # mode, from the mask's (H, W) read as (w, h); those draws come first
        # in the sample's generator
        w, h = mask.shape[:2]
        for extent in (w, h):
            rng.integers(0, max(0, extent - self.opt.crop_size) + 1)
        filename = re.sub(r"\.", "", grp[self.keys["filenames"]][within]
                          .decode("utf-8"))
        item = {"label": np.ascontiguousarray(self._resize(mask, True)),
                "filename": filename, "user": user,
                "style_image": self._style_images(user, rng, filename)}
        if self.dataset_key != "test":
            target = np.asarray(grp["images_ss"][within])
            item["target"] = np.ascontiguousarray(
                self._resize(target, False))[..., None]
            item["target_original"] = np.ascontiguousarray(
                target).astype(np.uint8)[..., None]
        return item

    def get_validation_indices(self) -> List[int]:
        """First and last index of each user (openeds_dataset.py:139-144)."""
        return (list(self.N_start)
                + [idx - 1 for idx in self.N_start[1:]] + [self.N - 1])

    def get_random_indices(self, n: int,
                           rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        return list(rng.choice(self.N, n))

    def close(self):
        for f in (self._h5, self._style_refs):
            if f is not None:
                f.close()
        self._h5 = self._style_refs = None


def collate(items: List[Dict]) -> Dict:
    return {k: (np.stack([it[k] for it in items])
                if isinstance(items[0][k], np.ndarray)
                else [it[k] for it in items])
            for k in items[0]}


class DataLoader:
    """Serial batches of an ``OpenEDSDataset``, the last one short.  Sample
    i of the e-th pass (e = 1, 2, ...) draws from the generator seeded
    (seed, e, i), as the JAX package's loader does, so both give the same
    style references."""

    def __init__(self, dataset: OpenEDSDataset, batch_size: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        self._epoch += 1
        for lo in range(0, len(self.dataset), self.batch_size):
            idxs = range(lo, min(lo + self.batch_size, len(self.dataset)))
            yield collate([self._item(i) for i in idxs])

    def _item(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        return self.dataset.__getitem__(int(idx), rng=rng)

    def get_particular(self, idx: int) -> Dict:
        """One-sample batch (reference openeds_dataset.py:121-127)."""
        return collate([self._item(idx)])
