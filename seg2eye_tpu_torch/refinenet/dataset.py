"""RefineNet H5 dataset (the port's copy of
``seg2eye_tpu/refinenet/dataset.py``, held to it byte for byte by a test):
joins the main data file with the nearest-neighbour ranking and the
predicted-segmentation files.

  * index = (person, i) pairs over labels_ss (train/validation) or
    labels_gen (test); the train split drops user U111.
  * The neighbour: a random pick from the ranking, drawn from the loader's
    per-sample generator, or the top-1 under ``pick1`` (required for
    test); the ranking spans the generative ('g') and sequence ('s')
    subsets, sequence indices offset by the generative count.  A sequence
    entry without ``segmentations_sequence`` is a clear error.
  * Predicted segmentations come from separate H5s: segmentations_train
    for the train split, segmentations_generative + segmentations_sequence
    for validation/test.
  * ``colorize_segmap`` maps class -> mean gray value; images are resized
    with INTER_AREA to the input size and scaled to [-1,1] float32, or
    kept uint8 when no resize is needed (``u8_transport_ok``).
  * sample = {'input': (H,W,3) [mask | neighbour image | neighbour mask],
    'target': (H,W,1), 'person_id', 'fname'}.

h5py and cv2 are imported inside the functions that use them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
COLORIZE_MEANS = np.array([125.73929, 103.19314, 76.50751, 34.1294])


def colorize_segmap(segmap: np.ndarray) -> np.ndarray:
    out = np.empty(segmap.shape, dtype=np.uint8)
    for j, v in enumerate(COLORIZE_MEANS):
        out[segmap == j] = v
    return out


def u8_transport_ok(cfg, *images) -> bool:
    """uint8 device transport is bit-exact only when no host resize is
    needed (the cv2.INTER_AREA resample runs on float32 data otherwise);
    real OpenEDS sources are already 640x400, so this is the usual case.
    The model's normalisation on the device is the same x*(2/255)-1."""
    th, tw = cfg.input_height, cfg.input_width
    return (getattr(cfg, "device_normalize", False)
            and all(im.dtype == np.uint8 and im.shape[:2] == (th, tw)
                    for im in images))


class RefineNetDataset:
    def __init__(self, cfg: RefineNetConfig, split: str,
                 pick1: bool = False):
        self.cfg = cfg
        self.split = split
        self.pick1 = pick1
        if split == "test":
            assert pick1 is True
        self._files: Optional[Dict] = None

        import h5py

        with h5py.File(cfg.dataroot, "r") as hdf:
            person_ids = list(hdf[split].keys())
            if split == "train" and "U111" in person_ids:
                person_ids.remove("U111")
            self.idx_to_kv = []
            label_key = "labels_gen" if split == "test" else "labels_ss"
            for pid in person_ids:
                n = hdf[split][pid][label_key].shape[0]
                self.idx_to_kv += [(pid, i) for i in range(n)]

    def __len__(self) -> int:
        return len(self.idx_to_kv)

    @property
    def N(self) -> int:
        return len(self.idx_to_kv)

    # opened on first read (dataset.py:74-78)
    def _open(self):
        if self._files is None:
            import h5py

            cfg = self.cfg
            f = {"hdf": h5py.File(cfg.dataroot, "r"),
                 "idx": h5py.File(cfg.distances_and_indices, "r")}
            if self.split in ("validation", "test"):
                f["map"] = h5py.File(cfg.segmentations_generative, "r")
                f["map_seq"] = h5py.File(cfg.segmentations_sequence, "r")
            else:
                f["map"] = h5py.File(cfg.segmentations_train, "r")
                f["map_seq"] = (h5py.File(cfg.segmentations_sequence, "r")
                                if cfg.segmentations_sequence else None)
            self._files = f
        return self._files

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        import cv2

        image = image.astype(np.float32)
        image = cv2.resize(image, (self.cfg.input_width,
                                   self.cfg.input_height),
                           interpolation=cv2.INTER_AREA)
        image = image * (2.0 / 255.0) - 1.0
        return image[..., None]                      # HW -> HWC

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        f = self._open()
        key, within = self.idx_to_kv[idx]
        person = f["hdf"][self.split][key]

        if self.split != "test":
            x = person["labels_ss"][within]
            y = person["images_ss"][within]
            fname = person["labels_ss_filenames"][within].decode(
                "utf-8").replace(".", "")
            ref_images_key, style_count_key = "images_gen", "images_gen"
        else:
            x = person["labels_gen"][within]
            y = None
            fname = person["labels_gen_filenames"][within].decode(
                "utf-8").replace(".", "")
            ref_images_key, style_count_key = "images_ss", "images_ss"

        nn_data = f["idx"][self.split][key][fname]
        candidates = nn_data["index"]
        rpos = int(rng.integers(0, len(candidates))) if not self.pick1 else 0
        ridx = int(candidates[rpos])
        rfrom = nn_data["subset"][rpos]

        if rfrom == b"g":
            rim = person[ref_images_key][ridx]
            rss = f["map"][self.split][key][ridx]
        elif rfrom == b"s":
            if f["map_seq"] is None:
                raise ValueError(
                    "nearest-neighbor ranking entry for "
                    f"'{key}/{fname}' points into the sequence subset, but "
                    "cfg.segmentations_sequence is unset — pass the "
                    "sequence-segmentation H5 (refinenet/evaluate_segnet.py "
                    "--image_key images_seq output) or rebuild the ranking "
                    "without sequence candidates")
            num_gen = person[style_count_key].shape[0]
            rim = person["images_seq"][ridx - num_gen]
            rss = f["map_seq"][self.split][key][ridx - num_gen]
        else:
            raise ValueError(f"Unknown subset source: {rfrom}")

        x = colorize_segmap(x)
        rss = colorize_segmap(rss)
        if u8_transport_ok(self.cfg, x, rim, rss):
            stacked = np.stack([x, rim, rss], axis=-1)
        else:
            stacked = np.concatenate(
                [self.preprocess_image(img) for img in (x, rim, rss)],
                axis=-1)
        entry = {"input": stacked, "person_id": key, "fname": fname}
        if y is not None:
            y = np.copy(y)
            entry["target"] = (y[..., None] if u8_transport_ok(self.cfg, y)
                               else self.preprocess_image(y))
        return entry

    def close(self):
        if self._files:
            for v in self._files.values():
                if v is not None:
                    v.close()
            self._files = None
