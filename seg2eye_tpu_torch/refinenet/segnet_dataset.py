"""SegNet datasets (the port's copy of
``seg2eye_tpu/refinenet/segnet_dataset.py``, held to it byte for byte by a
test; reference: refinenet/train_segnet.py:28-83 and
refinenet/evaluate_segnet.py:40-80).

A quirk kept on purpose: the reference resizes the class-id label map
with INTER_AREA (train_segnet.py:77), which averages class ids at
boundaries.  h5py and cv2 are imported inside the functions that use them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.dataset import u8_transport_ok


class SegNetDataset:
    """Labeled (images_ss, labels_ss) pairs for training/validation."""

    def __init__(self, cfg: RefineNetConfig, split: str):
        import h5py

        self.cfg = cfg
        self.split = split
        self._h5 = None
        with h5py.File(cfg.dataroot, "r") as hdf:
            self.idx_to_kv = []
            for pid in hdf[split].keys():
                n = hdf[split][pid]["images_ss"].shape[0]
                self.idx_to_kv += [(pid, i) for i in range(n)]

    def __len__(self):
        return len(self.idx_to_kv)

    @property
    def N(self):
        return len(self.idx_to_kv)

    def _open(self):
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self.cfg.dataroot, "r")
        return self._h5

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        if u8_transport_ok(self.cfg, image):
            return np.ascontiguousarray(image)[..., None]
        import cv2

        image = image.astype(np.float32)
        image = cv2.resize(image, (self.cfg.input_width,
                                   self.cfg.input_height),
                           interpolation=cv2.INTER_AREA)
        return (image * (2.0 / 255.0) - 1.0)[..., None]

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        hdf = self._open()
        key, within = self.idx_to_kv[idx]
        person = hdf[self.split][key]
        entry = {"input": self.preprocess_image(
            np.copy(person["images_ss"][within])),
            "person_id": key}
        if "labels_ss" in person:
            import cv2

            y = np.copy(person["labels_ss"][within])
            y = cv2.resize(y, dsize=(self.cfg.input_width,
                                     self.cfg.input_height),
                           interpolation=cv2.INTER_AREA)
            # the model casts labels to integers on the device; uint8
            # transport is 4x smaller and value-identical (class ids 0..3)
            entry["target"] = (y.astype(np.uint8)
                               if getattr(self.cfg, "device_normalize", False)
                               else y.astype(np.int32))
        return entry


class SegNetEvalDataset:
    """Unlabeled images (images_gen or images_seq) for prediction dumping —
    evaluate_segnet produces the segmentation H5 that the RefineNet dataset
    consumes (SURVEY §2 R11)."""

    def __init__(self, cfg: RefineNetConfig, split: str, image_key: str):
        import h5py

        self.cfg = cfg
        self.split = split
        self.image_key = image_key
        self._h5 = None
        with h5py.File(cfg.dataroot, "r") as hdf:
            self.idx_to_kv = []
            for pid in hdf[split].keys():
                if image_key in hdf[split][pid]:
                    n = hdf[split][pid][image_key].shape[0]
                    self.idx_to_kv += [(pid, i) for i in range(n)]

    def __len__(self):
        return len(self.idx_to_kv)

    @property
    def N(self):
        return len(self.idx_to_kv)

    def _open(self):
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self.cfg.dataroot, "r")
        return self._h5

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        hdf = self._open()
        key, within = self.idx_to_kv[idx]
        img = np.copy(hdf[self.split][key][self.image_key][within])
        if u8_transport_ok(self.cfg, img):
            return {"input": np.ascontiguousarray(img)[..., None],
                    "person_id": key}
        import cv2

        img = img.astype(np.float32)
        img = cv2.resize(img, (self.cfg.input_width, self.cfg.input_height),
                         interpolation=cv2.INTER_AREA)
        return {"input": (img * (2.0 / 255.0) - 1.0)[..., None],
                "person_id": key}
