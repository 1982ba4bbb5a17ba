"""Offline OpenEDS -> H5 builder (the port's copy of
``seg2eye_tpu/data/prepare_openeds.py``; reference:
data/prepare_openeds.py).

    python -m seg2eye_tpu_torch.data.prepare_openeds --base_path DIR \
        [--limit N] [--n_jobs 8] [--out_filename openeds.h5]

Given the unzipped OpenEDS dataset (Semantic_Segmentation_Dataset,
Generative_Dataset, Sequence_Dataset folders plus the per-split
``OpenEDS_<subset>_userID_mapping_to_images.json`` files), packs everything
into one H5 with the schema documented in ``data/schema.py``:
  * train/validation: per-user images_ss, labels_ss, images_gen, images_seq
    (+ <name>_filenames S13) (reference: prepare_openeds.py:92-110)
  * test: images_ss, labels_gen, images_seq (reference: :113-133)
Unreadable images are skipped with a count (reference: :43-47).
Parallel reads use a thread pool (the reference used joblib processes).
``h5py`` and ``imageio`` are imported inside the functions that use them
(the card's machine has neither).
"""
from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

FOLDER_SS = "Semantic_Segmentation_Dataset"
FOLDER_GEN = "Generative_Dataset"
FOLDER_SEQ = "Sequence_Dataset"


class OpenEDSPreparator:
    def __init__(self, base_path: str, limit: int = -1, verbose: bool = False,
                 n_jobs: int = 8, out_filename: str = "openeds.h5"):
        self.base_path = base_path
        self.limit = limit - 1 if limit > 0 else np.inf
        self.verbose = verbose
        self.n_jobs = n_jobs
        self.path_out = os.path.join(base_path, out_filename)

    # ------------------------------------------------------------------ #
    def load_and_preprocess(self, filename: str, path: str
                            ) -> Optional[Tuple[np.ndarray, str]]:
        try:
            import imageio.v2 as imageio
        except ImportError:
            import imageio
        try:
            img = imageio.imread(os.path.join(path, filename))
        except (ValueError, OSError):
            print(f"Could not read file from {os.path.join(path, filename)}")
            return None
        img = np.asarray(img)
        if img.ndim > 2:
            img = np.mean(img, axis=2)
        return img.astype(np.uint8), filename[:-4]

    def _load_many(self, img_ids: List[str], path: str):
        with ThreadPoolExecutor(max_workers=self.n_jobs) as ex:
            result = list(ex.map(
                lambda fid: self.load_and_preprocess(fid, path), img_ids))
        ok = [r for r in result if r is not None]
        images, filenames = zip(*ok) if ok else ((), ())
        return images, filenames, len(result) - len(ok)

    def create_dataset_images(self, path, img_ids, group, ds_name):
        images, filenames, n_errors = self._load_many(img_ids, path)
        images = np.array(images)
        group.create_dataset(ds_name, data=images, dtype=np.uint8,
                             chunks=(1, *images.shape[1:]))
        group.create_dataset(ds_name + "_filenames",
                             data=np.array(filenames).astype("S13"),
                             dtype="S13", chunks=True)
        print(f"Dataset '{ds_name}' with {len(images)} images created.")
        if n_errors:
            print(f"{n_errors} skipped images when creating dataset")

    def create_dataset_labels(self, path, img_ids, group, ds_name):
        labels = np.array([np.load(os.path.join(path, fid[:-3] + "npy"))
                           for fid in img_ids])
        group.create_dataset(ds_name, data=labels, dtype=np.uint8,
                             chunks=(1, *labels.shape[1:]))
        group.create_dataset(ds_name + "_filenames",
                             data=np.array(img_ids).astype("S13"),
                             dtype="S13", chunks=True)
        print(f"Dataset '{ds_name}' with {len(labels)} labels created.")

    # ------------------------------------------------------------------ #
    def run(self) -> str:
        import h5py

        with h5py.File(self.path_out, "w") as out:
            for subset in ("validation", "train"):
                self._run_labeled_subset(out, subset)
            self._run_test_subset(out)
        print(f"Done: {self.path_out}")
        return self.path_out

    def _user_mapping(self, subset: str):
        path = os.path.join(
            self.base_path,
            f"OpenEDS_{subset}_userID_mapping_to_images.json")
        with open(path) as f:
            return json.load(f)

    def _run_labeled_subset(self, out, subset: str):
        print(f"Processing '{subset}'...")
        g_subset = out.create_group(subset)
        users = self._user_mapping(subset)
        for i, user in enumerate(users):
            g = g_subset.create_group(user["id"])
            ss = os.path.join(self.base_path, FOLDER_SS, subset)
            self.create_dataset_images(
                os.path.join(ss, "images"),
                user["semantic_segmenation_images"], g, "images_ss")
            self.create_dataset_labels(
                os.path.join(ss, "labels"),
                user["semantic_segmenation_images"], g, "labels_ss")
            self.create_dataset_images(
                os.path.join(self.base_path, FOLDER_GEN, subset),
                user["generative_images"], g, "images_gen")
            self.create_dataset_images(
                os.path.join(self.base_path, FOLDER_SEQ, subset),
                user["sequence_images"], g, "images_seq")
            # the reference checks the limit AFTER processing
            # (prepare_openeds.py:109-110), so --limit N packs N+1 users —
            # off-by-one reproduced for dataset-for-dataset parity
            if i > self.limit:
                break

    def _run_test_subset(self, out):
        subset = "test"
        print(f"Processing '{subset}'...")
        g_subset = out.create_group(subset)
        for i, user in enumerate(self._user_mapping(subset)):
            g = g_subset.create_group(user["id"])
            ss = os.path.join(self.base_path, FOLDER_SS, subset)
            self.create_dataset_images(
                os.path.join(ss, "images"),
                user["semantic_segmenation_images"], g, "images_ss")
            self.create_dataset_labels(
                os.path.join(self.base_path, FOLDER_GEN, subset, "labels"),
                user["generative_images"], g, "labels_gen")
            self.create_dataset_images(
                os.path.join(self.base_path, FOLDER_SEQ, subset),
                user["sequence_images"], g, "images_seq")
            # post-body limit check, as the reference (prepare_openeds.py:
            # 135-136) — --limit N packs N+1 users
            if i > self.limit:
                break


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_path", required=True)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--n_jobs", type=int, default=8)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--out_filename", default="openeds.h5")
    a = p.parse_args(argv)
    OpenEDSPreparator(a.base_path, a.limit, a.verbose, a.n_jobs,
                      a.out_filename).run()


if __name__ == "__main__":
    main()
