"""OpenEDS H5 reader and batcher (the port's own trim of
``seg2eye_tpu/data/{schema,transforms,openeds,loader}.py``).

What training and the evaluation CLI need: the split-dependent keys, the
style-reference sampling (random, first, ref_first, ref_randomN) drawn
from per-sample generators, every ``preprocess_mode`` with the
training-time horizontal flip (one crop position and one coin per sample,
shared by mask, references and target; ``data.transforms``), and the
uint8 transport or, with ``--no_device_normalize``, float32 images in
[-1, 1] and an int32 ``target_original``.  ``DataLoader`` shuffles with a stateless (seed, epoch)
permutation, drops the last short batch when training, can skip the first
batches of its next pass (mid-epoch resume) and reads batches ahead on a
worker thread.  Given the same options and file, it yields the same
batches byte for byte as the JAX package's ``DataLoader`` (tested).  It
batches any dataset with ``__len__`` and ``__getitem__(index, rng)``: the
RefineNet datasets too, and their ``subsample``d test splits.
``device_prefetch`` moves the arrays of the given keys of each batch to
the card one step ahead, from pinned memory.

``h5py``, ``cv2`` and ``PIL`` are imported inside the functions that use
them, so that ``import seg2eye_tpu_torch`` works without them.
"""
from __future__ import annotations

import queue
import re
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from seg2eye_tpu_torch.data import transforms
from seg2eye_tpu_torch.data.schema import split_keys


class OpenEDSDataset:
    """One split of an OpenEDS H5 file."""

    def __init__(self, opt, dataset_key: Optional[str] = None):
        import h5py

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
                      filename: str, params: Dict) -> np.ndarray:
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
            images.append(np.asarray(grp[key][sel]))
        return transforms.transform_images(images, self.opt, params)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        u = int(np.searchsorted(np.asarray(self.N_start), index,
                                side="right") - 1)
        user, within = self.user_ids[u], index - self.N_start[u]
        grp = self.h5[user]
        mask = grp[self.keys["labels"]][within]
        # the JAX package passes the mask's (H, W) as get_params' (w, h)
        # (its reference's quirk): the crop domain is the swapped one
        params = transforms.get_params(self.opt, rng,
                                       size=tuple(mask.shape[:2]))
        filename = re.sub(r"\.", "", grp[self.keys["filenames"]][within]
                          .decode("utf-8"))
        item = {"label": transforms.transform_mask(mask, self.opt, params),
                "filename": filename, "user": user,
                "style_image": self._style_images(user, rng, filename,
                                                  params)}
        if self.dataset_key != "test":
            target = np.asarray(grp["images_ss"][within])
            u8 = self.opt.device_normalize
            item["target"] = (
                np.ascontiguousarray(transforms.spatial_image(
                    target, self.opt, params))[..., None] if u8
                else transforms.transform_image(target, self.opt, params))
            orig = target[:, ::-1] if params["flip"] else target
            item["target_original"] = np.ascontiguousarray(orig).astype(
                np.uint8 if u8 else np.int32)[..., None]
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


def threaded_iter(src: Iterable, transform, depth: int) -> Iterator:
    """``transform(item)`` for each item of ``src``, computed ahead of the
    consumer on a daemon thread through a queue of ``depth``.  A worker
    exception re-raises on the consumer after the items queued before it;
    a consumer that stops early releases the worker (the put polls a stop
    event, and the queue is drained)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in src:
                if stop.is_set() or not put(transform(item)):
                    return
        except BaseException as e:          # re-raised on the consumer
            err.append(e)
        finally:
            put(done)

    threading.Thread(target=work, daemon=True).start()
    try:
        while True:
            out = q.get()
            if out is done:
                if err:
                    raise err[0]
                return
            yield out
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


class Subset:
    """A fixed-index view of a dataset, indices sorted for H5 read
    locality (the reference's random test-split subsampling,
    refinenet/core/training.py:99-149)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.sort(np.asarray(indices))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        return self.dataset.__getitem__(int(self.indices[idx]), rng=rng)


def subsample(dataset, n: int, seed: int = 0):
    """``n`` samples drawn without replacement, seeded, when the dataset is
    larger than ``n`` (training.py:119-127); otherwise the dataset."""
    if n and len(dataset) > n:
        rng = np.random.default_rng(seed)
        return Subset(dataset, rng.choice(len(dataset), n, replace=False))
    return dataset


class DataLoader:
    """Batches of a dataset (an ``OpenEDSDataset``, a RefineNet dataset, a
    ``Subset``).  The e-th pass (e = 1, 2, ...)
    shuffles with the generator seeded (seed, e), and sample i of it draws
    from the generator seeded (seed, e, i), as the JAX package's loader
    does: no state carries from one pass to the next, so a run resumed at
    epoch e (``set_epoch``) sees the batches the unbroken run saw there.
    ``prefetch`` > 0 reads that many batches ahead on a worker thread."""

    def __init__(self, dataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        self._skip_next = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """The next pass is training epoch ``epoch``."""
        self._epoch = epoch - 1

    def skip_next_batches(self, n: int) -> None:
        """The next pass leaves out its first ``n`` batches (they were
        trained before a mid-epoch restart); they are never read."""
        self._skip_next = n

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        self._epoch += 1
        batches = self._index_batches()[self._skip_next:]
        self._skip_next = 0
        if self.prefetch <= 0:
            for idxs in batches:
                yield self._load(idxs)
            return
        yield from threaded_iter(batches, self._load, self.prefetch)

    def _load(self, idxs) -> Dict:
        return collate([self._item(i) for i in idxs])

    def _item(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        return self.dataset.__getitem__(int(idx), rng=rng)

    def get_particular(self, idx: int) -> Dict:
        """One-sample batch (reference openeds_dataset.py:121-127)."""
        return collate([self._item(idx)])


def create_dataloader(opt, dataset_key: Optional[str] = None) -> DataLoader:
    """The loader of ``opt``: shuffled unless ``serial_batches``, the last
    short batch dropped when training."""
    return DataLoader(OpenEDSDataset(opt, dataset_key=dataset_key),
                      batch_size=opt.batchSize,
                      shuffle=not opt.serial_batches, drop_last=opt.isTrain,
                      seed=opt.seed, prefetch=opt.prefetch)


MODEL_KEYS = ("label", "style_image", "target")


def to_device(batch: Dict, device: torch.device,
              keys: Sequence[str] = MODEL_KEYS) -> Dict:
    """The arrays of ``keys`` that the batch has (by default those the
    Seg2Eye model reads), on ``device``; for a card, from pinned host
    memory and without waiting for the copy."""
    out = {}
    for k in keys:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


def device_prefetch(batches: Iterable[Dict], device,
                    keys: Sequence[str] = MODEL_KEYS) -> Iterator:
    """(host batch, device batch of ``keys``) pairs, the copy of each batch
    to the device started one step ahead: before the previous pair is
    handed out."""
    device = torch.device(device)
    it = iter(batches)
    ahead = None
    for batch in it:
        pair = (batch, to_device(batch, device, keys))
        if ahead is not None:
            yield ahead
        ahead = pair
    if ahead is not None:
        yield ahead
