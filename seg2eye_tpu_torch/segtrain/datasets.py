"""Datasets of the segmentation trainer: VOC, SBD, COCO and Cityscapes, the
combining wrapper and the loader factory (counterpart of
``seg2eye_tpu/segtrain/datasets.py``; reference: refinenet/deeplab/
dataloaders/).

  * VOCSegmentation: JPEGImages/ and SegmentationClass/ pairs listed by
    ImageSets/Segmentation/<split>.txt, their existence asserted; a list
    of splits is sorted and its first split name decides the transform
    chain (the reference's quirk: ['train', 'val'] applies the train chain
    to all).
  * SBDSegmentation: dataset/{img,cls} with .mat GTcls labels, always the
    train chain; ``scipy.io`` imported where a label is read.
  * CityscapesSegmentation: every .png under leftImg8bit/<split>, the label
    path derived from the file name; raw labelIds remapped with one LUT,
    void classes to 255, valid ones to 0..18.
  * COCOSegmentation: instances_<split><year>.json; images with at most
    1000 annotated pixels dropped once, the surviving ids cached beside the
    annotations; masks painted per annotation, first wins, categories
    outside CAT_LIST skipped.  pycocotools is replaced by a numpy/PIL
    decoder: polygons and both COCO RLE forms.
  * CombineDBs: the union of the im_ids minus the excluded ones, the first
    dataset winning a duplicate.
  * make_data_loader -> (train, val, test, nclass), built on the port's
    ``data.openeds.DataLoader``: sample i of pass e draws from the
    generator seeded (seed, e, i), as the JAX package's loader does, so
    the batches are the JAX package's byte for byte.  Under data
    parallelism each process loads its share of every global batch
    (``process_index``/``process_count``), and the eval loaders drop a
    tail that the processes could not share evenly, as the JAX package's
    do over several processes.

Dataset roots come from --data-root or $SEG2EYE_DATA_ROOT (default
./datasets) with the reference's subdirectory names.  Every
``__getitem__`` takes the loader's ``np.random.Generator``.  PIL is
imported inside the functions that read images.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from seg2eye_tpu_torch.data.openeds import DataLoader
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.segtrain import transforms as tr

_SUBDIR = {"pascal": os.path.join("VOCdevkit", "VOC2012"),
           "sbd": "benchmark_RELEASE",
           "cityscapes": "cityscapes",
           "coco": "coco"}


def db_root_dir(dataset: str, data_root: Optional[str] = None) -> str:
    """mypath.py:1-14, its machine-specific prefix replaced by
    --data-root or $SEG2EYE_DATA_ROOT (default ./datasets)."""
    if dataset not in _SUBDIR:
        raise NotImplementedError(f"Dataset {dataset} not available.")
    root = data_root or os.environ.get("SEG2EYE_DATA_ROOT", "./datasets")
    return os.path.join(root, _SUBDIR[dataset])


def _open_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


class VOCSegmentation:
    """pascal.py:10-104."""
    NUM_CLASSES = 21

    def __init__(self, args, base_dir: Optional[str] = None,
                 split: Union[str, Sequence[str]] = "train"):
        base_dir = base_dir or db_root_dir(
            "pascal", getattr(args, "data_root", None))
        self._image_dir = os.path.join(base_dir, "JPEGImages")
        self._cat_dir = os.path.join(base_dir, "SegmentationClass")
        if isinstance(split, str):
            self.split = [split]
        else:
            self.split = sorted(split)
        splits_dir = os.path.join(base_dir, "ImageSets", "Segmentation")

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.categories: List[str] = []
        for splt in self.split:
            with open(os.path.join(splits_dir, splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                image = os.path.join(self._image_dir, line + ".jpg")
                cat = os.path.join(self._cat_dir, line + ".png")
                assert os.path.isfile(image), image
                assert os.path.isfile(cat), cat
                self.im_ids.append(line)
                self.images.append(image)
                self.categories.append(cat)
        assert len(self.images) == len(self.categories)

        self._tr = tr.train_transform(args.base_size, args.crop_size)
        self._val = tr.val_transform(args.crop_size)
        print(f"Number of images in {split}: {len(self.images):d}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        from PIL import Image

        sample = {"image": _open_rgb(self.images[index]),
                  "label": Image.open(self.categories[index])}
        for split in self.split:           # the first match decides
            if split == "train":
                return self._tr(sample, rng)
            elif split == "val":
                return self._val(sample, rng)
        raise ValueError(f"no transform for splits {self.split}")

    def __str__(self) -> str:
        return "VOC2012(split=" + str(self.split) + ")"


class SBDSegmentation:
    """sbd.py:13-91."""
    NUM_CLASSES = 21

    def __init__(self, args, base_dir: Optional[str] = None,
                 split: Union[str, Sequence[str]] = "train"):
        base_dir = base_dir or db_root_dir(
            "sbd", getattr(args, "data_root", None))
        dataset_dir = os.path.join(base_dir, "dataset")
        image_dir = os.path.join(dataset_dir, "img")
        cat_dir = os.path.join(dataset_dir, "cls")
        self.split = [split] if isinstance(split, str) else sorted(split)

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.categories: List[str] = []
        for splt in self.split:
            with open(os.path.join(dataset_dir, splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                image = os.path.join(image_dir, line + ".jpg")
                categ = os.path.join(cat_dir, line + ".mat")
                assert os.path.isfile(image), image
                assert os.path.isfile(categ), categ
                self.im_ids.append(line)
                self.images.append(image)
                self.categories.append(categ)
        assert len(self.images) == len(self.categories)

        self._tr = tr.train_transform(args.base_size, args.crop_size)
        print(f"Number of images: {len(self.images):d}")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        import scipy.io
        from PIL import Image

        img = _open_rgb(self.images[index])
        mat = scipy.io.loadmat(self.categories[index])
        target = Image.fromarray(mat["GTcls"][0]["Segmentation"][0])
        return self._tr({"image": img, "label": target}, rng)

    def __str__(self) -> str:
        return "SBDSegmentation(split=" + str(self.split) + ")"


class CityscapesSegmentation:
    """cityscapes.py:10-107."""
    NUM_CLASSES = 19
    VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
    VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26,
                     27, 28, 31, 32, 33]

    def __init__(self, args, root: Optional[str] = None, split: str = "train"):
        root = root or db_root_dir(
            "cityscapes", getattr(args, "data_root", None))
        self.split = split
        self.images_base = os.path.join(root, "leftImg8bit", split)
        self.annotations_base = os.path.join(
            root, "gtFine_trainvaltest", "gtFine", split)
        self.files = sorted(
            os.path.join(looproot, fn)
            for looproot, _, fns in os.walk(self.images_base)
            for fn in fns if fn.endswith(".png"))
        if not self.files:
            raise RuntimeError(
                f"No files for split=[{split}] found in {self.images_base}")
        self.ignore_index = 255
        lut = np.full(256, self.ignore_index, np.uint8)
        for i, valid in enumerate(self.VALID_CLASSES):
            lut[valid] = i
        self._lut = lut

        self._tr = tr.train_transform(args.base_size, args.crop_size,
                                      fill=255)
        self._val = tr.val_transform(args.crop_size)
        self._ts = tr.test_transform(args.crop_size)
        print(f"Found {len(self.files):d} {split} images")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        from PIL import Image

        img_path = self.files[index].rstrip()
        lbl_path = os.path.join(
            self.annotations_base,
            img_path.split(os.sep)[-2],
            os.path.basename(img_path)[:-15] + "gtFine_labelIds.png")
        raw = np.array(Image.open(lbl_path), dtype=np.uint8)
        sample = {"image": _open_rgb(img_path),
                  "label": Image.fromarray(self._lut[raw])}
        if self.split == "train":
            return self._tr(sample, rng)
        if self.split == "val":
            return self._val(sample, rng)
        if self.split == "test":
            return self._ts(sample, rng)
        raise ValueError(self.split)


# --------------------------------------------------------------------- #
# COCO, without pycocotools
# --------------------------------------------------------------------- #

def _rle_counts_from_string(s: str) -> List[int]:
    """COCO compressed-RLE string -> run counts (the cocoapi encoding:
    5-bit groups, bit 5 the continuation, sign-extended, each count after
    the second a delta from counts[-2])."""
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _decode_rle(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Run counts (column-major, zeros first) -> (h, w) uint8."""
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((h, w), order="F")


def _decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """annotation['segmentation'] -> an (h, w) mask (RLE) or an (h, w, n)
    one (n polygons), as pycocotools' decode(frPyObjects(...)) shapes them
    (coco.py:91-94 branches on it)."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = _rle_counts_from_string(counts)
        return _decode_rle(counts, *seg["size"])
    from PIL import Image, ImageDraw

    layers = []
    for poly in seg:
        img = Image.new("L", (w, h), 0)
        xy = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(xy) >= 3:
            ImageDraw.Draw(img).polygon(xy, outline=1, fill=1)
        layers.append(np.asarray(img, np.uint8))
    return np.stack(layers, axis=-1)


class COCOSegmentation:
    """coco.py:15-118.  The annotation JSON is parsed directly; the ids of
    the images with more than 1000 annotated pixels are cached as
    <split>_ids_<year>.npy."""
    NUM_CLASSES = 21
    CAT_LIST = [0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4,
                1, 64, 20, 63, 7, 72]

    def __init__(self, args, base_dir: Optional[str] = None,
                 split: str = "train", year: str = "2017"):
        base_dir = base_dir or db_root_dir(
            "coco", getattr(args, "data_root", None))
        ann_file = os.path.join(base_dir,
                                f"annotations/instances_{split}{year}.json")
        ids_file = os.path.join(base_dir,
                                f"annotations/{split}_ids_{year}.npy")
        self.img_dir = os.path.join(base_dir, f"images/{split}{year}")
        self.split = split
        with open(ann_file) as f:
            ann = json.load(f)
        self.imgs = {im["id"]: im for im in ann["images"]}
        self.anns_by_img: Dict[int, List[Dict]] = {}
        for a in ann["annotations"]:
            self.anns_by_img.setdefault(a["image_id"], []).append(a)
        if os.path.exists(ids_file):
            self.ids = [int(i) for i in np.load(ids_file)]
        else:
            self.ids = self._preprocess(list(self.imgs.keys()), ids_file)
        self._tr = tr.train_transform(args.base_size, args.crop_size)
        self._val = tr.val_transform(args.crop_size)

    def _gen_seg_mask(self, target: List[Dict], h: int, w: int) -> np.ndarray:
        mask = np.zeros((h, w), dtype=np.uint8)
        for instance in target:
            m = _decode_segmentation(instance["segmentation"], h, w)
            cat = instance["category_id"]
            if cat in self.CAT_LIST:
                c = self.CAT_LIST.index(cat)
            else:
                continue
            if len(m.shape) < 3:
                mask[:, :] += (mask == 0) * (m * c)
            else:
                mask[:, :] += (mask == 0) * (
                    ((np.sum(m, axis=2)) > 0) * c).astype(np.uint8)
        return mask

    def _preprocess(self, ids: List[int], ids_file: str) -> List[int]:
        print("Preprocessing mask, this will take a while. "
              "But don't worry, it only run once for each split.")
        new_ids = []
        for img_id in ids:
            meta = self.imgs[img_id]
            mask = self._gen_seg_mask(self.anns_by_img.get(img_id, []),
                                      meta["height"], meta["width"])
            if (mask > 0).sum() > 1000:
                new_ids.append(img_id)
        print("Found number of qualified images: ", len(new_ids))
        np.save(ids_file, np.asarray(new_ids, np.int64))
        return new_ids

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        from PIL import Image

        img_id = self.ids[index]
        meta = self.imgs[img_id]
        img = _open_rgb(os.path.join(self.img_dir, meta["file_name"]))
        target = Image.fromarray(self._gen_seg_mask(
            self.anns_by_img.get(img_id, []),
            meta["height"], meta["width"]))
        sample = {"image": img, "label": target}
        if self.split == "train":
            return self._tr(sample, rng)
        if self.split == "val":
            return self._val(sample, rng)
        raise ValueError(self.split)


class CombineDBs:
    """combine_dbs.py:4-56."""
    NUM_CLASSES = 21

    def __init__(self, dataloaders, excluded=None):
        self.dataloaders = dataloaders
        self.excluded = excluded
        im_ids: List[str] = []
        for dl in dataloaders:
            for elem in dl.im_ids:
                if elem not in im_ids:
                    im_ids.append(elem)
        if excluded:
            for dl in excluded:
                for elem in dl.im_ids:
                    if elem in im_ids:
                        im_ids.remove(elem)
        self.cat_list: List[Dict] = []
        new_im_ids: List[str] = []
        for ii, dl in enumerate(dataloaders):
            for jj, curr_im_id in enumerate(dl.im_ids):
                if curr_im_id in im_ids and curr_im_id not in new_im_ids:
                    new_im_ids.append(curr_im_id)
                    self.cat_list.append({"db_ii": ii, "cat_ii": jj})
        self.im_ids = new_im_ids
        print(f"Combined number of images: {len(new_im_ids):d}")

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        entry = self.cat_list[index]
        dl = self.dataloaders[entry["db_ii"]]
        return dl.__getitem__(entry["cat_ii"], rng=rng)

    def __len__(self) -> int:
        return len(self.cat_list)

    def __str__(self) -> str:
        return ("Included datasets:" + str([str(d) for d in self.dataloaders])
                + "\nExcluded datasets:"
                + str([str(d) for d in (self.excluded or [])]))


def make_data_loader(args, seed: int = 0):
    """dataloaders/__init__.py:4-41 -> (train, val, test, nclass): the train
    loader shuffled with its last short batch dropped, the others in order
    and whole (the reference's drop_last=False).  ``batch_size`` is the
    global batch: under data parallelism every loader loads this
    process's share of each batch, and the eval loaders drop a tail batch
    too (it could not be shared evenly), as the JAX package's do over
    several processes."""
    world = dp.world_size()

    def loader(ds, shuffle):
        drop = shuffle or world > 1
        tail = len(ds) % args.batch_size
        if drop and not shuffle and tail:
            print(f"[multi-process DP] dropping the {tail}"
                  f"-sample eval tail of {ds.__class__.__name__} "
                  f"({len(ds)} % batch {args.batch_size})")
        return DataLoader(ds, batch_size=args.batch_size, shuffle=shuffle,
                          drop_last=drop, seed=seed,
                          prefetch=min(2, args.workers),
                          process_index=dp.rank(), process_count=world)

    if args.dataset == "pascal":
        train_set = VOCSegmentation(args, split="train")
        val_set = VOCSegmentation(args, split="val")
        if args.use_sbd:
            sbd_train = SBDSegmentation(args, split=["train", "val"])
            train_set = CombineDBs([train_set, sbd_train],
                                   excluded=[val_set])
        return (loader(train_set, True), loader(val_set, False), None,
                train_set.NUM_CLASSES)
    if args.dataset == "cityscapes":
        train_set = CityscapesSegmentation(args, split="train")
        val_set = CityscapesSegmentation(args, split="val")
        test_set = CityscapesSegmentation(args, split="test")
        return (loader(train_set, True), loader(val_set, False),
                loader(test_set, False), train_set.NUM_CLASSES)
    if args.dataset == "coco":
        train_set = COCOSegmentation(args, split="train")
        val_set = COCOSegmentation(args, split="val")
        return (loader(train_set, True), loader(val_set, False), None,
                train_set.NUM_CLASSES)
    raise NotImplementedError(args.dataset)
