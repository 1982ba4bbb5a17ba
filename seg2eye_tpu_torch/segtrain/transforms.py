"""Host-side PIL/numpy transforms of the segmentation trainer (a copy of
``seg2eye_tpu/segtrain/transforms.py``; reference: refinenet/deeplab/
dataloaders/custom_transforms.py).

  * random horizontal flip, p 0.5;
  * random scale crop: the short edge resized to randint[0.5 base,
    2 base] (both ends included), padded right and bottom to crop_size
    (the mask with ``fill``, 255 for cityscapes), then a random crop;
  * random Gaussian blur, p 0.5, radius U[0, 1);
  * fix scale crop: the short edge to crop_size, then a center crop;
  * fixed resize to (size, size);
  * normalize: /255, -mean, /std.

Each transform is ``f(sample, rng) -> sample`` over PIL images, and
``compose`` threads one ``np.random.Generator`` through a chain, so a
sample is the JAX package's byte for byte.  The terminal transform gives
an HWC float32 image and an HW float32 label; the trainer moves the
batch to the card and lays it out NCHW there.  PIL is imported inside
the functions: the card's machine has none, and the port imports without
it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def compose(transforms: List[Callable]) -> Callable:
    def run(sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng()
        for t in transforms:
            sample = t(sample, rng)
        return sample
    return run


def random_horizontal_flip(sample: Dict, rng) -> Dict:
    from PIL import Image

    if rng.random() < 0.5:
        return {"image": sample["image"].transpose(Image.FLIP_LEFT_RIGHT),
                "label": sample["label"].transpose(Image.FLIP_LEFT_RIGHT)}
    return sample


def random_gaussian_blur(sample: Dict, rng) -> Dict:
    from PIL import ImageFilter

    img = sample["image"]
    if rng.random() < 0.5:
        img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
    return {"image": img, "label": sample["label"]}


def random_scale_crop(base_size: int, crop_size: int, fill: int = 0
                      ) -> Callable:
    def t(sample: Dict, rng) -> Dict:
        from PIL import Image, ImageOps

        img, mask = sample["image"], sample["label"]
        # random.randint includes both ends (custom_transforms.py:98)
        short_size = int(rng.integers(int(base_size * 0.5),
                                      int(base_size * 2.0) + 1))
        w, h = img.size
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        if short_size < crop_size:
            padh = crop_size - oh if oh < crop_size else 0
            padw = crop_size - ow if ow < crop_size else 0
            img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
            mask = ImageOps.expand(mask, border=(0, 0, padw, padh),
                                   fill=fill)
        w, h = img.size
        x1 = int(rng.integers(0, w - crop_size + 1))
        y1 = int(rng.integers(0, h - crop_size + 1))
        img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        mask = mask.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        return {"image": img, "label": mask}
    return t


def fix_scale_crop(crop_size: int) -> Callable:
    def t(sample: Dict, rng) -> Dict:
        from PIL import Image

        img, mask = sample["image"], sample["label"]
        w, h = img.size
        if w > h:
            oh = crop_size
            ow = int(1.0 * w * oh / h)
        else:
            ow = crop_size
            oh = int(1.0 * h * ow / w)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        w, h = img.size
        x1 = int(round((w - crop_size) / 2.0))
        y1 = int(round((h - crop_size) / 2.0))
        img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        mask = mask.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        return {"image": img, "label": mask}
    return t


def fixed_resize(size: int) -> Callable:
    def t(sample: Dict, rng) -> Dict:
        from PIL import Image

        img, mask = sample["image"], sample["label"]
        assert img.size == mask.size
        return {"image": img.resize((size, size), Image.BILINEAR),
                "label": mask.resize((size, size), Image.NEAREST)}
    return t


def normalize_to_arrays(mean: Tuple[float, ...] = IMAGENET_MEAN,
                        std: Tuple[float, ...] = IMAGENET_STD) -> Callable:
    """Terminal transform: PIL -> {'image': HWC float32 normalised,
    'label': HW float32}."""
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)

    def t(sample: Dict, rng) -> Dict:
        img = np.asarray(sample["image"], dtype=np.float32) / 255.0
        img = (img - mean_a) / std_a
        mask = np.asarray(sample["label"], dtype=np.float32)
        return {"image": img, "label": mask}
    return t


def train_transform(base_size: int, crop_size: int, fill: int = 0) -> Callable:
    """The train-split chain (pascal.py:84-92, cityscapes.py:81-89,
    coco.py:97-105, sbd.py:79-87)."""
    return compose([random_horizontal_flip,
                    random_scale_crop(base_size, crop_size, fill=fill),
                    random_gaussian_blur,
                    normalize_to_arrays()])


def val_transform(crop_size: int) -> Callable:
    """The val-split chain (pascal.py:94-101 etc.)."""
    return compose([fix_scale_crop(crop_size), normalize_to_arrays()])


def test_transform(crop_size: int) -> Callable:
    """The cityscapes test-split chain (cityscapes.py:100-107)."""
    return compose([fixed_resize(crop_size), normalize_to_arrays()])
