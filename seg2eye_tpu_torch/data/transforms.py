"""Load-time transforms of the OpenEDS loader (counterpart of
``seg2eye_tpu/data/transforms.py``; reference data/base_dataset.py:25-80).

  * ``get_params``: per-sample crop position and flip coin, drawn in the
    JAX package's order from the sample's numpy generator.
  * ``apply_spatial``: the spatial part of every ``preprocess_mode``:
    resize_and_crop, crop, scale_width[_and_crop],
    scale_shortside[_and_crop], fixed (W = crop, H = crop / aspect) and
    none (sides rounded to multiples of 32); a crop position past the
    resized extent is clamped, and an extent below ``crop_size`` padded
    with zeros.
  * Resizes: bicubic through PIL (which antialiases, as the reference's
    PIL path does) for images, cv2 nearest for masks.
  * Transport: uint8 (``device_normalize``, the default; the model
    normalises on the device), or float32 in [-1, 1] on the host
    (``--no_device_normalize``): (x / 255 - 0.5) / 0.5.
  * ``ResizeCache``: a byte-capped LRU of the 'fixed'-mode resizes
    (``resize_for_fixed``), which ``finish_image``/``finish_image_u8`` and
    ``assemble_u8`` (or ``native.assemble_images``) flip and normalise.

cv2 and PIL are imported inside the resize.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Hashable, List

import numpy as np


class ResizeCache:
    """Byte-capped LRU cache of deterministic host work (H5 read + resize),
    keyed by (user, dataset key, index); a copy of the JAX package's.

    The value is the pre-flip, pre-normalise resized uint8 image, and in
    'fixed' mode the resize target is fixed for the run, so the cached and
    uncached paths give the same bytes.  ``produce`` runs outside the lock
    (slow I/O); if another thread inserted the key meanwhile, its value is
    kept and returned, and counted once."""

    def __init__(self, limit_mb: int):
        self.limit = int(limit_mb) << 20
        self.size = 0
        self._d: "collections.OrderedDict[Hashable, np.ndarray]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, produce: Callable[[], np.ndarray]
            ) -> np.ndarray:
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self.hits += 1
                self._d.move_to_end(key)
                return v
            self.misses += 1
        v = produce()
        with self._lock:
            racer = self._d.get(key)
            if racer is not None:
                self._d.move_to_end(key)
                return racer
            self._d[key] = v
            self.size += v.nbytes
            while self.size > self.limit and self._d:
                _, old = self._d.popitem(last=False)
                self.size -= old.nbytes
        return v


def get_params(opt, rng: np.random.Generator, size: tuple = None) -> Dict:
    """{"crop_pos": (x, y), "flip": bool}; ``size`` is the source (w, h)
    that the *_and_crop modes scale from."""
    w, h = size if size is not None else (opt.image_width, opt.image_height)
    new_w, new_h = w, h
    mode = opt.preprocess_mode
    if mode == "resize_and_crop":
        new_w = new_h = opt.load_size
    elif mode == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    elif mode == "scale_shortside_and_crop":
        ss, ls = min(w, h), max(w, h)
        ls = int(opt.load_size * ls / ss)
        new_w, new_h = (ss, ls) if w == ss else (ls, ss)
    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    flip = False
    if not opt.no_flip and opt.isTrain:
        flip = bool(rng.random() > 0.5)
    return {"crop_pos": (x, y), "flip": flip}


def resize(img: np.ndarray, w: int, h: int, is_mask: bool) -> np.ndarray:
    """(h, w) resize: masks nearest (cv2), images bicubic (PIL), per
    channel for a multi-channel image."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if is_mask:
        import cv2
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    from PIL import Image

    def one(a):
        return np.asarray(Image.fromarray(a).resize((w, h), Image.BICUBIC))

    if img.ndim == 2:
        return one(img)
    return np.stack([one(img[..., c]) for c in range(img.shape[-1])], -1)


def apply_spatial(img: np.ndarray, opt, params: Dict,
                  is_mask: bool) -> np.ndarray:
    """Resize, crop and flip of ``opt.preprocess_mode``."""
    mode = opt.preprocess_mode
    h, w = img.shape[:2]
    if "resize" in mode:
        img = resize(img, opt.load_size, opt.load_size, is_mask)
    elif "scale_width" in mode:
        if w != opt.load_size:
            img = resize(img, opt.load_size, opt.load_size * h // w, is_mask)
    elif "scale_shortside" in mode:
        ss, ls = min(w, h), max(w, h)
        if ss != opt.load_size:
            ls = int(opt.load_size * ls / ss)
            nw, nh = (opt.load_size, ls) if w == ss else (ls, opt.load_size)
            img = resize(img, nw, nh, is_mask)

    if "crop" in mode:
        x, y = params.get("crop_pos", (0, 0))
        y = min(y, max(0, img.shape[0] - opt.crop_size))
        x = min(x, max(0, img.shape[1] - opt.crop_size))
        img = img[y:y + opt.crop_size, x:x + opt.crop_size]
        ph = opt.crop_size - img.shape[0]
        pw = opt.crop_size - img.shape[1]
        if ph > 0 or pw > 0:
            pad = [(0, max(0, ph)), (0, max(0, pw))]
            pad += [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad)

    if mode == "none":
        base = 32
        nh = int(round(img.shape[0] / base) * base)
        nw = int(round(img.shape[1] / base) * base)
        if (nh, nw) != img.shape[:2]:
            img = resize(img, nw, nh, is_mask)

    if mode == "fixed":
        img = resize(img, opt.image_width, opt.image_height, is_mask)

    if params.get("flip"):
        img = img[:, ::-1]
    return img


def spatial_image(img: np.ndarray, opt, params: Dict) -> np.ndarray:
    """The spatial transform of an image, dtype kept (uint8 transport)."""
    return apply_spatial(img, opt, params, is_mask=False)


def normalize(img: np.ndarray) -> np.ndarray:
    """(h,w) image -> (h,w,1) float32 in [-1, 1] (ToTensor +
    Normalize(0.5, 0.5))."""
    out = img.astype(np.float32) / 255.0
    return np.ascontiguousarray((out - 0.5) / 0.5)[..., None]


def transform_image(img: np.ndarray, opt, params: Dict) -> np.ndarray:
    """(H,W) image -> (h,w,1) float32 in [-1, 1]."""
    return normalize(spatial_image(img, opt, params))


def resize_for_fixed(img: np.ndarray, opt) -> np.ndarray:
    """The 'fixed'-mode image resize (W = crop, H = crop / aspect): the unit
    that ``ResizeCache`` stores."""
    return resize(img, opt.image_width, opt.image_height, False)


def _flipped(img: np.ndarray, params: Dict) -> np.ndarray:
    return img[:, ::-1] if params.get("flip") else img


def finish_image(resized: np.ndarray, params: Dict) -> np.ndarray:
    """The flip and normalisation that follow ``resize_for_fixed``."""
    return normalize(_flipped(resized, params))


def finish_image_u8(resized: np.ndarray, params: Dict) -> np.ndarray:
    """The flip that follows ``resize_for_fixed`` (uint8 transport)."""
    return np.ascontiguousarray(_flipped(resized, params))[..., None]


def assemble_u8(resized: List[np.ndarray], flip: bool) -> np.ndarray:
    """n resized uint8 (h,w) images -> (n,h,w,1) uint8 with a shared flip:
    the uint8 companion of ``native.assemble_images``."""
    return np.stack([_flipped(im, {"flip": flip})
                     for im in resized])[..., None]


def transform_mask(mask: np.ndarray, opt, params: Dict) -> np.ndarray:
    """(H,W) class-id mask -> (h,w), nearest resize, not normalised."""
    return np.ascontiguousarray(apply_spatial(mask, opt, params,
                                              is_mask=True))


def transform_images(imgs: List[np.ndarray], opt, params: Dict
                     ) -> np.ndarray:
    """n (H,W) images sharing ``params`` -> (n,h,w,1): uint8 images stay
    uint8 under ``opt.device_normalize``, else ``transform_image`` each
    (the JAX package's native x / 127.5 - 1 for 'fixed' references gives
    the same float32 for every uint8 value)."""
    if opt.device_normalize and imgs[0].dtype == np.uint8:
        return np.stack([spatial_image(im, opt, params)
                         for im in imgs])[..., None]
    return np.stack([transform_image(im, opt, params) for im in imgs])
