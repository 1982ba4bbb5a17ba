"""Host-side image pre/post-processing (the port's copy of
``seg2eye_tpu/data/preprocessor.py``; reference: data/preprocessor.py and
data/postprocessor.py): range-sniffing normalize/unnormalize, batch
reshaping, histogram equalization and error maps, in numpy.  The scored
path runs on the device (``ops.image``); these cover the host-side API.

``cv2`` is imported inside the functions that use it (the card's machine
has none); without it ``equalize`` and ``preprocess_eye``'s resize leave
the image as it is, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np


def _cv2():
    """``cv2``, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


EPS = 1e-6


def as_batch(image: np.ndarray) -> np.ndarray:
    """(H,W[,C]) -> (1,H,W,C); (B,H,W,C) passes through
    (postprocessor.py:15-24, NHWC here)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[None, ..., None]
    elif image.ndim == 3:
        image = image[None]
    if image.ndim != 4:
        raise ValueError(f"Image has too many dimensions: {image.ndim}")
    return image


def unnormalize(image: np.ndarray) -> np.ndarray:
    """Range-sniffing conversion to [0,255] ints (postprocessor.py:56-72):
    [-1,1] -> (x+1)*255/2; label maps ([0,4)) -> /3*255; [0,255] unchanged.
    Truncates like torch's .int()."""
    image = np.asarray(image, np.float64)
    mn, mx = image.min(), image.max()
    if mn >= -1 - EPS and mx <= 1 + EPS:
        image = (image + 1.0) * 255.0 / 2.0
    elif mn >= 0 and mx < 4:
        image = image / 3.0 * 255.0
    elif mn >= 0 and mx <= 255:
        pass
    else:
        raise ValueError(f"Invalid ranges for image. Min: {mn}, max: {mx}")
    return np.trunc(image).astype(np.int32)


def normalize(image: np.ndarray) -> np.ndarray:
    """Range-sniffing [0,max] -> [-1,1] (postprocessor.py:75-89)."""
    image = np.asarray(image, np.float32)
    mn, mx = image.min(), image.max()
    if mn >= -1 - EPS and mx <= 1 + EPS:
        return image
    if mn >= 0:
        return image / max(mx, EPS) * 2.0 - 1.0
    raise ValueError(f"Invalid ranges for image. Min: {mn}, max: {mx}")


def equalize(image_u8: np.ndarray) -> np.ndarray:
    """Histogram equalization (preprocessor.py equalize): grayscale via
    cv2.equalizeHist; color via the YCrCb luma channel (preprocessor.py
    :19-27 — 'proper colour image intensity equalization')."""
    cv2 = _cv2()
    if cv2 is None:
        return image_u8
    image_u8 = np.asarray(image_u8, np.uint8)
    if image_u8.ndim == 2:
        return cv2.equalizeHist(image_u8)
    if image_u8.shape[-1] == 1:  # channel-trailing grayscale
        return cv2.equalizeHist(image_u8[..., 0])[..., None]
    ycrcb = cv2.cvtColor(image_u8, cv2.COLOR_RGB2YCrCb)
    ycrcb[:, :, 0] = cv2.equalizeHist(ycrcb[:, :, 0])
    return cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2RGB)


# ImageNet statistics the reference's vgg_transform hardcodes
# (preprocessor.py:14-15)
VGG_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
VGG_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def vgg_normalize(image: np.ndarray) -> np.ndarray:
    """Per-channel ImageNet normalize of (..., H, W, 3) float images in
    [0,1] (preprocessor.py vgg_normalize — NHWC here, not CHW)."""
    return (np.asarray(image, np.float32) - VGG_MEAN) / VGG_STD


def to_range01(image: np.ndarray) -> np.ndarray:
    """[-1,1] -> [0,1] (preprocessor.py toRange01; like the reference it
    warns rather than errors on out-of-range input)."""
    image = np.asarray(image, np.float32)
    if image.min() < -1 or image.max() > 1:
        print(f"Tensor not in range [-1, 1]. Min: {image.min()}, "
              f"max: {image.max()}")
    return (image + 1.0) / 2.0


def gray2rgb(image: np.ndarray) -> np.ndarray:
    """(H,W) -> (H,W,3) by channel repeat (preprocessor.py gray2rgb)."""
    return np.repeat(np.expand_dims(image, axis=2), 3, axis=2)


def rgb2gray(image: np.ndarray) -> np.ndarray:
    """(H,W,3) -> channel-mean grayscale, re-expanded to 3 channels
    (preprocessor.py rgb2gray returns gray2rgb of the mean)."""
    return gray2rgb(np.mean(image, axis=2))


def preprocess_eye(image: np.ndarray, width: int = 60,
                   height: int = 36) -> np.ndarray:
    """The legacy gaze-net input pipeline (preprocessor.py preprocess):
    cubic-rescale to (height,width) if needed, equalize, then the
    x*2/255-1 normalize.  Returns float32 HW[C] (NHWC-native — the
    reference's trailing hwc2chw existed for torch)."""
    image = np.asarray(image)
    cv2 = _cv2()
    if image.shape[:2] != (height, width) and cv2 is not None:
        image = cv2.resize(image, dsize=(width, height),
                           interpolation=cv2.INTER_CUBIC)
    image = equalize(image)
    out = image.astype(np.float32) * 2.0 / 255.0 - 1.0
    return out.astype(np.float32)


def get_error_map(fake: np.ndarray, target: np.ndarray) -> np.ndarray:
    """abs error rescaled to [-1,1] (postprocessor.py:124-130)."""
    assert fake.shape == target.shape
    err = np.abs(np.asarray(fake, np.float32) -
                 np.asarray(target, np.float32))
    return err / max(err.max(), EPS) * 2.0 - 1.0
