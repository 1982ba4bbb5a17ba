"""Legacy eye-image augmentation pipeline (the port's copy of
``seg2eye_tpu/data/augment.py``; reference: data/preprocessor.py:158-273
``Preprocessor``).

Vestigial in the reference's OpenEDS entry points (no dataset constructs it
with do_augmentation=True) but part of its public data API — the
difficulty-scaled augmentation recipe its gaze-estimation lineage used.
Host-side, on uint8 numpy images; all randomness flows through an
explicit ``numpy.random.Generator`` instead of the reference's global
``np.random``, so one seed draws what the JAX package's Augmenter draws.
``cv2`` is imported inside the functions (the card's machine has none);
without it the rescale and the blur leave the image as it is, as in the
JAX package.

Behavioral parity notes:
  * ``_value_from_type``: easy + (hard-easy)·difficulty, clipped to the
    range in either orientation (:258-266); the 'rescale' range is
    inverted on purpose (easy 1.0 -> no rescale, hard 0.2).
  * ``rescale``: random downscale by U(rescale_max, 1), INTER_CUBIC, then
    equalize and cubic-resize back to the original size (:215-227).
  * ``rgb_noise``: int16 additive uniform noise then a min-max renormalize
    to [0,255] (:229-240) — note the renormalize runs whenever the
    intensity bound is > 0, matching cv.normalize on the noisy image.
  * ``blur``: one N(0,1) draw scales the difficulty value; Gaussian (7,7)
    kernel with sigma 0.5+|draw·value| when positive (:242-247).  (The
    reference's ``_noisy_value_from_type`` builds and immediately pops a
    fresh normal-sample list per call — effectively one draw, :268-273.)
  * 'translation' and 'scale' ranges exist in the table for API parity;
    like the reference, ``augment`` does not consume them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from seg2eye_tpu_torch.data.preprocessor import _cv2, equalize

AUGMENTATION_RANGES = {          # (easy, hard), preprocessor.py:173-179
    "translation": (2.0, 10.0),
    "intensity": (0.5, 20.0),
    "blur": (0.1, 1.0),
    "scale": (0.01, 0.1),
    "rescale": (1.0, 0.2),
}


class Augmenter:
    """Difficulty-scaled eye-image augmentation (Preprocessor parity)."""

    # visual-vs-optical axis offset in degrees (diff_pitch, diff_yaw);
    # positive pitch = further up, positive yaw = further left (:181-186)
    kappa_tuning = (2, 5)

    def __init__(self, do_augmentation: bool,
                 eye_image_shape: Tuple[int, int] = (72, 120),
                 difficulty: float = 1.0,
                 kappa_augment_labels: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.do_augmentation = do_augmentation
        self.eye_image_shape = eye_image_shape            # (H, W)
        self.difficulty = difficulty
        self.kappa_augment_labels = kappa_augment_labels
        self.rng = rng if rng is not None else np.random.default_rng(0)

    # ------------------------------------------------------------------ #
    def value_from_type(self, augmentation_type: str) -> float:
        easy, hard = AUGMENTATION_RANGES[augmentation_type]
        value = (hard - easy) * self.difficulty + easy
        lo, hi = (easy, hard) if easy < hard else (hard, easy)
        return float(np.clip(value, lo, hi))

    def noisy_value_from_type(self, augmentation_type: str) -> float:
        return float(self.rng.normal()) * self.value_from_type(
            augmentation_type)

    # ------------------------------------------------------------------ #
    def rescale(self, eye: np.ndarray) -> np.ndarray:
        """Random down-up rescale roundtrip (:215-227)."""
        rescale_max = self.value_from_type("rescale")
        cv2 = _cv2()
        if rescale_max >= 1.0 or cv2 is None:
            return eye
        factor = float(self.rng.uniform(rescale_max, 1.0))
        h, w = self.eye_image_shape
        small = cv2.resize(eye, dsize=(0, 0), fx=factor, fy=factor,
                           interpolation=cv2.INTER_CUBIC)
        small = equalize(small)
        return cv2.resize(small, dsize=(w, h),
                          interpolation=cv2.INTER_CUBIC)

    def rgb_noise(self, eye: np.ndarray) -> np.ndarray:
        """Additive int noise + min-max renormalize to [0,255] (:229-240)."""
        bound = int(self.value_from_type("intensity"))
        if bound <= 0:
            return eye
        noisy = eye.astype(np.int16) + self.rng.integers(
            -bound, bound, size=eye.shape, dtype=np.int16)
        noisy = noisy.astype(np.float32)
        lo, hi = noisy.min(), noisy.max()
        noisy = (noisy - lo) * (255.0 / max(hi - lo, 1e-6))
        return noisy.astype(np.uint8)

    def blur(self, eye: np.ndarray) -> np.ndarray:
        """Gaussian blur with a noise-scaled sigma (:242-247)."""
        blur_noise = self.noisy_value_from_type("blur")
        cv2 = _cv2()
        if blur_noise <= 0 or cv2 is None:
            return eye
        return cv2.GaussianBlur(eye, (7, 7), 0.5 + abs(blur_noise))

    def augment(self, eye: np.ndarray) -> np.ndarray:
        """rescale -> rgb_noise -> blur (:249-255)."""
        eye = self.rescale(eye)
        eye = self.rgb_noise(eye)
        eye = self.blur(eye)
        return eye

    def __call__(self, eye: np.ndarray) -> np.ndarray:
        return self.augment(eye) if self.do_augmentation else eye

    # ------------------------------------------------------------------ #
    @staticmethod
    def headpose_to_radians(head_pose) -> np.ndarray:
        """(pitch, yaw, _) degrees in the UnityEyes convention ->
        sign-corrected radians (:204-213).  Accepts the tuple directly (the
        reference eval()s it out of a JSON dict)."""
        h_pitch, h_yaw = float(head_pose[0]), float(head_pose[1])
        if h_pitch > 180.0:
            h_pitch -= 360.0
        h_yaw -= 180.0
        return np.asarray([np.radians(-h_pitch), np.radians(-h_yaw)],
                          dtype=np.float32)
