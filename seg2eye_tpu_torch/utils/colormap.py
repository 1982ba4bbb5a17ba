"""Label colormaps (the port's copy of ``seg2eye_tpu/utils/colormap.py``;
reference: util/util.py:229-271, uint82bin / labelcolormap / Colorize):
the SPADE lineage's label-map rendering helpers, vectorised in numpy: the
per-bit XOR over all N ids at once, colorisation one LUT gather over
class-id arrays.  (The reference's N == 182 COCO branch reads a
``util.coco`` module its fork does not ship; left out, as in the JAX
package.)
"""
from __future__ import annotations

import numpy as np

# the 35-entry Cityscapes palette (util.py:236-242)
_CITYSCAPES_35 = np.asarray(
    [(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (111, 74, 0),
     (81, 0, 81), (128, 64, 128), (244, 35, 232), (250, 170, 160),
     (230, 150, 140), (70, 70, 70), (102, 102, 156), (190, 153, 153),
     (180, 165, 180), (150, 100, 100), (150, 120, 90), (153, 153, 153),
     (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35),
     (152, 251, 152), (70, 130, 180), (220, 20, 60), (255, 0, 0),
     (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
     (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142)], dtype=np.uint8)


def uint82bin(n: int, count: int = 8) -> str:
    """Binary string of ``n`` over ``count`` bits (util.py:229-231)."""
    return "".join(str((n >> y) & 1) for y in range(count - 1, -1, -1))


def label_colormap(n: int) -> np.ndarray:
    """(N, 3) uint8 palette (util.py labelcolormap).  N==35 returns the
    Cityscapes palette; otherwise the SPADE bit-interleaving scheme:
    channel c of id i XORs bit (3j+c) of (i+1) into bit (7-j), vectorized
    over all ids."""
    if n == 35:
        return _CITYSCAPES_35.copy()
    ids = np.arange(1, n + 1, dtype=np.int64)        # "give 0 a color"
    cmap = np.zeros((n, 3), np.uint8)
    for j in range(7):
        shifted = ids >> (3 * j)
        for c in range(3):
            bit = ((shifted >> c) & 1).astype(np.uint8)
            cmap[:, c] ^= (bit << (7 - j)).astype(np.uint8)
    return cmap


def colorize_labels(labels: np.ndarray, n: int) -> np.ndarray:
    """Class-id array (..., H, W) -> uint8 RGB (..., H, W, 3) via one LUT
    gather (util.py Colorize semantics: ids outside 0..N-1 render black —
    the reference's per-class masked writes leave them at zero; negative
    ids are routed to a guaranteed-black LUT row rather than python-wrapping
    into the palette)."""
    labels = np.asarray(labels, np.int64)
    hi = int(labels.max()) + 1 if labels.size else n
    lut = np.zeros((max(n, hi) + 1, 3), np.uint8)   # last row stays black
    lut[:n] = label_colormap(n)
    return lut[np.where(labels >= 0, labels, lut.shape[0] - 1)]
