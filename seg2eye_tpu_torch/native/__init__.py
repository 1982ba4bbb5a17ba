"""Native (C++) batch assembly of the OpenEDS loader (counterpart of
``seg2eye_tpu/native``).

``assemble_images(images, flips)`` turns n uint8 (H,W) images into the
(n,H,W,1) float32 batch in [-1, 1] (x / 127.5 - 1, the same float32 as
the loader's (x / 255 - 0.5) / 0.5 for every uint8 value), each image
flipped or not, in one pass; ``assemble_masks`` stacks uint8 masks with
the same flips.  ``assemble_images_plain`` and ``assemble_masks_plain``
are the numpy versions, which the tests hold the library to.

At first use ``g++ -O3 -shared -fPIC`` compiles ``fastbatch.cc`` under
``build/seg2eye_native/<hash>/`` at the root of the checkout, keyed by a
hash of the source and flags, and the library is loaded with ``ctypes``.
A build or load that fails raises with the compiler's output: there is no
fallback to the numpy versions.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastbatch.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "seg2eye_native"
LIB_NAME = "libfastbatch.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_ARGTYPES = [ctypes.POINTER(_U8P), _U8P, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p]


def build(source: Path = SOURCE, root: Path = BUILD_ROOT) -> Path:
    """Compile ``source`` unless this exact build exists; -> library path.
    A failed compile raises with the compiler's output."""
    source = Path(source)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out_dir = Path(root) / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native batch "
                           "assembly cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """A built library with both C signatures declared."""
    lib = ctypes.CDLL(str(path))
    for name in ("assemble_images", "assemble_masks"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = None
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return load(build(SOURCE, BUILD_ROOT))


def _call(name: str, arrays: List[np.ndarray], flips, out_dtype,
          out_shape) -> np.ndarray:
    arrays = [np.ascontiguousarray(a, dtype=np.uint8) for a in arrays]
    n = len(arrays)
    h, w = arrays[0].shape
    if any(a.shape != (h, w) for a in arrays):
        raise ValueError(f"{name}: every array must be ({h}, {w}), got "
                         f"{[a.shape for a in arrays]}")
    flips_u8 = np.ascontiguousarray(
        flips if flips is not None else [0] * n, dtype=np.uint8)
    if flips_u8.shape != (n,):
        raise ValueError(f"{name}: {n} arrays but flips of shape "
                         f"{flips_u8.shape}")
    ptrs = (_U8P * n)(*(a.ctypes.data_as(_U8P) for a in arrays))
    dst = np.empty(out_shape(n, h, w), out_dtype)
    getattr(library(), name)(ptrs, flips_u8.ctypes.data_as(_U8P), n, h, w,
                             dst.ctypes.data)
    return dst


def assemble_images(images: List[np.ndarray],
                    flips: Optional[Sequence[bool]] = None) -> np.ndarray:
    """n uint8 (H,W) images -> (n,H,W,1) float32 in [-1,1], per-image flip."""
    return _call("assemble_images", images, flips, np.float32,
                 lambda n, h, w: (n, h, w, 1))


def assemble_masks(masks: List[np.ndarray],
                   flips: Optional[Sequence[bool]] = None) -> np.ndarray:
    """n uint8 (H,W) class-id masks -> (n,H,W) uint8, per-mask flip."""
    return _call("assemble_masks", masks, flips, np.uint8,
                 lambda n, h, w: (n, h, w))


def assemble_images_plain(images: List[np.ndarray],
                          flips: Optional[Sequence[bool]] = None
                          ) -> np.ndarray:
    """The numpy version of ``assemble_images``."""
    flips = flips if flips is not None else [False] * len(images)
    out = np.empty((len(images), *images[0].shape, 1), np.float32)
    for i, im in enumerate(images):
        x = im[:, ::-1] if flips[i] else im
        out[i, ..., 0] = x.astype(np.float32) / 127.5 - 1.0
    return out


def assemble_masks_plain(masks: List[np.ndarray],
                         flips: Optional[Sequence[bool]] = None
                         ) -> np.ndarray:
    """The numpy version of ``assemble_masks``."""
    flips = flips if flips is not None else [False] * len(masks)
    return np.stack([m[:, ::-1] if f else m for m, f in zip(masks, flips)])
