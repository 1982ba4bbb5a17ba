"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` source into one shared
library with a plain C interface, under ``build/seg2eye_kernels/<hash>/`` at
the root of the checkout, keyed by a hash of the sources and flags so that
an edited source rebuilds.  The library is loaded with ``ctypes``.  Nothing
here runs at import time: the CPU tests import every module on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "seg2eye_kernels"
LIB_NAME = "libseg2eye_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# int fn(int device, 7 input pointers, out, N, H, W, C, float eps, stream)
_SPADE_STYLE_ARGTYPES = [_I] + [_P] * 8 + [_I] * 4 + [_F, _P]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact build exists; -> library path.
    ptxas's register and shared-memory report is kept in ``ptxas.txt``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process, with every C signature
    declared (an undeclared pointer argument would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name in ("spade_style_fwd_f32", "spade_style_fwd_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = _SPADE_STYLE_ARGTYPES
        fn.restype = ctypes.c_int
    lib.seg2eye_cuda_error_string.argtypes = [ctypes.c_int]
    lib.seg2eye_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.seg2eye_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
