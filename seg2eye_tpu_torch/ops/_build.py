"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` source into one shared
library with a plain C interface, under ``build/seg2eye_kernels/<hash>/`` at
the root of the checkout, keyed by a hash of the sources and flags so that
an edited source rebuilds.  The library is loaded with ``ctypes``.  Beside
it the build keeps ptxas's report (``ptxas.txt``) and the SASS instruction
counts per kernel (``sass_counts.json``, from ``cuobjdump -sass``).
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
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
# int fn(int device, 7 input pointers, out, N, H, W, C, float eps, stream);
# each entry point encodes its TMA tensor maps from these in C
_SPADE_STYLE_ARGTYPES = [_I] + [_P] * 8 + [_I] * 4 + [_F, _P]
_SPADE_STYLE_ENTRY_POINTS = ("spade_style_fwd_f32_3xtf32_sm90",
                             "spade_style_fwd_bf16_sm90")
# the backward: int fn(int device, 8 input pointers, dx, dgb, partial, N, H,
# W, C, tiles, float eps, stream)
_BACKWARD_ARGTYPES = [_I] + [_P] * 11 + [_I] * 5 + [_F, _P]
_BACKWARD_ENTRY_POINTS = ("spade_style_bwd_bf16_sm90",)
SASS_OPCODES = ("HGMMA", "FFMA")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def cuda_tool(name: str) -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", name),
                 shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH); "
                       "the CUDA kernels cannot be built")


def sass_counts(sass: str) -> dict[str, dict[str, int]]:
    """``cuobjdump -sass`` text -> {kernel symbol: {opcode: count}} for the
    opcodes of ``SASS_OPCODES``."""
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = counts.setdefault(line.split("Function :")[1].strip(),
                                        dict.fromkeys(SASS_OPCODES, 0))
        elif current is not None and "/*" in line:
            body = line.split("*/", 1)[-1].split(";")[0].split()
            ops = [w for w in body if not w.startswith("@")]
            if ops:
                op = ops[0].split(".")[0]
                if op in current:
                    current[op] += 1
    return counts


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact build exists; -> library path.
    ptxas's register and shared-memory report is kept in ``ptxas.txt``, the
    SASS counts of ``sass_counts`` in ``sass_counts.json``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(tmp)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "sass_counts.json").write_text(
        json.dumps(sass_counts(sass), indent=1))
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded once per process."""
    return load(build())


def load(path: Path) -> ctypes.CDLL:
    """A built library with every C signature declared (an undeclared
    pointer argument would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(path))
    for names, argtypes in ((_SPADE_STYLE_ENTRY_POINTS, _SPADE_STYLE_ARGTYPES),
                            (_BACKWARD_ENTRY_POINTS, _BACKWARD_ARGTYPES)):
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.seg2eye_cuda_error_string.argtypes = [ctypes.c_int]
    lib.seg2eye_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.seg2eye_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
