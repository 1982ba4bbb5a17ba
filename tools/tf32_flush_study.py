#!/usr/bin/env python3
"""Accuracy and time of the float32 (3xTF32) SPADE+Style kernel against the
number of taps that share one tensor-core accumulator, on one CUDA card.

    python3 tools/tf32_flush_study.py [--taps 9 3 1]

Each wgmma adds its products to the accumulator with less than float32's
round-to-nearest accuracy, so the error grows with the number of wgmmas
summed in one accumulator.  The kernel adds a fresh accumulator to a
float32 total every TF32_FLUSH_TAPS taps (``csrc/spade_style_sm90.cu``):
1 in the port, 9 for one accumulator over all 432 wgmmas of a warpgroup.
The port's library is the variant with its own value; each other value
gets a copy of the sources with that constant changed, built with the
port's nvcc flags under build/tf32_flush_study/.  Then every variant runs on
``chip_smoke.py``'s site inputs (the two odd shapes and the 18 crop-256
sites at N = 16) against the plain float32 version, and is timed in turns
with CUDA events.  Printed: per site and variant the max abs error, the
worst err/tolerance (``chip_smoke.py``'s float32 tolerance) and the median
ms; then per variant the worst over all sites and the 18-site sum of ms.
"""
import argparse
import contextlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (F32_TOL, ODD_SITES, SITE_N, SITES,  # noqa: E402
                        site_inputs, time_turns)
from seg2eye_tpu_torch.ops import _build  # noqa: E402
from seg2eye_tpu_torch.ops import spade_style as K  # noqa: E402


FLUSH = re.compile(r"constexpr int TF32_FLUSH_TAPS = (\d+);")


def build_variant(taps: int):
    """The kernels' library with TF32_FLUSH_TAPS = taps -> its path."""
    (src,) = _build.sources()
    text = src.read_text()
    if int(FLUSH.search(text).group(1)) == taps:
        return _build.build()
    out = _build.BUILD_ROOT.parent / "tf32_flush_study" / str(taps)
    out.mkdir(parents=True, exist_ok=True)
    (out / src.name).write_text(FLUSH.sub(
        f"constexpr int TF32_FLUSH_TAPS = {taps};", text))
    lib = out / _build.LIB_NAME
    proc = subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS,
                           "-o", str(lib), str(out / src.name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for TF32_FLUSH_TAPS = {taps}:\n"
                           f"{proc.stderr[-4000:]}")
    return lib


@contextlib.contextmanager
def launching_from(lib):
    """Inside, ``spade_style_cuda`` launches the kernels of ``lib``."""
    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--taps", type=int, nargs="+", default=[9, 3, 1],
                    choices=[1, 3, 9])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tf32_flush_study: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    with ThreadPoolExecutor(len(args.taps)) as pool:
        paths = list(pool.map(build_variant, args.taps))
    libs = {t: _build.load(p) for t, p in zip(args.taps, paths)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = dict.fromkeys(libs, 0.0)
    max_err = dict.fromkeys(libs, 0.0)
    total_ms = dict.fromkeys(libs, 0.0)
    print("(N, H, W, C)          " + "".join(
        f" | taps {t}: max_abs_err err/tol ms" for t in libs))
    for shape in ODD_SITES + [(SITE_N, *s) for s in SITES]:
        site = site_inputs(*shape, torch.float32, gen)
        x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = site
        want = K.spade_style_reference(*site)
        actv = K.seg_mlp_shared(seg, ws, bs).contiguous()
        wcat, bcat = K.pack_weights(wg, bg, wb, bb, torch.float32)

        def launch(lib):
            with launching_from(lib):
                return K.spade_style_cuda(x, actv, style, mean, var, wcat,
                                          bcat)

        line = f"{str(shape):22s}"
        errs = {}
        for t, lib in libs.items():
            err = (launch(lib) - want).abs()
            errs[t] = (float(err.max()),
                       float((err / (F32_TOL + F32_TOL * want.abs())).max()))
        times = time_turns([lambda lib=lib: launch(lib)
                            for lib in libs.values()])
        for (t, (e, w)), ms in zip(errs.items(), times):
            worst[t], max_err[t] = max(worst[t], w), max(max_err[t], e)
            if shape[0] == SITE_N:
                total_ms[t] += ms
            line += f" | {e:.3e} {w:.4f} {ms:.4f}"
        print(line, flush=True)
    for t in libs:
        print(f"TF32_FLUSH_TAPS = {t}: worst err/tolerance "
              f"{worst[t]:.4f}, max abs err {max_err[t]:.3e}, 18 sites at "
              f"N={SITE_N}: {total_ms[t]:.4f} ms")


if __name__ == "__main__":
    main()
