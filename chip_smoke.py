#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seg2eye_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases; any failure raises and the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit
     (nvidia-smi), the torch / CUDA versions and the TF32 flags, which
     stay at PyTorch's defaults, as a user's process has them;
  2. build: compiles the CUDA kernels from the checkout's sources; prints
     ptxas's registers and spills and the HGMMA/FFMA counts of each
     kernel's SASS, and fails if a kernel has no HGMMA (tensor-core)
     instruction;
  3. kernel: the fused SPADE+Style kernels (bfloat16: one tensor-core
     pass, float32: 3xTF32) against their plain PyTorch version at all 18
     generator norm-site shapes of the default model (crop 256, batch 16,
     the shapes the slice gives it) and two odd shapes, then at the 18
     crop-512 site shapes (batch 2, correctness only), one gradient; at
     each crop-256 site the kernel, its plain version and one cuDNN conv
     (library_ms) timed in turns with CUDA events, beside the bound; at
     each float32 site, the error of a single-pass TF32 cuDNN conv of the
     same product (then the same epilogue) as a contrast;
  4. slice: scored inference (Tester.score_batch: encode, generate, resize
     to 640x400, truncate, per-image error) at the full width of the
     default model, seeded random weights, batch 16, in bfloat16 and
     float32; the kernel must launch once per norm site per forward.  The
     same batch then runs with every norm site on the plain version: fakes
     and errors must agree, and both routes are timed.  A batch-1 float32
     forward on the card must agree with the port's CPU forward on the same
     weights.  Nothing of JAX or of the JAX package may have been imported.
The port keeps float32 in full float32 by itself (its float32 forward and
plain versions turn TF32 off around their own convolutions); the cuDNN
calls this script makes directly set the flags around themselves.  The
last two lines are the kernel summary (one entry per kernel) and the
result, each one JSON object.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 16                 # scored-inference batch
SITE_N = BATCH             # batch of the per-site kernel checks
WARMUP, REPEATS = 3, 10
F32_TOL = 2e-4
GRAD_TOL = 5e-4
# bfloat16: the kernel keeps gamma|beta in float32 and rounds its result
# once; the plain version rounds gamma and beta to bfloat16 (relative
# 2^-9) before the epilogue and its result again.  So the two may differ by
# two ulps of the output (2^-6 relative) plus the gamma/beta rounding times
# |normalized x| (about 4 * 4 * 2^-9 < 2^-5 absolute at these inputs).
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -5
TOLS = {"float32": (F32_TOL, F32_TOL), "bfloat16": (BF16_RTOL, BF16_ATOL)}
CARD_VS_CPU_ATOL = 1e-3
# kernel route against plain route through the whole bs16 slice: (fake
# atol, per-image error rtol).  float32 (the port keeps TF32 off under
# PyTorch's default flags): both sum in float32 in different orders, about
# 1e-6 apart at the fake.  bfloat16: the kernel's
# float32 gamma|beta against the plain version's bfloat16 ones, at 18 sites
# in turn; that is a part of the bfloat16 rounding, which on an H100 moves
# the bs16 fakes by 2.5e-3 between bfloat16 and float32.
SLICE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}
EXPECTED_PARAMS = {"G": 92_460_481, "E": 6_529_632}
# (H, W, C) of the 18 norm sites of one generator forward at crop 256,
# aspect 0.8, ngf 64, in order: head_0, G_middle_0/1 (2 each), up_0..up_3
# (norm_s, norm_0, norm_1 each)
SITES = ([(10, 8, 1024)] * 2 + [(20, 16, 1024)] * 4
         + [(40, 32, 1024)] * 2 + [(40, 32, 512)]
         + [(80, 64, 512)] * 2 + [(80, 64, 256)]
         + [(160, 128, 256)] * 2 + [(160, 128, 128)]
         + [(320, 256, 128)] * 2 + [(320, 256, 64)])
ODD_SITES = [(1, 10, 8, 16), (2, 13, 7, 72)]  # (N, H, W, C), ragged tiles
CROP512_N = 2
# the H100 SXM's published dense peaks (NVIDIA's data sheet, at 700 W):
# the tensor cores' rate for the type each kernel feeds them (float32 runs
# on the TF32 rate, three passes per product), and the FP32 pipes' rate,
# printed beside the float32 bound
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PASSES = {"bfloat16": 1, "float32": 3}
FP32_PIPE_FLOPS = 67e12
PEAK_BYTES = 3.35e12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the kernel symbols of the library, per dtype
KERNEL_SYMBOLS = {"bfloat16": "spade_style_sm90_kernel",
                  "float32": "spade_style_3xtf32_sm90_kernel"}
SUMMARY_NAMES = {"bfloat16": "spade_style_bf16_sm90",
                 "float32": "spade_style_f32_3xtf32_sm90"}


def log(*args):
    print(*args, flush=True)


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def tf32(allowed: bool):
    """Both TF32 flags set to ``allowed`` around this script's own cuDNN
    calls, then restored."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = tf32_flags()
    cudnn.allow_tf32 = matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    cudnn, matmul = tf32_flags()
    log(f"TF32 flags left at PyTorch's defaults: cudnn.allow_tf32={cudnn}, "
        f"cuda.matmul.allow_tf32={matmul}")
    return torch.cuda.get_device_name(0)


# ---------------------------------------------------------------- phase 2
def phase_build():
    from seg2eye_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    # an Itanium-mangled identifier, per dtype
    mangled = {d: f"{len(k)}{k}" for d, k in KERNEL_SYMBOLS.items()}
    kernel = "?"
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = next((f"{d} {KERNEL_SYMBOLS[d]}" for d, m in
                           mangled.items() if m in line), "?")
            bn = line.split("ILi", 1)[-1].split("E", 1)[0]
            kernel += f"<{bn}>" if bn.isdigit() else ""
        elif any(k in line for k in ("registers", "spill", "Performance",
                                     "setmaxnreg", "wgmma")):
            log(f"  ptxas, {kernel}:",
                line.replace("ptxas info    :", "").strip())
    counts = json.loads((lib_path.parent / "sass_counts.json").read_text())
    for dtype, m in mangled.items():
        found = {k: v for k, v in counts.items() if m in k}
        if not found:
            raise AssertionError(f"no {KERNEL_SYMBOLS[dtype]} in the "
                                 "library's SASS")
        for symbol, ops in found.items():
            log(f"  SASS of the {dtype} kernel {symbol}: "
                + ", ".join(f"{op} {n}" for op, n in ops.items()))
            if not ops["HGMMA"]:
                raise AssertionError(f"{symbol} has no HGMMA instruction: "
                                     "it does not use the tensor cores")


# ---------------------------------------------------------------- phase 3
def site_inputs(n, h, w, c, dtype, gen):
    """Random site inputs on the card, scaled as the JAX package's kernel
    test makes them (weights and style 0.1 * N(0, 1), batch statistics)."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = r(n, h, w, c).to(dtype)
    label = torch.randint(0, 4, (n, h, w), generator=gen, device="cuda")
    seg = torch.nn.functional.one_hot(label, 4).float()
    var, mean = torch.var_mean(x.float(), dim=(0, 1, 2), correction=0)
    return [x, seg, r(n, 2 * c) * 0.1, mean.expand(n, c), var.expand(n, c),
            r(128, 4, 3, 3) * 0.1, r(128) * 0.1,
            r(c, 128, 3, 3) * 0.1, r(c) * 0.1,
            r(c, 128, 3, 3) * 0.1, r(c) * 0.1]


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    worst = float((err / bound).max())
    if not torch.isfinite(got).all() or worst > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with the plain version: max abs err "
            f"{float(err.max()):.3e}, worst err/tolerance {worst:.3f}")
    return float(err.max()), worst


def time_turns(fns):
    """Median ms of each no-argument function, timed in turns with CUDA
    events."""
    for _ in range(WARMUP):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(REPEATS):
        for fn, acc in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def site_bound(shape, dname):
    """(ms of the operations, ms of the bytes) at the card's peaks for the
    kernel's work at this site: the gamma|beta products at the tensor-core
    rate of the type (float32: TF32, three passes), and x read, out
    written, actv and the weights read once, at the memory rate.  The bound
    is the larger of the two."""
    n, h, w, c = shape
    item = DTYPES[dname].itemsize
    flops = 2 * n * h * w * 9 * 128 * 2 * c
    nbytes = n * h * w * (2 * c + 128) * item + 9 * 128 * 2 * c * item
    return (PASSES[dname] * flops / PEAK_FLOPS[dname] * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def tf32_contrast(args, want, rtol, atol):
    """(max abs err, worst err/tolerance) against the plain float32 version
    of the site computed with gamma|beta from one single-pass TF32 cuDNN
    conv of the same product, and the same float32 epilogue."""
    from seg2eye_tpu_torch.ops import spade_style as K

    x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = args
    c = x.shape[-1]
    actv = K.seg_mlp_shared(seg, ws, bs)
    with tf32(True):
        gb = F.conv2d(actv.permute(0, 3, 1, 2), torch.cat([wg, wb]),
                      torch.cat([bg, bb]), padding=1).permute(0, 2, 3, 1)
    out = K.spade_style_epilogue(x, gb[..., :c], gb[..., c:], style, mean,
                                 var)
    err = (out - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def phase_kernel():
    from seg2eye_tpu_torch.ops import spade_style as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dname in ("float32", "bfloat16"):
        dtype, (rtol, atol) = DTYPES[dname], TOLS[dname]
        log(f"kernel vs plain, {dname}, tolerance |err| <= {atol:.3g} + "
            f"{rtol:.3g} * |plain|; times in ms: the kernel alone, its plain "
            "version (from actv), one cuDNN conv of the same product "
            "(library), the bound; site = seg conv + kernel, as the slice "
            "runs it, against spade_style_reference")
        if dname == "float32":
            log("  float32: the bound is 3 TF32 passes at 495 TFLOP/s; "
                "fp32_pipe is the same products at the FP32 pipes' 67 "
                "TFLOP/s; tf32_err, tf32_e/t: a single-pass TF32 cuDNN conv "
                "of the same product against the plain version")
        log("  site  (N, H, W, C)         max_abs_err  err/tol    kernel   "
            "plain  library    bound  by   %bound  TFLOP/s    site  "
            "site_plain" + ("  fp32_pipe  tf32_err  tf32_e/t"
                            if dname == "float32" else ""))
        tot = dict(max_abs_err=0.0, worst=0.0, tf32_worst=0.0, ms=0.0,
                   plain_ms=0.0, library_ms=0.0, bound_ms=0.0, site_ms=0.0,
                   site_plain_ms=0.0, fp32_pipe_ms=0.0, bound_ops_ms=0.0,
                   bound_bytes_ms=0.0)
        for i, shape in enumerate(ODD_SITES + [(SITE_N, *s) for s in SITES]):
            args = site_inputs(*shape, dtype, gen)
            got = K.spade_style(*args)
            want = K.spade_style_reference(*args)
            torch.cuda.synchronize()
            err, worst = check_close(f"{dname} {shape}", got, want, rtol, atol)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["worst"] = max(tot["worst"], worst)
            contrast = ""
            if dname == "float32":
                t_err, t_worst = tf32_contrast(args, want, rtol, atol)
                tot["tf32_worst"] = max(tot["tf32_worst"], t_worst)
            x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = args
            actv = K.seg_mlp_shared(seg.to(dtype), ws, bs).contiguous()
            wcat, bcat = K.pack_weights(wg, bg, wb, bb, dtype)
            actv_nchw = actv.permute(0, 3, 1, 2)          # channels_last
            w_lib = torch.cat([wg, wb]).to(dtype).contiguous(
                memory_format=torch.channels_last)
            b_lib = torch.cat([bg, bb]).to(dtype)
            packed = K.PackedWeights()
            with tf32(False):     # the library conv in full float32
                kms, pms, lms, sms, spms = time_turns([
                    lambda: K.spade_style_cuda(x, actv, style, mean, var,
                                               wcat, bcat),
                    lambda: K.spade_style_from_actv(x, actv, style, mean,
                                                    var, wg, bg, wb, bb),
                    lambda: F.conv2d(actv_nchw, w_lib, b_lib, padding=1),
                    lambda: K.spade_style(*args, packed=packed),
                    lambda: K.spade_style_reference(*args)])
            ops_ms, bytes_ms = site_bound(shape, dname)
            bms = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            n, h, w, c = shape
            flops = 2 * n * h * w * 9 * 128 * 2 * c
            fp32_ms = flops / FP32_PIPE_FLOPS * 1e3
            if dname == "float32":
                contrast = f" {fp32_ms:10.4f} {t_err:9.3e} {t_worst:9.3f}"
            label = "odd" if i < len(ODD_SITES) else f"{i - 1:4d}"
            log(f"  {label}  {str(shape):22s} {err:11.3e}  {worst:7.3f} "
                f"{kms:8.4f} {pms:7.4f} {lms:8.4f} {bms:8.4f}  "
                f"{by[:3]}  {100 * bms / kms:6.1f}  "
                f"{flops / (kms * 1e-3) / 1e12:7.1f} "
                f"{sms:7.4f} {spms:8.4f}{contrast}")
            if i >= len(ODD_SITES):
                for key, v in (("ms", kms), ("plain_ms", pms),
                               ("library_ms", lms), ("bound_ms", bms),
                               ("site_ms", sms), ("site_plain_ms", spms),
                               ("fp32_pipe_ms", fp32_ms),
                               ("bound_ops_ms", ops_ms),
                               ("bound_bytes_ms", bytes_ms)):
                    tot[key] += v
            del args, got, want, actv, wcat, actv_nchw, packed
        tot["bound_by"] = ("operations" if tot.pop("bound_ops_ms")
                           >= tot.pop("bound_bytes_ms") else "bytes")
        log(f"  18 sites at N={SITE_N}, {dname} (sums of per-site medians): "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, "
            f"library {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} "
            f"({tot['bound_by']}), {100 * tot['bound_ms'] / tot['ms']:.1f}% "
            f"of the bound; site {tot['site_ms']:.4f}, site plain "
            f"{tot['site_plain_ms']:.4f}; worst err/tolerance "
            f"{tot['worst']:.4f} (odd shapes included)"
            + (f"; FP32-pipe bound {tot['fp32_pipe_ms']:.4f} ms; single-pass "
               f"TF32 worst err/tolerance {tot['tf32_worst']:.4f}"
               if dname == "float32" else ""))
        summary[dname] = tot

    # crop 512: the same sites with H and W doubled, correctness only
    for dname, dtype in DTYPES.items():
        rtol, atol = TOLS[dname]
        worst_all, err_all, tf32_worst = 0.0, 0.0, 0.0
        for h, w, c in SITES:
            shape = (CROP512_N, 2 * h, 2 * w, c)
            args = site_inputs(*shape, dtype, gen)
            got = K.spade_style(*args)
            want = K.spade_style_reference(*args)
            torch.cuda.synchronize()
            err, worst = check_close(f"crop 512 {dname} {shape}", got, want,
                                     rtol, atol)
            worst_all, err_all = max(worst_all, worst), max(err_all, err)
            if dname == "float32":
                tf32_worst = max(tf32_worst,
                                 tf32_contrast(args, want, rtol, atol)[1])
            del args, got, want
        log(f"crop 512, 18 sites at N={CROP512_N}, {dname}: max abs err "
            f"{err_all:.3e}, worst err/tolerance {worst_all:.4f}"
            + (f"; single-pass TF32 worst err/tolerance {tf32_worst:.4f}"
               if dname == "float32" else ""))

    # gradient: autograd.Function (kernel forward, recomputed backward)
    # against autograd of the plain version, float32; the plain version's
    # own backward convs run in full float32 too
    for shape in (ODD_SITES[0], (SITE_N, *SITES[0])):
        args = site_inputs(*shape, torch.float32, gen)
        grads = []
        for fn in (K.spade_style, K.spade_style_reference):
            leaves = [a.detach().clone().requires_grad_(i in (0, 2, 7))
                      for i, a in enumerate(args)]
            with tf32(False):
                (fn(*leaves) ** 2).sum().backward()
            grads.append([leaves[i].grad for i in (0, 2, 7)])
        for name, g_k, g_p in zip(("x", "style", "wg"), *grads):
            err, _ = check_close(f"grad {name} {shape}", g_k, g_p,
                                 GRAD_TOL, GRAD_TOL)
            log(f"  gradient in {name} at {shape}: max abs err {err:.3e}")
    return summary


# ---------------------------------------------------------------- phase 4
def make_batch(opt, b, seed=0):
    rng = np.random.default_rng(seed)
    h, w = opt.image_height, opt.image_width
    return {
        "label": rng.integers(0, opt.label_nc, (b, h, w)).astype(np.int32),
        "style_image": rng.integers(0, 256, (b, opt.input_ns, h, w, 1),
                                    dtype=np.uint8),
        "target_original": rng.integers(0, 256, (b, 640, 400, 1),
                                        dtype=np.uint8),
    }


def time_slice(tester, model, batch, repeats=5):
    """Median host-clock ms of one scored batch (the scores come back to
    the host, so each call ends synchronised)."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        tester.score_batch(model, batch, need_fake=False)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


@contextlib.contextmanager
def plain_norm_sites():
    """Every generator norm site runs spade_style_reference, the plain
    version, instead of the CUDA kernel."""
    from seg2eye_tpu_torch.models import normalization
    from seg2eye_tpu_torch.ops import spade_style as K

    kernel = normalization.spade_style
    normalization.spade_style = (
        lambda *args, packed=None: K.spade_style_reference(*args))
    try:
        yield
    finally:
        normalization.spade_style = kernel


def phase_slice():
    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.models.normalization import SpadeStyleBlock
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    opt = Options(isTrain=False).finalize()
    t0 = time.perf_counter()
    nets = init_networks(opt, torch.Generator().manual_seed(0), "cuda")
    counts = {k: sum(p.numel() for p in v.parameters())
              for k, v in nets.items()}
    log(f"default model (ngf {opt.ngf}, crop {opt.crop_size}, images "
        f"{opt.image_height}x{opt.image_width}, k={opt.input_ns}, "
        f"{opt.norm_G}): params G {counts['G']:,} E {counts['E']:,}, "
        f"seeded init {time.perf_counter() - t0:.1f} s")
    if counts != EXPECTED_PARAMS:
        raise AssertionError(f"parameter counts {counts} != {EXPECTED_PARAMS}")
    batch = make_batch(opt, BATCH)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda _m, a: shapes.append((a[0].shape[2], a[0].shape[3],
                                     a[0].shape[1])))
        for m in nets["G"].modules() if isinstance(m, SpadeStyleBlock)]

    launches, models, results = {}, {}, {}
    flags = tf32_flags()
    for dtype in ("bfloat16", "float32"):
        model = Pix2Pix(opt.replace(compute_dtype=dtype), nets, "cuda")
        models[dtype] = model
        tester = Tester(model.opt)
        tester.score_batch(model, batch, need_fake=False)       # warm-up
        shapes.clear()
        K.spade_style.launches = 0
        errors, fake = tester.score_batch(model, batch)
        count = K.spade_style.launches
        if shapes != SITES:
            raise AssertionError(f"norm sites ran at {shapes}, not {SITES}")
        if count != len(SITES):
            raise AssertionError(f"{dtype}: kernel launched {count} times in "
                                 f"one forward, expected {len(SITES)}")
        launches[dtype] = count
        if fake.shape != (BATCH, opt.image_height, opt.image_width, 1):
            raise AssertionError(f"fake shape {fake.shape}")
        if not (np.isfinite(errors).all() and np.isfinite(fake).all()):
            raise AssertionError(f"{dtype}: non-finite output")
        if tf32_flags() != flags:
            raise AssertionError(f"{dtype}: the forward left the TF32 flags "
                                 f"at {tf32_flags()}, not {flags}")
        ms = time_slice(tester, model, batch)
        results[dtype] = fake
        log(f"slice {dtype} bs{BATCH}: {count} kernel launches per forward, "
            f"errors finite (mean x1471 = "
            f"{float(np.mean(errors)) * 1471:.2f}), {ms:.2f} ms/batch, "
            f"{BATCH / ms * 1e3:.2f} img/s (median of 5, host clock)")

        # the same batch with every norm site on the plain version
        with plain_norm_sites():
            p_errors, p_fake = tester.score_batch(model, batch)
            p_ms = time_slice(tester, model, batch)
        fake_tol, err_rtol = SLICE_TOL[dtype]
        fdiff = float(np.abs(fake - p_fake).max())
        ediff = float(np.abs(errors / p_errors - 1).max())
        log(f"slice {dtype} bs{BATCH}, norm sites on the plain version: "
            f"{p_ms:.2f} ms/batch, {BATCH / p_ms * 1e3:.2f} img/s; kernel "
            f"route vs plain route: fakes max abs diff {fdiff:.3e} "
            f"(tolerance {fake_tol}), errors max rel diff {ediff:.3e} "
            f"(tolerance {err_rtol})")
        if not (fdiff <= fake_tol and ediff <= err_rtol):
            raise AssertionError(f"{dtype}: the slice through the kernel "
                                 "disagrees with the plain version")
    for h in hooks:
        h.remove()
    diff = np.abs(results["bfloat16"] - results["float32"]).max()
    log(f"slice bf16 vs f32 fakes on the card: max abs diff {diff:.3e}")

    # batch-1 float32 forward: card against the port's CPU forward
    one = {k: v[:1] for k, v in batch.items()}
    cpu_nets = build_networks(opt)
    for k in cpu_nets:
        cpu_nets[k].load_state_dict(nets[k].state_dict())
    opt32 = opt.replace(compute_dtype="float32")
    on_cpu = Pix2Pix(opt32, cpu_nets, "cpu").inference(one).numpy()
    on_card = models["float32"].inference(one).cpu().numpy()
    diff = float(np.abs(on_cpu - on_card).max())
    log(f"bs1 float32 forward, card vs CPU: max abs diff {diff:.3e} "
        f"(tolerance {CARD_VS_CPU_ATOL})")
    if not diff <= CARD_VS_CPU_ATOL:
        raise AssertionError(f"card and CPU forwards differ by {diff}")
    return launches


def main():
    kind = phase_device()
    phase_build()
    summary = phase_kernel()
    launches = phase_slice()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "seg2eye_tpu"))
    if foreign:
        raise AssertionError(f"the port's run imported {foreign[:5]}")

    from seg2eye_tpu_torch.ops import spade_style as K
    log("kernel summary, one entry per kernel: launches in one forward of "
        f"the slice in that dtype; max_abs_err over the crop-256 and odd "
        f"site checks; ms, plain_ms, library_ms and bound_ms summed over the "
        f"18 sites at N={SITE_N}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": SUMMARY_NAMES[d], "route": "cuda",
         "source": K.SOURCE[DTYPES[d]],
         "replaces": K.REPLACES, "launches": launches[d],
         **{k: summary[d][k] for k in keys}}
        for d in ("bfloat16", "float32")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
