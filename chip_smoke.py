#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seg2eye_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases; any failure raises and the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit
     (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles the CUDA kernels from the checkout's sources; prints
     ptxas's report and the HGMMA/FFMA counts of each kernel's SASS, and
     fails if the bfloat16 kernel has no HGMMA (tensor-core) instruction;
  3. kernel: the fused SPADE+Style kernels (bfloat16: tensor cores,
     float32: FFMA) against their plain PyTorch version at all 18
     generator norm-site shapes of the default model (crop 256, batch 16,
     the shapes the slice gives it) and two odd shapes, then at the 18
     crop-512 site shapes (batch 2, correctness only), one gradient; at
     each crop-256 site the kernel, its plain version and one cuDNN conv
     (library_ms) timed in turns with CUDA events, beside the bound;
  4. slice: scored inference (Tester.score_batch: encode, generate, resize
     to 640x400, truncate, per-image error) at the full width of the
     default model, seeded random weights, batch 16, in bfloat16 and
     float32; the kernel must launch once per norm site per forward.  The
     same batch then runs with every norm site on the plain version: fakes
     and errors must agree, and both routes are timed.  A batch-1 float32
     forward on the card must agree with the port's CPU forward on the same
     weights.  Nothing of JAX or of the JAX package may have been imported.
Float32 comparisons run with TF32 off for cuDNN and matmul, so that both
sides compute in full float32.  The last two lines are the kernel summary
(one entry per kernel) and the result, each one JSON object.
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
# atol, per-image error rtol).  float32 (TF32 off): both sum in float32 in
# different orders, about 1e-6 apart at the fake.  bfloat16: the kernel's
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
# the H100 SXM's published dense peaks (NVIDIA's data sheet, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def log(*args):
    print(*args, flush=True)


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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convolutions and matmuls (float32 is full "
        "float32 on both sides of every comparison)")
    return torch.cuda.get_device_name(0)


# ---------------------------------------------------------------- phase 2
def phase_build():
    from seg2eye_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    report = lib_path.parent / "ptxas.txt"
    if report.exists():
        for line in report.read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "Performance",
                                       "setmaxnreg")):
                log("  ptxas:", line.replace("ptxas info    :", "").strip())
    counts = json.loads((lib_path.parent / "sass_counts.json").read_text())
    kernels = {"bfloat16": "spade_style_sm90_kernel",
               "float32": "spade_style_kernel"}
    for dtype, name in kernels.items():
        mangled = f"{len(name)}{name}"        # an Itanium-mangled identifier
        found = {k: v for k, v in counts.items() if mangled in k}
        if not found:
            raise AssertionError(f"no {name} in the library's SASS")
        for symbol, ops in found.items():
            log(f"  SASS of the {dtype} kernel {symbol}: "
                + ", ".join(f"{op} {n}" for op, n in ops.items()))
            if dtype == "bfloat16" and not ops["HGMMA"]:
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
    kernel's work at this site: the gamma|beta products at the rate of the
    type, and x read, out written, actv and the weights read once, at the
    memory rate.  The bound is the larger of the two."""
    n, h, w, c = shape
    item = DTYPES[dname].itemsize
    flops = 2 * n * h * w * 9 * 128 * 2 * c
    nbytes = n * h * w * (2 * c + 128) * item + 9 * 128 * 2 * c * item
    return flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3


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
        log("  site  (N, H, W, C)         max_abs_err  err/tol    kernel   "
            "plain  library    bound  by   %bound  TFLOP/s    site  "
            "site_plain")
        tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0, site_ms=0.0, site_plain_ms=0.0,
                   bound_ops_ms=0.0, bound_bytes_ms=0.0)
        for i, shape in enumerate(ODD_SITES + [(SITE_N, *s) for s in SITES]):
            args = site_inputs(*shape, dtype, gen)
            got = K.spade_style(*args)
            want = K.spade_style_reference(*args)
            torch.cuda.synchronize()
            err, worst = check_close(f"{dname} {shape}", got, want, rtol, atol)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = args
            actv = K.seg_mlp_shared(seg.to(dtype), ws, bs).contiguous()
            wcat, bcat = K.pack_weights(wg, bg, wb, bb, dtype)
            actv_nchw = actv.permute(0, 3, 1, 2)          # channels_last
            w_lib = torch.cat([wg, wb]).to(dtype).contiguous(
                memory_format=torch.channels_last)
            b_lib = torch.cat([bg, bb]).to(dtype)
            packed = K.PackedWeights()
            kms, pms, lms, sms, spms = time_turns([
                lambda: K.spade_style_cuda(x, actv, style, mean, var,
                                           wcat, bcat),
                lambda: K.spade_style_from_actv(x, actv, style, mean, var,
                                                wg, bg, wb, bb),
                lambda: F.conv2d(actv_nchw, w_lib, b_lib, padding=1),
                lambda: K.spade_style(*args, packed=packed),
                lambda: K.spade_style_reference(*args)])
            ops_ms, bytes_ms = site_bound(shape, dname)
            bms = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            n, h, w, c = shape
            tflops = 2 * n * h * w * 9 * 128 * 2 * c / (kms * 1e-3) / 1e12
            label = "odd" if i < len(ODD_SITES) else f"{i - 1:4d}"
            log(f"  {label}  {str(shape):22s} {err:11.3e}  {worst:7.3f} "
                f"{kms:8.4f} {pms:7.4f} {lms:8.4f} {bms:8.4f}  "
                f"{by[:3]}  {100 * bms / kms:6.1f}  {tflops:7.1f} "
                f"{sms:7.4f} {spms:8.4f}")
            if i >= len(ODD_SITES):
                for key, v in (("ms", kms), ("plain_ms", pms),
                               ("library_ms", lms), ("bound_ms", bms),
                               ("site_ms", sms), ("site_plain_ms", spms),
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
            f"{tot['site_plain_ms']:.4f}")
        summary[dname] = tot

    # crop 512: the same sites with H and W doubled, correctness only
    for dname, dtype in DTYPES.items():
        rtol, atol = TOLS[dname]
        worst_all, err_all = 0.0, 0.0
        for h, w, c in SITES:
            shape = (CROP512_N, 2 * h, 2 * w, c)
            args = site_inputs(*shape, dtype, gen)
            got = K.spade_style(*args)
            want = K.spade_style_reference(*args)
            torch.cuda.synchronize()
            err, worst = check_close(f"crop 512 {dname} {shape}", got, want,
                                     rtol, atol)
            worst_all, err_all = max(worst_all, worst), max(err_all, err)
            del args, got, want
        log(f"crop 512, 18 sites at N={CROP512_N}, {dname}: max abs err "
            f"{err_all:.3e}, worst err/tolerance {worst_all:.3f}")

    # gradient: autograd.Function (kernel forward, recomputed backward)
    # against autograd of the plain version, float32
    for shape in (ODD_SITES[0], (SITE_N, *SITES[0])):
        args = site_inputs(*shape, torch.float32, gen)
        grads = []
        for fn in (K.spade_style, K.spade_style_reference):
            leaves = [a.detach().clone().requires_grad_(i in (0, 2, 7))
                      for i, a in enumerate(args)]
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
        f"the slice in that dtype; max_abs_err over all site checks; ms, "
        f"plain_ms, library_ms and bound_ms summed over the 18 sites at "
        f"N={SITE_N}")
    names = {"bfloat16": "spade_style_bf16_sm90", "float32": "spade_style_f32"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": names[d], "route": "cuda", "source": K.SOURCE[DTYPES[d]],
         "replaces": K.REPLACES, "launches": launches[d],
         **{k: summary[d][k] for k in keys}}
        for d in ("bfloat16", "float32")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
