#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seg2eye_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases; any failure raises and the script exits non-zero:
  1. device: a CUDA card is required; prints its name and power limit
     (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles the CUDA kernels from the checkout's sources;
  3. kernel: the fused SPADE+Style kernel against its plain PyTorch version
     at all 18 generator norm-site shapes of the default model (crop 256,
     batch 16, the shapes the slice gives it) and an odd tile, in float32
     and bfloat16, one gradient, and each site timed against the plain
     version with CUDA events;
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
and the result, each one JSON object.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
ODD_SITE = (1, 10, 8, 16)  # (N, H, W, C)


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
    report = (lib_path.parent / "ptxas.txt")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.replace("ptxas info    :", "").strip())


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


def time_pair(fn_a, fn_b, args):
    """Median ms of fn_a and fn_b, timed in turns with CUDA events."""
    for _ in range(WARMUP):
        fn_a(*args)
        fn_b(*args)
    times = ([], [])
    for _ in range(REPEATS):
        for fn, acc in ((fn_a, times[0]), (fn_b, times[1])):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def phase_kernel():
    from seg2eye_tpu_torch.ops import spade_style as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
        dname = str(dtype).replace("torch.", "")
        log(f"kernel vs plain, {dname}, tolerance |err| <= {atol:.3g} + "
            f"{rtol:.3g} * |plain|")
        log("  site  (N, H, W, C)            max_abs_err  err/tol  "
            "kernel_ms  plain_ms  kernel_TFLOP/s")
        max_err, k_ms, p_ms = 0.0, 0.0, 0.0
        shapes = [ODD_SITE] + [(SITE_N, *s) for s in SITES]
        for i, shape in enumerate(shapes):
            args = site_inputs(*shape, dtype, gen)
            got = K.spade_style(*args)
            want = K.spade_style_reference(*args)
            torch.cuda.synchronize()
            err, worst = check_close(f"{dname} {shape}", got, want, rtol, atol)
            max_err = max(max_err, err)
            kms, pms = time_pair(K.spade_style, K.spade_style_reference, args)
            n, h, w, c = shape
            tflops = 2 * n * h * w * 9 * 128 * 2 * c / (kms * 1e-3) / 1e12
            label = "odd" if i == 0 else f"{i:4d}"
            log(f"  {label}  {str(shape):24s} {err:11.3e}  {worst:7.3f}  "
                f"{kms:9.4f}  {pms:8.4f}  {tflops:8.2f}")
            if i > 0:
                k_ms += kms
                p_ms += pms
            del args, got, want
        log(f"  18 sites at N={SITE_N}, {dname}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms (sum of per-site medians)")
        summary[dname] = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms)

    # gradient: autograd.Function (kernel forward, recomputed backward)
    # against autograd of the plain version, float32
    for shape in (ODD_SITE, (SITE_N, *SITES[0])):
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

    launches, models, results = None, {}, {}
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
        if launches is None:
            launches = count
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
    log("kernel summary: max_abs_err in float32 over all sites; ms and "
        f"plain_ms in bfloat16, summed over the 18 sites at N={SITE_N}")
    print(json.dumps({"kernels": [{
        "name": "spade_style", "route": "cuda", "source": K.SOURCE,
        "replaces": K.REPLACES, "launches": launches,
        "max_abs_err": summary["float32"]["max_abs_err"],
        "ms": summary["bfloat16"]["ms"],
        "plain_ms": summary["bfloat16"]["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
