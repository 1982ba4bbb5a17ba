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
     same product (then the same epilogue) as a contrast.  Then the
     bfloat16 backward kernel at the same shapes: dx, [dgamma | dbeta] and
     the per-channel sums against its plain version
     (``epilogue_backward_reference``), the op's gradients through it
     against autograd of the float32 plain version, and the kernel, its
     plain version, the op's whole backward through it and through the
     plain recompute (the route before the kernel) timed in turns beside
     the kernel's bound;
  4. slice: scored inference (Tester.score_batch: encode, generate, resize
     to 640x400, truncate, per-image error) at the full width of the
     default model, seeded random weights, batch 16, in bfloat16 and
     float32; the kernel must launch once per norm site per forward.  The
     same batch then runs with every norm site on the plain version: fakes
     and errors must agree, and both routes are timed.  A batch-1 float32
     forward on the card must agree with the port's CPU forward on the same
     weights;
  5. train: training of the default model (seeded G, E and D, a seeded
     synthetic batch of 16) through ``train.steps.train_step``, in float32
     and bfloat16.  For 3 iterations, the kernel route (the port as it
     runs) and the plain route (every norm site on the plain version) take
     each iteration from identical copies of the state (weights, buffers,
     both Adam states): their loss dicts and gradients must agree.  The
     kernel must launch 36 times in one iteration (18 sites in the G
     step's forward and 18 in the D step's regeneration of the fake), the
     backward kernel 18 times in a bfloat16 iteration (the G step's
     backward) and never in float32 or in scoring, the losses be finite,
     every spectral u/v, running statistic and
     parameter with a nonzero gradient have moved, and netE's fc_var
     (no gradient) not; ms/iteration and img/s of both
     routes and the peak memory are printed.  One small float32 iteration
     on the card must agree with the same iteration on the CPU, each of
     its two steps from the same state, and the discriminator's pool
     must have the CPU's gradient.  Last,
     the entry point ``train.loop.train`` runs 3 steps of in-memory batches
     into a temporary checkpoints_dir (108 launches, ``src.zip``
     written), and its ``latest`` G and E strict-load and score a batch
     through ``Tester``;
  6. refinenet: the RefineNet system at full width (DeepLabV3+ with the
     ResNet-101, Xception and DRN-D-54 backbones, os16 (DRN: 8), 640x400,
     seeded weights, seeded uint8 batches in memory; the optimizer
     settings of refinenet/configs/*.json).  SegNet and RefineNet must
     count RN_PARAMS parameters; each serves batches of 32 through
     ``Trainer.eval_step`` (masks in 0..3; predictions in [-1, 1] and a
     finite score) and takes 3 train steps at batch 8, in bfloat16 and
     (ResNet both models, SegNet-DRN and RefineNet-Xception) float32
     (finite losses, every parameter with a nonzero gradient and every
     running statistic moved), each timed beside its FLOP bound.  Card
     against CPU: single ops of the DeepLab path on channels_last input,
     then one eval forward and one train step of SegNet, RefineNet and a
     MobileNet RefineNet at ResNet-14, SegNet-DRN and RefineNet-Xception
     at full depth, all at 64x40, from identical states, in float32 and
     float64.  Last,
     ``main_loop`` trains RefineNet 3 steps into a temporary directory and
     its last checkpoint reloads to bit-identical eval outputs.  No
     SPADE+Style kernel launches in this phase;
  7. options (run before phase 6): 7a the default model at bs16 with
     batch sub-norms in E and D (``spectralbatch``, per-sample encoding
     on through 'auto') and the VGG loss (seeded full-width VGG19,
     lambda_vgg 10), in float32 and bfloat16: kernel route against plain
     route for 3 iterations as in phase 5, 36 launches per iteration,
     every E/D running statistic moved, ms/iteration, img/s and peak
     memory of both routes; 7b ``--remat`` at crop 512 (640x512), bs8,
     both dtypes: the G step and then the D step with and without remat
     from identical states (losses and gradients within F32_ROUTE, u/v
     and running statistics bit for bit), 36 and 54 launches per
     iteration, lower peak memory with remat, ms/iteration of both; 7c
     one small float32 iteration with all of them on, card against CPU;
     7d ``train.loop.train`` for 3 steps with ``--remat`` and
     ``--profile_steps 1`` (162 launches, the trace and ``src.zip``
     written), its checkpoint scored through ``Tester``;
  8. serving (after phase 6): the default model at full width, its
     running statistics calibrated on one seeded batch, exported with
     ``serving.export_inference`` in bfloat16 and float32; a fresh process
     whose imports of ``models``, ``refinenet``, ``options`` and JAX are
     refused loads each artifact and serves batches of 1, 16 and 32 twice
     (18 K1 launches per call, 18 weight packings on the first call only,
     the second call bit for bit equal, the weights unchanged); its
     outputs against ``Pix2Pix.inference`` on the same batches (``fake``
     within SLICE_TOL, ``fake_255`` within one step); artifact and live
     timed in turns.  Then SegNet and RefineNet at full width (ResNet-101
     in bfloat16, RefineNet also float32; RefineNet with the Xception and
     DRN backbones in both dtypes) exported with ``serving.export_refiner``
     and served at bs32 against ``eval_step`` (every output bitwise equal,
     no K1 launch), timed in turns, then again from a process that cannot
     import the model code (bitwise equal again).  An artifact more than
     SERVE_SLOWDOWN times its live model's time fails;
  9. segtrain (after phase 8): the generic DeepLabV3+ trainer
     (``segtrain.SegTrainer``) at the CLI's pascal defaults (ResNet-101
     os16, 21 classes, crop 513, batch 4, lr 0.007 poly, SGD momentum 0.9
     and weight decay 5e-4, the head at 10x; seeded weights, seeded
     normalised batches in memory through ``loaders=``, in a temporary
     working directory), in float32 and bfloat16: 3 steps of
     ``training(0)`` (finite losses, both groups' lr equal to
     LRScheduler's at each step, every parameter with a nonzero gradient
     and every running statistic moved), ms/step, img/s, peak memory and
     the share of the FLOP bound; ``validation(0)`` over 10 images in
     batches of 4, 4 and 2 (the device's confusion matrix equal to a numpy
     recount of the same logits, mIoU in [0, 1], model_best.ckpt written)
     and the eval step timed.  bfloat16 only: a step with focal loss and
     class-balanced weights over labels in [21, 255) (no device assert), a
     --freeze-bn step (BN buffers bit for bit), resume from
     checkpoint.ckpt (eval logits bit for bit, epoch and best_pred) and
     --ft (no momentum).  Card against CPU: ResNet-14 at crop 33, batch 2,
     one eval and one train step from identical states in float32 and
     float64 within phase 6's limits.  No SPADE+Style launch.
  10. interop (after phase 9): the JAX package's checkpoint files,
     written by the port and read back, in a temporary directory.  The
     default model at bs16 in float32 and bfloat16: 2 iterations, then
     ``utils.checkpoint.save_state_jax`` ({epoch}_net_{G,D,E}.ckpt and
     _optim.ckpt, flax msgpack) and ``load_state`` into a fresh state:
     every parameter, buffer and Adam tensor bit for bit (BN
     num_batches_tracked aside: the JAX format has no place for it), a
     scored bs16 batch bitwise equal to the live model's (18 K1 launches),
     and the next iteration (36 launches), taken by both states under
     deterministic algorithms, bit for bit the live run's.  RefineNet (ResNet-101 os16,
     640x400, bs8) through ``CheckpointManager(fmt="flax")`` and segtrain
     (pascal defaults, crop 513, bs4) through ``--resume`` of a JAX
     checkpoint.ckpt: weights, statistics and momentum bit for bit, eval
     outputs bitwise, epoch and best_pred, no K1 launch.  File sizes and
     write/load seconds are printed;
  11. data (after phase 10): the host-data tools on arrays in memory (the
     card's machine has no h5py).  (a) The style ranking
     (``data.style_ranking``) at one OpenEDS 2019 user's size: 84 target
     and 1,662 + 600 candidate masks at 640x400, nested jittered ellipses
     from the seed, one target and one candidate made so that their
     summed squared difference exceeds 2**24.  The card's distances and
     stable orders bit for bit equal to the same function's on the CPU
     over all 84 targets, and the pair above 2**24 equal to the exact
     integer sum rounded once to float32, over 4096; ms per user on the
     card (masks resident there) and on the CPU.  (b) The native batch
     assembly (``native``, built with g++ from the checkout): the 16 x 4
     references of a bs16 batch at the default crop (320x256) and 16
     masks, per-sample flips, bit for bit equal to the numpy versions,
     both timed;
  12. parallel (after phase 11): data-parallel training
     (``parallel.data_parallel``), each rank a child process of this
     script with its own timeout; a child that fails or times out fails
     the phase.  (a) World 1 on NCCL: the default model at bs16, 2
     float32 iterations, each step (G, then D) taken by the DP route and
     by the one-process route from identical states (losses and gradients
     to F32_ROUTE, the updated state to the card-vs-CPU limits), 36 K1
     launches per iteration; then both routes timed in turns in float32
     and bfloat16 (their difference: the synchronised statistics and the
     gradient all-reduce).  (b) World 2 on gloo with CUDA tensors on the
     one card: the same at 8 samples per rank against rank 0's
     one-process run of the whole bs16 batch, 36 launches per rank per
     iteration; then segtrain (ResNet-101 os16, crop 513) at global bs4,
     2 float64 steps against the one-process step, 0 launches.  The gloo
     times are a correctness run's, not a speed figure;
  13. model and spatial parallel (after phase 12): two ranks on gloo with
     CUDA tensors on the one card, children of this script as in phase 12.
     (a) Tensor parallelism (``parallel.tensor_parallel``) on a data 1 x
     model 2 grid at full width (ngf 64, ndf 64, crop 256, k = 4), bs4: 2
     float32 iterations and 1 bfloat16 one, each step (G, then D) taken
     by the grid and, on rank 0, by the one-process route from a gathered
     copy of the same state (float32: losses and gradients to F32_ROUTE,
     the updated state to the card-vs-CPU limits; bfloat16: within the
     plain bfloat16 route's distance from float32), 36 K1 launches per
     rank per iteration (14 of the 18 sites on a channel slice), 18 weight
     packings in the first forward and in each forward after a G update
     (the D step's regeneration) and none in any other, and each rank's
     bytes of parameters and Adam moments
     against one process's.  (b) H-band scoring (``parallel.spatial``,
     ``--spatial_shard``): ``Tester.score_batch`` at bs1 and bs2 in 2
     bands of 160 rows, float32 and bfloat16, 18 launches per rank per
     forward, fakes and per-image errors against the one-process Tester
     within SLICE_TOL.  (c) Per-sample encoding under tensor parallelism:
     four ranks on a data 2 x model 2 grid, the default model at full
     width with ``norm_E = spectralbatch`` (per-sample encoding through
     'auto'), global bs4, 2 samples per data index; one float32
     iteration, each step against rank 0's one-process route from a
     gathered copy of the same state as in (a) (losses and gradients to
     F32_ROUTE, spectral u/v, E's running statistics and the parameters to
     the card-vs-CPU limits, ``num_batches_tracked`` equal), every replica
     checked after each step, 36 K1 launches per rank.  The times are a
     correctness run's through the host;
Nothing of JAX, flax, optax, msgpack or the JAX package may have been
imported.
The port keeps float32 in full float32 by itself (its float32 forward and
plain versions turn TF32 off around their own convolutions); the cuDNN
calls this script makes directly set the flags around themselves.  The
last two lines are the kernel summary (one entry per kernel) and the
result, each one JSON object.
"""
import contextlib
import json
import math
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
# the tensor cores' rate for the type each kernel feeds them (float32 runs
# on the TF32 rate, three passes per product), from the card's published
# peaks in ``utils.roofline``; the FP32 pipes' rate is printed beside the
# float32 bound
KERNEL_RATES = {"bfloat16": (torch.bfloat16, 1), "float32": ("tf32", 3)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the kernel symbols of the library, per dtype
KERNEL_SYMBOLS = {"bfloat16": "spade_style_sm90_kernel",
                  "float32": "spade_style_3xtf32_sm90_kernel",
                  "bfloat16 backward": "spade_style_sm90_kernel_bwd"}
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
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    log(card_line())
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


def time_turns(fns, warmup=WARMUP, repeats=REPEATS):
    """Median ms of each no-argument function, timed in turns with CUDA
    events."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(repeats):
        for fn, acc in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def site_bound(shape, flops, dname):
    """(ms of the operations, ms of the bytes) at the card's peaks
    (``utils.roofline``) for the kernel's work at this site: its
    ``flops`` (the gamma|beta products) at the tensor-core rate of the
    type (float32: TF32, three passes), and x read, out written, actv and
    the weights read once, at the memory rate.  The bound is the larger of
    the two."""
    from seg2eye_tpu_torch.utils import roofline

    n, h, w, c = shape
    item = DTYPES[dname].itemsize
    nbytes = n * h * w * (2 * c + 128) * item + 9 * 128 * 2 * c * item
    rate, passes = KERNEL_RATES[dname]
    return (roofline.compute_ms(flops, rate, passes),
            roofline.memory_ms(nbytes))


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
    from seg2eye_tpu_torch.utils import roofline

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
            log(f"  float32: the bound is 3 TF32 passes at "
                f"{roofline.peak_flops(dtype='tf32') / 1e12:.0f} TFLOP/s; "
                f"fp32_pipe is the same products at the FP32 pipes' "
                f"{roofline.peak_flops(dtype=torch.float32) / 1e12:.0f} "
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
            with tf32(False):     # the library conv in full float32
                kms, pms, lms, sms, spms = time_turns([
                    lambda: K.spade_style_cuda(x, actv, style, mean, var,
                                               wcat, bcat),
                    lambda: K.spade_style_from_actv(x, actv, style, mean,
                                                    var, wg, bg, wb, bb),
                    lambda: F.conv2d(actv_nchw, w_lib, b_lib, padding=1),
                    lambda: K.spade_style(*args),
                    lambda: K.spade_style_reference(*args)])
            # the gamma|beta products: the library conv's
            flops = roofline.flops_of(F.conv2d, actv_nchw, w_lib, b_lib, 1,
                                      1)
            ops_ms, bytes_ms = site_bound(shape, flops, dname)
            bms = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            fp32_ms = roofline.compute_ms(flops, torch.float32)
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
            del args, got, want, actv, wcat, actv_nchw
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


# the backward kernel's per-channel sums against its plain version's: both
# sum the same bfloat16 h and x in float32 in other orders (blocks of 128
# pixels, then over the blocks), with gamma to float32 summation order; at
# 81,920 pixels a sum of |h| about 3e4 is off by about 1e-2 in float32
# while the largest sum of a site is some 4e2, so 1e-3 of that largest sum
# leaves ten times room; a sum of a wrong row or channel is off by the
# order of the sum itself
SUMS_RTOL = 1e-3
# the op's inputs that take a gradient in training, by index (seg takes none)
BWD_GRAD_INPUTS = {"x": 0, "style": 2, "mean": 3, "var": 4, "ws": 5,
                   "bs": 6, "wg": 7, "bg": 8, "wb": 9, "bb": 10}
# backward kernel launches in one training iteration: the G step's backward
BACKWARD_LAUNCHES = {"bfloat16": len(SITES), "float32": 0}


def phase_kernel_backward():
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.utils import roofline

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = torch.bfloat16
    rtol, atol = TOLS["bfloat16"]
    # the op's gradients through the kernel (bfloat16) against autograd of
    # the float32 plain version, per input: ||d|| <= grad_rtol ||g||,
    # F32_ROUTE's per-tensor rule (the bfloat16 rounding of actv, the
    # weights and the stored maps, 2^-8 relative each, moves most gradients
    # by a few 1e-3 of their norm), or within BF16_TENSOR_RATIO times the
    # bfloat16 plain recompute's own distance, phase 5's bfloat16 rule: the
    # seg MLP's ws and bs gradients pass the ReLU mask of a bfloat16 actv
    # and move by 2.4e-2 to 4.2e-2 of their norm in the plain recompute
    # itself (on an H100, at these shapes)
    grad_rtol = F32_ROUTE["grad_rtol"]
    needs = tuple(i in BWD_GRAD_INPUTS.values() for i in range(11))
    graded = [i for i, need in enumerate(needs) if need]
    log(f"backward kernel, bfloat16, against its plain version "
        f"(epilogue_backward_reference): dx and [dgamma | dbeta] within "
        f"|err| <= {atol:.3g} + {rtol:.3g} * |plain| (dx_e/t, dgb_e/t: worst "
        f"err/tolerance), the sums within {SUMS_RTOL:g} of each kind's "
        f"largest (sums_e/t); the op's gradients through the kernel against "
        f"autograd of the float32 plain version, worst ||d|| / ||g|| over "
        f"{len(graded)} inputs, beside the same for the bfloat16 plain "
        f"recompute (limit per input: {grad_rtol:g}, or {BF16_TENSOR_RATIO:g} "
        "times the plain recompute's); times in ms: the kernel, its "
        "plain version, the op's backward through the kernel (seg MLP, "
        "kernel, sums, dgrad and wgrad) and through the plain recompute "
        "(the route before the kernel), the kernel's bound")
    log("  site  (N, H, W, C)         dx_e/t  dgb_e/t  sums_e/t  grad_k  "
        "(input)  grad_p    kernel    plain  backward  recompute    bound  "
        "by   %bound")
    tot = dict(worst=0.0, grad_worst=0.0, ms=0.0, plain_ms=0.0,
               backward_ms=0.0, recompute_ms=0.0, bound_ms=0.0,
               bound_ops_ms=0.0, bound_bytes_ms=0.0)
    for i, shape in enumerate(ODD_SITES + [(SITE_N, *s) for s in SITES]):
        args = site_inputs(*shape, dtype, gen)
        x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = args
        dout = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        actv = K.seg_mlp_shared(seg.to(dtype), ws, bs).contiguous()
        wgam, bcat, _ = K.packed_weights.backward(wg, bg, wb, bb, dtype)
        got = K.spade_style_backward_cuda(x, actv, dout, style, mean, var,
                                          wgam, bcat)
        want = K.epilogue_backward_reference(x, actv, dout, style, mean, var,
                                             wg, bg)
        torch.cuda.synchronize()
        _, dx_w = check_close(f"backward dx {shape}", got[0], want[0], rtol,
                              atol)
        _, dgb_w = check_close(f"backward dgamma|dbeta {shape}", got[1],
                               want[1], rtol, atol)
        scale = want[2].abs().amax(dim=(0, 2), keepdim=True)
        sums_w = float(((got[2] - want[2]).abs() / (SUMS_RTOL * scale)).max())
        if not sums_w <= 1.0:
            raise AssertionError(f"backward sums {shape}: worst "
                                 f"err/tolerance {sums_w:.3f}")
        # the op's gradients, kernel route and bfloat16 plain recompute,
        # against autograd of the float32 plain version
        grads_k = K._kernel_backward(args, needs, dout, K.EPS)
        grads_p = K._recompute_backward(args, needs, dout, K.EPS)
        leaves = [a.float().requires_grad_(need)
                  for a, need in zip(args, needs)]
        with tf32(False):
            out = K.spade_style_reference(*leaves)
            grads_f = torch.autograd.grad(
                out, [leaves[j] for j in graded], dout.float())
        ratios_k, ratios_p = {}, {}
        for j, g_f in zip(graded, grads_f):
            norm = float(g_f.norm())
            ratios_k[j] = float((grads_k[j].float() - g_f).norm()) / norm
            ratios_p[j] = float((grads_p[j].float() - g_f).norm()) / norm
        worst = max(ratios_k, key=ratios_k.get)
        name = next(k for k, v in BWD_GRAD_INPUTS.items() if v == worst)
        for j, r in ratios_k.items():
            if not r <= max(grad_rtol, BF16_TENSOR_RATIO * ratios_p[j]):
                raise AssertionError(
                    f"backward gradients {shape}: ||d|| / ||g|| of input "
                    f"{j} {r:.3e}, the bfloat16 plain recompute's "
                    f"{ratios_p[j]:.3e}")
        del grads_k, grads_p, grads_f, leaves, out
        kms, pms, bms, rms = time_turns([
            lambda: K.spade_style_backward_cuda(x, actv, dout, style, mean,
                                                var, wgam, bcat),
            lambda: K.epilogue_backward_reference(x, actv, dout, style, mean,
                                                  var, wg, bg),
            lambda: K._kernel_backward(args, needs, dout, K.EPS),
            lambda: K._recompute_backward(args, needs, dout, K.EPS)])
        flops, nbytes = K.backward_kernel_work(shape, dtype)
        ops_ms = roofline.compute_ms(flops, dtype)
        bytes_ms = roofline.memory_ms(nbytes)
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        label = "odd" if i < len(ODD_SITES) else f"{i - 1:4d}"
        log(f"  {label}  {str(shape):22s} {dx_w:7.3f}  {dgb_w:7.3f}  "
            f"{sums_w:8.4f}  {ratios_k[worst]:.2e} ({name:5s}) "
            f"{ratios_p[worst]:.2e} {kms:8.4f} {pms:8.4f} {bms:9.4f} "
            f"{rms:10.4f} {bound:8.4f}  {by[:3]}  {100 * bound / kms:6.1f}")
        tot["worst"] = max(tot["worst"], dx_w, dgb_w, sums_w)
        tot["grad_worst"] = max(tot["grad_worst"], ratios_k[worst])
        if i >= len(ODD_SITES):
            for key, v in (("ms", kms), ("plain_ms", pms),
                           ("backward_ms", bms), ("recompute_ms", rms),
                           ("bound_ms", bound), ("bound_ops_ms", ops_ms),
                           ("bound_bytes_ms", bytes_ms)):
                tot[key] += v
        del args, got, want, actv, dout
    tot["bound_by"] = ("operations" if tot.pop("bound_ops_ms")
                       >= tot.pop("bound_bytes_ms") else "bytes")
    log(f"  18 sites at N={SITE_N}, bfloat16 backward (sums of per-site "
        f"medians): kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, "
        f"bound {tot['bound_ms']:.4f} ({tot['bound_by']}), "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of the bound; the op's "
        f"backward through the kernel {tot['backward_ms']:.4f}, through the "
        f"plain recompute {tot['recompute_ms']:.4f}; worst err/tolerance "
        f"{tot['worst']:.4f}, worst gradient ||d|| / ||g|| "
        f"{tot['grad_worst']:.3e} (odd shapes included)")
    return tot


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
        lambda *args: K.spade_style_reference(*args))
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
        K.spade_style.launches = K.spade_style.backward_launches = 0
        errors, fake = tester.score_batch(model, batch)
        count = K.spade_style.launches
        if K.spade_style.backward_launches:
            raise AssertionError(f"{dtype}: the backward kernel launched "
                                 f"{K.spade_style.backward_launches} times "
                                 "in scoring")
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
        log(f"slice {dtype} bs{BATCH}: {count} kernel launches per forward "
            "(0 of the backward kernel), "
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


# ---------------------------------------------------------------- phase 5
TRAIN_BATCH = 16
# K1 launches in one training iteration: the G step's forward and the D
# step's regeneration of the fake with the updated G, 18 sites each (the
# backward kernel counts apart: BACKWARD_LAUNCHES)
TRAIN_LAUNCHES = 2 * len(SITES)
ROUTE_ITERS, TIMED_ITERS, LOOP_STEPS = 3, 5, 3
EXPECTED_D_PARAMS = 5_531_778
# Kernel route against plain route.  Each of ROUTE_ITERS iterations starts
# both routes from identical copies of the kernel route's state (weights,
# spectral u/v, running statistics, both Adam states).  Left to run apart,
# they do not stay comparable: Adam at beta1 = 0 steps every element by
# about lr * sign(g), a large step at this init scale, and an element whose
# gradient is round-off may step either way; by the second iteration
# GAN_Feat was 0.3% apart (on an H100).
# float32: at a site the routes differ by float32 summation order (phase 3:
# max abs err 1.2e-5 at unit-scale outputs).  The losses then agree to
# 1e-7 relative (measured), so: |d| <= 1e-3 |L| + 1e-4.  The gradients
# agree less well at the first iteration, where they are small sums of
# terms that nearly cancel (D cannot yet tell fake from real): measured
# 1.4e-3 of the net's gradient norm in G, 1.8e-3 in E, and 1.4e-2 in D,
# whose gradients are taken after the G update, in which Adam's sign steps
# go the other way wherever G's gradients differ in sign; 2.9e-5, 2.4e-5
# and 7.7e-4 at the second iteration, 6.3e-6, 1.4e-5 and 3.8e-4 at the
# third (on an H100).  So, per tensor: ||d|| <=
# 2e-2 ||g|| + 2e-3 ||g of the net||, the floor for tensors whose gradient
# is zero up to round-off (D's last biases under the hinge loss, while
# every logit is inside the margin).  A kernel that read weights one Adam
# step old would miss by far more: at this init scale (xavier, gain 0.02)
# one step moves a weight by a tenth of its size or more.
F32_ROUTE = dict(loss_rtol=1e-3, loss_atol=1e-4, grad_rtol=2e-2,
                 grad_floor=2e-3)
# bfloat16: the kernel keeps gamma|beta in float32 where the plain version
# rounds them to bfloat16, so the distance between the two routes is a
# part of the bfloat16 rounding.  It may be no larger than the distance of
# the plain bfloat16 route from the plain float32 route, from the same
# state: per iteration for the loss dict and per net for the gradients, by
# Euclidean norm.  Per gradient tensor, where both distances are sums of
# different roundings, within twice that tensor's own distance (measured
# at most 1.28 on an H100, at a small bias).
BF16_TENSOR_RATIO = 2.0
# crop 128 at aspect 0.8: the generator's output, 2^5 times its (5, 4)
# latent grid, is the 160x128 image (crop 64 would need a 2.5-row grid)
CARD_CPU = dict(ngf=16, ndf=16, crop_size=128, batchSize=2)
# card (kernel, float32) against CPU (plain version), one iteration, each
# step from the same state: the G step from the same weights, then the D
# step from a card copy of the CPU's state after its G step.  Across the
# whole iteration the two would not stay comparable: the G update steps
# each element by about lr * sign(g), the other way wherever the two
# gradients differ in sign (0.6% of the elements, measured), and the D
# step's regenerated fake, G's second power iteration and its running
# update all see that (D's gradients then 3.5e-2 apart on an H100).
# Per step: losses |d| <= 1e-4 |L| + 1e-4; gradients as F32_ROUTE
# (measured: 8.0e-4 of the net's norm in G, 9.7e-4 in E, 1.4e-3 in D);
# spectral u/v (unit vectors) max abs 1e-4 (measured 8.9e-8); running
# statistics ||d|| <= 1e-4 ||stat|| (5.2e-7); at most 5% of the parameter
# elements beyond 1e-6 (0.59% after the G step), none beyond one sign step
# each way (2 lr) + 1e-6.
CARD_CPU_LOSS_RTOL, CARD_CPU_PARAM_ATOL = 1e-4, 1e-6
CARD_CPU_UV_ATOL, CARD_CPU_RUN_RTOL, CARD_CPU_FLIPPED = 1e-4, 1e-4, 0.05


def make_train_batch(opt, b, seed=0):
    """A synthetic batch as the training loader gives it (int labels, uint8
    references and target), with ``target_original`` for scoring."""
    rng = np.random.default_rng(seed)
    h, w = opt.image_height, opt.image_width
    batch = make_batch(opt, b, seed + 1)
    batch["target"] = rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8)
    return batch


def nets_of(model):
    return {"G": model.netG, "E": model.netE, "D": model.netD}


def all_nets(model):
    """nets_of and, with the VGG loss on, the frozen VGG19."""
    vgg = {} if model.netVGG is None else {"VGG": model.netVGG}
    return {**nets_of(model), **vgg}


def train_state(opt, nets_cpu, device="cuda"):
    """A TrainState of a deep copy of ``nets_cpu`` on ``device``, with
    fresh optimizers."""
    import copy

    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.train import state as state_lib

    nets = {k: copy.deepcopy(v) for k, v in nets_cpu.items()}
    return state_lib.create_state(Pix2Pix(opt, nets, device))


def clone_state(state, opt=None):
    """A deep copy of a TrainState on its device (weights, buffers, both
    Adam states); with ``opt``, the copy computes in that configuration's
    dtype."""
    import copy

    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix

    new = copy.deepcopy(state)
    if opt is not None:
        new.model = Pix2Pix(opt, all_nets(new.model), new.model.device)
    return new


def timed_iteration(state, batch):
    from seg2eye_tpu_torch.train import steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, _ = steps.train_step(state, batch)
    torch.cuda.synchronize()
    return ({k: float(torch.mean(v.float())) for k, v in losses.items()},
            (time.perf_counter() - t0) * 1e3)


def grads_of(model):
    return {f"{n}.{k}": p.grad for n, net in nets_of(model).items()
            for k, p in net.named_parameters()}


def vec_gap(a, b, keys):
    return float(np.sqrt(sum((a[k] - b[k]) ** 2 for k in keys)))


def net_gaps(a, b, net):
    """(||a - b||, ||b||) over the net's gradient tensors, and per tensor."""
    keys = [k for k in b if k.startswith(net + ".") and b[k] is not None]
    per = {k: (float((a[k] - b[k]).norm()), float(b[k].norm()))
           for k in keys}
    return (float(np.sqrt(sum(d * d for d, _ in per.values()))),
            float(np.sqrt(sum(g * g for _, g in per.values())))), per


def compare_losses(where, lk, lp, lr, rtol=F32_ROUTE["loss_rtol"]):
    """-> failures.  lk, lp, lr: loss dicts of the kernel route, the plain
    route and (bfloat16) the plain float32 route."""
    if sorted(lk) != sorted(lp):
        return [f"{where}: loss keys {sorted(lk)} != {sorted(lp)}"]
    if not all(np.isfinite(v) for v in (*lk.values(), *lp.values())):
        return [f"{where}: non-finite losses {lk} {lp}"]
    keys = sorted(lk)
    values = ", ".join(f"{k} {lk[k]:.6f}/{lp[k]:.6f}" for k in keys)
    if lr is None:
        worst = max(abs(lk[k] - lp[k]) / (F32_ROUTE["loss_atol"]
                                          + rtol * abs(lp[k])) for k in keys)
        log(f"  {where.split(', ')[-1]}: losses worst err/tolerance "
            f"{worst:.4f}; " + values)
        ok = worst <= 1.0
    else:
        gap, ref = vec_gap(lk, lp, keys), vec_gap(lp, lr, keys)
        log(f"  {where.split(', ')[-1]}: loss dicts kernel vs plain "
            f"{gap:.4e}, plain bf16 vs plain f32 {ref:.4e}; " + values)
        ok = gap <= ref
    return [] if ok else [f"{where}: losses disagree"]


def compare_grads(where, gk, gp, gr, what="kernel - plain",
                  nets=("G", "E", "D"), net_floor=False):
    """-> failures; the gradients of ``nets``, as compare_losses.
    ``net_floor`` (bfloat16): a tensor's own bfloat16 distance is at
    least the net's relative one times its norm; a tensor of one element
    (conv_img's bias) may have a bfloat16-vs-float32 distance near zero by
    chance, which its ratio then divides by."""
    failures = [f"{where}: gradient of {k} is None on one side only"
                for k in gp if k.split(".")[0] in nets
                and (gk[k] is None) != (gp[k] is None)]
    for net in nets:
        (d, g), per = net_gaps(gk, gp, net)
        if gr is None:
            ratios = {k: dk / (F32_ROUTE["grad_rtol"] * gk_
                               + F32_ROUTE["grad_floor"] * g)
                      for k, (dk, gk_) in per.items()}
            worst = max(ratios, key=ratios.get)
            log(f"    gradients of {net}: ||{what}|| / ||g|| "
                f"{d / g:.3e}; worst tensor {worst} err/tolerance "
                f"{ratios[worst]:.4f}")
            ok = ratios[worst] <= 1.0
        else:
            (ref, _), ref_per = net_gaps(gp, gr, net)
            floor = {k: ref / g * per[k][1] if net_floor else 0.0
                     for k in per}
            ratios = {k: per[k][0] / max(ref_per[k][0], floor[k], 1e-30)
                      for k in per}
            worst = max(ratios, key=ratios.get)
            log(f"    gradients of {net}: ||{what}|| {d:.4e} "
                f"(relative {d / g:.3e}), plain bf16 vs plain f32 {ref:.4e}; "
                f"largest per-tensor ratio of the two: {worst} "
                f"{ratios[worst]:.3f} ({per[worst][0]:.3e} against "
                f"{ref_per[worst][0]:.3e}, floor {floor[worst]:.3e}, "
                f"||g|| {per[worst][1]:.3e})")
            ok = d <= ref and ratios[worst] <= BF16_TENSOR_RATIO
        if not ok:
            failures.append(f"{where}: gradients of {net} differ")
    return failures


def lockstep(dname, state, batch, ref_opt=None):
    """ROUTE_ITERS iterations of the kernel route from ``state``.  The plain
    route (and, given ``ref_opt``, the plain route in its float32) takes
    each of them from an identical copy of the state; losses and gradients
    are compared, and every failure raised at the end."""
    from seg2eye_tpu_torch.ops import spade_style as K

    failures = []
    for it in range(ROUTE_ITERS):
        plain = clone_state(state)
        ref = None if ref_opt is None else clone_state(state, ref_opt)
        lk = timed_iteration(state, batch)[0]
        launched = K.spade_style.launches
        with plain_norm_sites():
            lp = timed_iteration(plain, batch)[0]
            lr = None if ref is None else timed_iteration(ref, batch)[0]
        if K.spade_style.launches != launched:
            failures.append("the plain route launched the kernel")
        where = f"{dname} kernel vs plain, iteration {it + 1}"
        failures += compare_losses(where, lk, lp, lr)
        failures += compare_grads(where, grads_of(state.model),
                                  grads_of(plain.model),
                                  None if ref is None else
                                  grads_of(ref.model))
        del plain, ref
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def timed(state, batch, plain=False, iters=TIMED_ITERS):
    """(median ms of ``iters`` iterations, peak GiB allocated)."""
    torch.cuda.reset_peak_memory_stats()
    with plain_norm_sites() if plain else contextlib.nullcontext():
        ms = statistics.median(timed_iteration(state, batch)[1]
                               for _ in range(iters))
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def check_trained(dname, state, before):
    """Every spectral u/v and running statistic moved, and every parameter
    that ever had a nonzero gradient (Adam's second moment is not all
    zero); a parameter whose gradient was zero at every step (D's last
    biases under the hinge loss, while the fake and real terms cancel) did
    not, nor did netE's fc_var, which has no gradient and no Adam state."""
    moved, zero = 0, []
    for name, net in nets_of(state.model).items():
        optimizer = state.opt_d if name == "D" else state.opt_g
        params = dict(net.named_parameters())
        for k, t in net.state_dict().items():
            if "num_batches_tracked" in k:
                continue
            same = torch.equal(t.detach().cpu(), before[name][k])
            p = params.get(k)
            if name == "E" and k.startswith("fc_var."):
                want_same = True
                if p.grad is not None or p in optimizer.state:
                    raise AssertionError(f"{dname}: netE.{k} was trained")
            elif p is None:
                want_same = False                 # a buffer
            else:
                sq = optimizer.state[p]["exp_avg_sq"]
                want_same = not bool(sq.any())
                if want_same:
                    zero.append(f"{name}.{k}")
            if same != want_same:
                raise AssertionError(f"{dname}: {name}.{k} "
                                     + ("did not move" if same else "moved"))
            moved += not same
    log(f"  {dname}: {moved} parameters and buffers of G, E and D moved "
        "(every spectral u/v and running statistic among them); netE fc_var "
        f"unchanged, no gradient; zero gradient at every step: {zero}")


def check_packed(dname, model):
    """Every norm site serves the packing of its current weights: the card's
    Adam step moved each weight's ``_version``, the key of the kernel's
    packed copies, so the D step's forward did not run on the weights from
    before the G step's update."""
    from seg2eye_tpu_torch.models.normalization import SpadeStyleBlock
    from seg2eye_tpu_torch.ops import spade_style as K

    sites = [m for m in model.netG.modules() if isinstance(m, SpadeStyleBlock)]
    for m in sites:
        s = m.spade
        ws = (s.mlp_gamma.weight, s.mlp_gamma.bias, s.mlp_beta.weight,
              s.mlp_beta.bias)
        with torch.no_grad():
            got = K.packed_weights(*ws, model.dtype)
            want = K.pack_weights(*ws, model.dtype)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{dname}: a norm site kept the packed "
                                 "weights from before the optimizer step")
    log(f"  {dname}: all {len(sites)} norm sites serve the packing of their "
        "updated weights")


def pool_card_vs_cpu():
    """The discriminator's downsampler alone: PyTorch's CUDA backward of
    this pool on channels_last input is wrong, so the port pools a
    contiguous copy."""
    from seg2eye_tpu_torch.ops.image import avg_pool_3x3s2

    gen = torch.Generator().manual_seed(2)
    x, w = torch.randn(4, 160, 128, 5, generator=gen), torch.randn(
        4, 80, 64, 5, generator=gen)
    pool_grads = []
    for device in ("cuda", "cpu"):
        t = x.to(device).requires_grad_(True)
        (avg_pool_3x3s2(t) * w.to(device)).sum().backward()
        pool_grads.append(t.grad.cpu())
    pool_err = float((pool_grads[0] - pool_grads[1]).abs().max())
    log(f"card vs CPU, avg_pool_3x3s2 input gradient: max abs diff "
        f"{pool_err:.3e} (tolerance 1e-6)")
    if not pool_err <= 1e-6:
        raise AssertionError("the pool's gradient on the card is not the "
                             "CPU's")


def card_vs_cpu(what="", **options):
    """One float32 iteration of a small model (CARD_CPU, with ``options``)
    on the card (kernel) and on the CPU (plain version), from the same
    weights and batch."""
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.train.state import ttur_lrs
    from seg2eye_tpu_torch.utils.weights import init_networks

    opt = Options(**{**CARD_CPU, **options,
                     "compute_dtype": "float32"}).finalize()
    nets = init_networks(opt, torch.Generator().manual_seed(1), "cpu")
    batch = make_train_batch(opt, opt.batchSize, seed=3)
    log(f"card vs CPU, one float32 iteration at ngf {opt.ngf}, ndf "
        f"{opt.ndf}, crop {opt.crop_size}, batch {opt.batchSize}{what}: the "
        "G step from the same weights, then the D step from the same state "
        "(the CPU's after its G step) (losses card/CPU)")
    cpu, card = train_state(opt, nets, "cpu"), train_state(opt, nets, "cuda")
    g_lr, d_lr = ttur_lrs(opt, opt.lr)
    failures = []
    for half, checked, lr in (("G step", ("G", "E"), g_lr),
                              ("D step", ("D",), d_lr)):
        if half == "G step":
            l_card, l_cpu = (steps.g_step(s_, batch)[0] for s_ in (card, cpu))
        else:
            card = state_on(cpu, "cuda")
            l_card, l_cpu = (steps.d_step(s_, batch) for s_ in (card, cpu))
        where = f"card vs CPU, {half}"
        failures += compare_losses(
            where, {k: float(v) for k, v in l_card.items()},
            {k: float(v) for k, v in l_cpu.items()}, None, CARD_CPU_LOSS_RTOL)
        failures += compare_grads(
            where, {k: None if g is None else g.cpu()
                    for k, g in grads_of(card.model).items()},
            grads_of(cpu.model), None, "card - CPU", checked)
        failures += compare_state(where, card, cpu, lr)
    if failures:
        raise AssertionError("; ".join(failures))


def state_on(state, device):
    """A copy of a TrainState on ``device``: networks, Adam states, step."""
    new = train_state(state.model.opt, all_nets(state.model), device)
    new.opt_g.load_state_dict(state.opt_g.state_dict())
    new.opt_d.load_state_dict(state.opt_d.state_dict())
    new.step = state.step
    return new


def compare_state(where, card, cpu, lr):
    """-> failures: spectral u/v, running statistics and parameters of the
    two states (on any devices), as CARD_CPU_* states."""
    sd_card = {f"{n}.{k}": t.detach().cpu() for n, net in
               nets_of(card.model).items() for k, t in net.state_dict().items()}
    uv = run = worst_param = 0.0
    flipped = total = 0
    for n, net in nets_of(cpu.model).items():
        for k, t in net.state_dict().items():
            if "num_batches_tracked" in k:
                continue
            t = t.detach().cpu()
            diff = (sd_card[f"{n}.{k}"] - t).abs()
            if k.endswith(("weight_u", "weight_v")):
                uv = max(uv, float(diff.max()))
            elif k.endswith(("running_mean", "running_var")):
                run = max(run, float(diff.norm() / t.norm()))
            else:
                flipped += int((diff > CARD_CPU_PARAM_ATOL).sum())
                total += diff.numel()
                worst_param = max(worst_param, float(diff.max()))
    step = 2 * lr + CARD_CPU_PARAM_ATOL
    log(f"    spectral u/v max abs diff {uv:.3e} (tolerance "
        f"{CARD_CPU_UV_ATOL}); running statistics, worst ||diff|| / ||stat|| "
        f"{run:.3e} (tolerance {CARD_CPU_RUN_RTOL}); parameters: {flipped} "
        f"of {total} elements ({flipped / total:.2e}) beyond "
        f"{CARD_CPU_PARAM_ATOL} (tolerance {CARD_CPU_FLIPPED}), largest "
        f"{worst_param:.3e} (tolerance 2 lr + atol = {step:.3e})")
    if (uv > CARD_CPU_UV_ATOL or run > CARD_CPU_RUN_RTOL
            or flipped > CARD_CPU_FLIPPED * total or worst_param > step):
        return [f"{where}: updated state differs"]
    return []


class InMemoryBatches:
    """The training loops' dataloader interface over batches in memory,
    with a ``dataset`` of the matching length (RefineNet's main_loop reads
    it)."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = [None] * sum(len(b["input" if "input" in b
                                          else "label"]) for b in batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def skip_next_batches(self, n):
        raise AssertionError("not resuming")

    def __iter__(self):
        return iter(self.batches)


def train_entry_point(per_iteration=None, **options):
    """``train.loop.train`` for LOOP_STEPS steps of the default model (with
    ``options``) into a temporary checkpoints_dir: ``per_iteration`` kernel
    launches each (TRAIN_LAUNCHES by default), ``src.zip`` written, and
    with ``profile_steps`` the trace; its latest G and E score a batch."""
    import os
    import tempfile

    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.train.loop import train
    from seg2eye_tpu_torch.utils.checkpoint import load_networks

    with tempfile.TemporaryDirectory() as tmp:
        # losses printed every step; one checkpoint, the final 'latest'
        opt = Options(batchSize=TRAIN_BATCH, checkpoints_dir=tmp,
                      name="chip_smoke", print_freq=TRAIN_BATCH,
                      save_epoch_freq=10 ** 6, **options).finalize()
        per_iteration = per_iteration or TRAIN_LAUNCHES
        batches = [make_train_batch(opt, TRAIN_BATCH, seed=10 + i)
                   for i in range(LOOP_STEPS + 1)]
        K.spade_style.launches = 0
        t0 = time.perf_counter()
        result = train(opt, max_steps=LOOP_STEPS,
                       dataloader=InMemoryBatches(batches), device="cuda")
        seconds = time.perf_counter() - t0
        launches = K.spade_style.launches
        if result["steps"] != LOOP_STEPS or launches != LOOP_STEPS * \
                per_iteration:
            raise AssertionError(f"train.loop.train ran {result['steps']} "
                                 f"steps and {launches} kernel launches, "
                                 f"expected {LOOP_STEPS} and "
                                 f"{LOOP_STEPS * per_iteration}")
        if not all(np.isfinite(v) for v in result["losses"].values()):
            raise AssertionError(f"non-finite losses {result['losses']}")
        written = [f for f in ("src.zip", "profile/trace.json")
                   if os.path.exists(os.path.join(opt.expr_dir, f))]
        if written != ["src.zip", "profile/trace.json"][
                :1 + bool(opt.profile_steps)]:
            raise AssertionError(f"train.loop.train wrote {written}")
        nets = load_networks(build_networks(opt.replace(isTrain=False)), opt,
                             "latest")
        trained = result["state"].model.netG.state_dict()
        for k, t in nets["G"].state_dict().items():
            if not torch.equal(t, trained[k].cpu()):
                raise AssertionError(f"latest_net_G.pth: {k} is not the "
                                     "trained weight")
        del result, trained
        model = Pix2Pix(opt.replace(isTrain=False), nets, "cuda")
        errors, fake = Tester(model.opt).score_batch(model, batches[0])
    if not (np.isfinite(errors).all() and np.isfinite(fake).all()):
        raise AssertionError("the trained checkpoint scores non-finite")
    log(f"train.loop.train: {LOOP_STEPS} steps of the default model "
        f"(bfloat16, batch {TRAIN_BATCH}{', ' if options else ''}"
        f"{', '.join(f'{k} {v}' for k, v in options.items())}) in "
        f"{seconds:.1f} s, set-up included, {launches} kernel launches; "
        f"wrote {', '.join(written)}; latest_net_G/E.pth strict-loaded and "
        f"scored a batch (mean x1471 = {float(np.mean(errors)) * 1471:.2f})")
    return launches


def phase_train():
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    opt = Options(batchSize=TRAIN_BATCH).finalize()
    t0 = time.perf_counter()
    nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
    counts = {k: sum(p.numel() for p in v.parameters())
              for k, v in nets_cpu.items()}
    want = {**EXPECTED_PARAMS, "D": EXPECTED_D_PARAMS}
    log(f"train: default model, params G {counts['G']:,} E {counts['E']:,} "
        f"D {counts['D']:,}, seeded init {time.perf_counter() - t0:.1f} s")
    if counts != want:
        raise AssertionError(f"parameter counts {counts} != {want}")
    before = {n: {k: t.detach().clone() for k, t in net.state_dict().items()}
              for n, net in nets_cpu.items()}
    batch = make_train_batch(opt, TRAIN_BATCH)
    flags = tf32_flags()
    launches = {}
    for dname in ("float32", "bfloat16"):
        dopt = opt.replace(compute_dtype=dname)
        state = train_state(dopt, nets_cpu)
        log(f"train {dname}: kernel route against plain route, "
            f"{ROUTE_ITERS} iterations, each from identical copies of the "
            "kernel route's state (losses kernel/plain)")
        lockstep(dname, state, batch, None if dname == "float32"
                 else opt.replace(compute_dtype="float32"))
        K.spade_style.launches = K.spade_style.backward_launches = 0
        timed_iteration(state, batch)
        launches[dname] = K.spade_style.launches
        backward = K.spade_style.backward_launches
        if launches[dname] != TRAIN_LAUNCHES:
            raise AssertionError(f"{dname}: kernel launched "
                                 f"{launches[dname]} times in one training "
                                 f"iteration, expected {TRAIN_LAUNCHES}")
        if backward != BACKWARD_LAUNCHES[dname]:
            raise AssertionError(f"{dname}: backward kernel launched "
                                 f"{backward} times in one training "
                                 f"iteration, expected "
                                 f"{BACKWARD_LAUNCHES[dname]}")
        ms, peak = timed(state, batch)
        check_trained(dname, state, before)
        check_packed(dname, state.model)
        plain = clone_state(state)
        del state
        torch.cuda.empty_cache()
        p_ms, p_peak = timed(plain, batch, plain=True)
        del plain
        torch.cuda.empty_cache()
        if tf32_flags() != flags:
            raise AssertionError(f"{dname}: training left the TF32 flags at "
                                 f"{tf32_flags()}, not {flags}")
        log(f"train {dname} bs{TRAIN_BATCH}: {launches[dname]} kernel "
            f"launches and {backward} of the backward kernel per iteration; "
            f"kernel route {ms:.2f} ms/iteration, "
            f"{TRAIN_BATCH / ms * 1e3:.2f} img/s, peak {peak:.2f} GiB; plain "
            f"route {p_ms:.2f} ms/iteration, {TRAIN_BATCH / p_ms * 1e3:.2f} "
            f"img/s, peak {p_peak:.2f} GiB (median of {TIMED_ITERS}, host "
            "clock, synchronised)")
    pool_card_vs_cpu()
    card_vs_cpu()
    train_entry_point()
    return launches


# ---------------------------------------------------------------- phase 7
# 7a: the default model with affine batch sub-norms in E and D (per-sample
# encoding on through 'auto') and the VGG loss (seeded VGG19, weight 10)
OPTIONS_7A = dict(norm_E="spectralbatch", norm_D="spectralbatch",
                  no_vgg_loss=False, lambda_vgg=10.0)
# 7b: --remat at crop 512 (640x512 images), batch 8, default norms
REMAT_7B = dict(crop_size=512, aspect_ratio=0.8, batchSize=8)
# K1 launches in one --remat iteration: the G step's forward (18), its
# backward's recompute of every block (non-reentrant checkpointing stops
# once the last saved tensor is back, conv_1's input, which follows the
# block's last norm site, so all 18 sites rerun), and the D step's
# regeneration of the fake under no_grad, where nothing is checkpointed
# (18)
REMAT_LAUNCHES = 3 * len(SITES)
OPTIONS_TIMED_ITERS = 3


def moved_statistics(model, before, nets=("E", "D")):
    """-> (moved, total) running statistics of ``nets``."""
    moved = total = 0
    for name in nets:
        for k, t in nets_of(model)[name].state_dict().items():
            if "running_" in k:
                total += 1
                moved += not torch.equal(t.detach().cpu(), before[name][k])
    return moved, total


def options_batchnorm_vgg(nets_cpu, opt, batch):
    """7a in each dtype: kernel route against plain route (lockstep), 36
    launches per iteration, every E/D running statistic moved, timings."""
    from seg2eye_tpu_torch.ops import spade_style as K

    before = {n: {k: t.detach().clone() for k, t in net.state_dict().items()}
              for n, net in nets_cpu.items() if n != "VGG"}
    out = {}
    for dname in ("float32", "bfloat16"):
        dopt = opt.replace(compute_dtype=dname)
        state = train_state(dopt, nets_cpu)
        log(f"options {dname}: batch sub-norms in E and D, per-sample "
            f"encoding, VGG loss; kernel route against plain route, "
            f"{ROUTE_ITERS} iterations from identical states (losses "
            "kernel/plain)")
        lockstep(dname, state, batch, None if dname == "float32"
                 else opt.replace(compute_dtype="float32"))
        K.spade_style.launches = 0
        timed_iteration(state, batch)
        launches = K.spade_style.launches
        if launches != TRAIN_LAUNCHES:
            raise AssertionError(f"7a {dname}: {launches} kernel launches "
                                 f"in one iteration, expected "
                                 f"{TRAIN_LAUNCHES}")
        check_trained(f"7a {dname}", state, before)
        moved, total = moved_statistics(state.model, before)
        if moved != total or total == 0:
            raise AssertionError(f"7a {dname}: {moved} of {total} E/D "
                                 "running statistics moved")
        ms, peak = timed(state, batch, iters=OPTIONS_TIMED_ITERS)
        plain = clone_state(state)
        del state
        torch.cuda.empty_cache()
        p_ms, p_peak = timed(plain, batch, plain=True,
                             iters=OPTIONS_TIMED_ITERS)
        del plain
        torch.cuda.empty_cache()
        out[dname] = (ms, peak, p_ms, p_peak)
        log(f"options {dname} bs{opt.batchSize}: {launches} kernel launches "
            f"per iteration; all {total} running statistics of E and D "
            f"moved; kernel route {ms:.2f} ms/iteration, "
            f"{opt.batchSize / ms * 1e3:.2f} img/s, peak {peak:.2f} GiB; "
            f"plain route {p_ms:.2f} ms/iteration, "
            f"{opt.batchSize / p_ms * 1e3:.2f} img/s, peak {p_peak:.2f} GiB "
            f"(median of {OPTIONS_TIMED_ITERS})")
    return out


def buffers_equal(where, a, b):
    """-> failures: every spectral u/v and running statistic of the two
    models bit for bit equal."""
    bad = [f"{n}.{k}" for n, net in nets_of(a).items()
           for k, t in net.state_dict().items()
           if k.endswith(("weight_u", "weight_v", "running_mean",
                          "running_var"))
           and not torch.equal(t, nets_of(b)[n].state_dict()[k])]
    log(f"    {where}: spectral u/v and running statistics "
        + ("bit for bit equal" if not bad else f"differ at {bad[:4]}"))
    return [f"{where}: buffers differ at {bad[:4]}"] if bad else []


def options_remat(nets_cpu, opt, batch):
    """7b in each dtype: the G step and then the D step of one iteration,
    with and without --remat from identical states (losses and gradients
    within F32_ROUTE, u/v and running statistics bit for bit); the
    launches; ms/iteration and the peak memory of both."""
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.train import steps

    out = {}
    for dname in ("float32", "bfloat16"):
        dopt = opt.replace(compute_dtype=dname)
        ropt = dopt.replace(remat=True)
        plain, remat = train_state(dopt, nets_cpu), train_state(ropt,
                                                                nets_cpu)
        log(f"remat {dname}: crop {opt.crop_size} ({opt.image_height}x"
            f"{opt.image_width}), bs{opt.batchSize}, one iteration with and "
            "without --remat from identical states (losses with/without)")
        failures, launches = [], {}
        for half in ("G step", "D step"):
            if half == "D step":
                remat = clone_state(plain, ropt)
            losses = {}
            for r, s_ in ((False, plain), (True, remat)):
                K.spade_style.launches = 0
                l_ = (steps.g_step(s_, batch)[0] if half == "G step"
                      else steps.d_step(s_, batch))
                torch.cuda.synchronize()
                launches[(r, half)] = K.spade_style.launches
                losses[r] = {k: float(v) for k, v in l_.items()}
            where = f"remat {dname}, {half}"
            failures += compare_losses(where, losses[True], losses[False],
                                       None)
            failures += compare_grads(
                where, grads_of(remat.model), grads_of(plain.model), None,
                "remat - plain", ("G", "E") if half == "G step" else ("D",))
            failures += buffers_equal(where, remat.model, plain.model)
        n_remat = launches[(True, "G step")] + launches[(True, "D step")]
        n_plain = launches[(False, "G step")] + launches[(False, "D step")]
        if (n_plain, n_remat) != (TRAIN_LAUNCHES, REMAT_LAUNCHES):
            failures.append(f"remat {dname}: {n_plain} and {n_remat} kernel "
                            f"launches per iteration, expected "
                            f"{TRAIN_LAUNCHES} and {REMAT_LAUNCHES}")
        if failures:
            raise AssertionError("; ".join(failures))
        del plain
        torch.cuda.empty_cache()
        ms_r, peak_r = timed(remat, batch, iters=OPTIONS_TIMED_ITERS)
        plain = clone_state(remat, dopt)
        del remat
        torch.cuda.empty_cache()
        ms_p, peak_p = timed(plain, batch, iters=OPTIONS_TIMED_ITERS)
        del plain
        torch.cuda.empty_cache()
        log(f"remat {dname} crop {opt.crop_size} bs{opt.batchSize}: kernel "
            f"launches per iteration {n_plain} without, {n_remat} with; "
            f"without {ms_p:.2f} ms/iteration, peak {peak_p:.2f} GiB; with "
            f"{ms_r:.2f} ms/iteration, peak {peak_r:.2f} GiB (median of "
            f"{OPTIONS_TIMED_ITERS})")
        if not peak_r < peak_p:
            raise AssertionError(f"remat {dname}: peak {peak_r:.2f} GiB is "
                                 f"not below {peak_p:.2f} GiB without it")
        out[dname] = (n_remat, ms_p, peak_p, ms_r, peak_r)
    return out


def phase_options():
    """7a-7d: batch sub-norms with per-sample encoding and the VGG loss,
    --remat at crop 512, card against CPU with all of them, and the loop
    with --remat and --profile_steps."""
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    t_phase = time.perf_counter()
    opt = Options(batchSize=TRAIN_BATCH, **OPTIONS_7A).finalize()
    if not opt.per_sample_encode_enabled:
        raise AssertionError("per-sample encoding is not on for a "
                             "batch-subnorm encoder")
    nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
    vgg = sum(p.numel() for p in nets_cpu["VGG"].parameters())
    log(f"options: default model with norm_E = norm_D = spectralbatch, "
        f"per_sample_encode auto (on), VGG19 to relu5_1 ({vgg:,} seeded "
        f"parameters, frozen), lambda_vgg {opt.lambda_vgg}")
    timings = {"7a": options_batchnorm_vgg(
        nets_cpu, opt, make_train_batch(opt, TRAIN_BATCH, seed=4))}
    del nets_cpu
    opt = Options(**REMAT_7B).finalize()
    nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
    timings["7b"] = options_remat(nets_cpu, opt,
                                  make_train_batch(opt, opt.batchSize, 5))
    del nets_cpu
    card_vs_cpu(", batch sub-norms, per-sample encoding, VGG, remat",
                remat=True, **OPTIONS_7A)
    timings["7d"] = train_entry_point(REMAT_LAUNCHES, remat=True,
                                      profile_steps=1)
    log(f"options: phase 7 in {time.perf_counter() - t_phase:.1f} s")
    return timings


# ---------------------------------------------------------------- phase 6
RN_SERVE_BATCH, RN_TRAIN_STEPS, RN_SERVE_REPEATS = 32, 3, 5
RN_DEVICE = "cuda"
RN_CONFIGS = {"SegNet": "refinenet/configs/segnet.json",
              "RefineNet": "refinenet/configs/refinenet.json"}
# (model, backbone): parameters (tests/test_refinenet.py's counts; SegNet
# has 771 more, its 4-class head); dtypes of the full-width rows
RN_PARAMS = {("SegNet", "resnet"): 59_339_940,
             ("RefineNet", "resnet"): 59_339_169,
             ("SegNet", "xception"): 54_700_948,
             ("RefineNet", "xception"): 54_700_177,
             ("SegNet", "drn"): 40_732_692,
             ("RefineNet", "drn"): 40_731_921}
RN_ROW_DTYPES = {("SegNet", "xception"): ("bfloat16",),
                 ("RefineNet", "drn"): ("bfloat16",)}
# card against CPU, one eval forward and one train step of a tiny config
# (ResNet-14, 64x40) from identical states, in float32 (the card's cuDNN in
# full float32) and in float64.  Distances: outputs and losses relative to
# 1 + |x|, running statistics max abs, gradients, update and momentum per
# tensor ||d|| / (||x|| + RN_NET_FLOOR ||x of the net||).  The train-mode
# BNs over few values amplify round-off into the gradients: float32 CPU
# runs are 2e-5 to 5e-3 from a float64 run of the same step (measured), so
# float32 gradients are held at 5e-2, which a wrong kernel (PR 4's
# avg_pool2d backward: 105%) misses by far; float64 (where only the loss
# head stays float32, on both sides) holds them to 1e-4 (measured 1.6e-13
# to 2.0e-7 on an H100).  Batch 4, not 2: at batch 2 the ASPP global
# pool's BN normalises over two values per channel.  The BN affine parameters start from a seeded perturbation
# of the init: at the init itself a MobileNet block's fixed padding passes
# through the expand conv and a BN whose input has zero mean (the previous
# block's BN output), so the padded border comes out of that BN as 0 up to
# round-off (1e-17), and ReLU6's gradient there (passed at x >= 0, blocked
# below) is decided by the round-off: CPU against CPU in another memory
# layout, in float64, 14-38% apart in those BNs' bias gradients.
RN_CARD_CPU = dict(resnet_depth=14, input_height=64, input_width=40,
                   batch_size=4, test_batch_size=4)
# Xception and DRN run at full depth there: their float32 round-off,
# through about 130 and 60 train-mode BNs over 48-160 values a channel,
# reaches the gradients 10 times further than ResNet-14's (SegNet-DRN:
# 1.2e-1 on the card and on the CPU), so their float32 distances are held
# within RN_GAP_RATIO times the CPU's own float32-vs-float64 distance where
# that is above RN_CARD_CPU_TOL (as the CPU tests hold the port against
# JAX), and float64 to RN_CARD_CPU_TOL (measured 1.4e-8 to 3.8e-8 in the
# gradients on an H100).
RN_FULL_DEPTH = ("xception", "drn")
RN_GAP_RATIO = 2.0
RN_NET_FLOOR = 1e-2
RN_CARD_CPU_TOL = {
    "float32": {"outputs": 1e-4, "losses": 1e-4, "statistics": 1e-4,
                "gradients": 5e-2, "update": 5e-2, "momentum": 5e-2},
    "float64": {"outputs": 1e-5, "losses": 1e-5, "statistics": 1e-5,
                "gradients": 1e-4, "update": 1e-4, "momentum": 1e-4}}


def rn_config(name, **kw):
    from seg2eye_tpu_torch.refinenet.config import RefineNetConfig

    return RefineNetConfig.from_json(RN_CONFIGS[name], **kw)


def rn_model(name, cfg, device):
    from seg2eye_tpu_torch.refinenet import model

    cls = model.SegNetModel if name == "SegNet" else model.RefineNetModel
    return cls(cfg, device)


def rn_trainer(name, model):
    from seg2eye_tpu_torch.refinenet.training import Trainer

    return Trainer(model, model.cfg, "ce_loss" if name == "SegNet"
                   else "eds_loss", 0.9 if name == "SegNet" else 0.99)


def rn_batch(name, cfg, b, seed=0, device=None):
    """A seeded uint8 batch as the loader gives it, on ``device`` (the
    card by default)."""
    device = device or RN_DEVICE
    rng = np.random.default_rng(seed)
    h, w = cfg.input_height, cfg.input_width
    c = 1 if name == "SegNet" else 3
    batch = {"input": rng.integers(0, 256, (b, h, w, c), dtype=np.uint8),
             "target": (rng.integers(0, 4, (b, h, w), dtype=np.uint8)
                        if name == "SegNet" else
                        rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8))}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def rn_flops(name, model):
    """(forward FLOPs of one image in eval, of one image's training step:
    forward and backward) at the model's input size, counted by
    ``utils.roofline.flops_of`` (convolutions, their backward with their
    groups; the rest is noise)."""
    from seg2eye_tpu_torch.utils import roofline

    cfg = model.cfg

    def step():
        out = model.forward(rn_batch(name, cfg, 2), train=True)
        out["ce_loss" if name == "SegNet" else "eds_loss"].backward()

    with torch.no_grad():
        fwd = roofline.flops_of(model.forward, rn_batch(name, cfg, 1),
                                train=False)
    state = {k: v.clone() for k, v in model.net.state_dict().items()}
    train = roofline.flops_of(step)
    model.net.load_state_dict(state)
    model.net.zero_grad(set_to_none=True)
    return fwd, train / 2


def rn_bound_ms(flops, dname):
    """The least time of ``flops`` at the card's peak for the compute
    dtype (``utils.roofline``): the tensor cores' bf16 rate, or the FP32
    pipes' (the port keeps float32 out of TF32)."""
    from seg2eye_tpu_torch.utils import roofline

    return roofline.compute_ms(flops, DTYPES[dname])


def rn_serve(name, trainer, state, dname, flops):
    """eval_step at bs32: checks, then the median host-clock ms of
    RN_SERVE_REPEATS synchronised batches and the peak memory."""
    cfg = state.model.cfg
    batch = rn_batch(name, cfg, RN_SERVE_BATCH, seed=1)
    if name == "SegNet":                  # masks for unlabeled images
        del batch["target"]
    out = trainer.eval_step(state, batch)                  # warm-up
    pred = out["prediction"]
    if name == "SegNet":
        if pred.shape != (RN_SERVE_BATCH, cfg.input_height, cfg.input_width) \
                or int(pred.min()) < 0 or int(pred.max()) > 3:
            raise AssertionError(f"SegNet ({cfg.backbone}) {dname}: "
                                 f"predictions {pred.shape}, "
                                 f"range {int(pred.min())}..{int(pred.max())}")
        extra = f"classes {torch.bincount(pred.flatten().long(), minlength=4).tolist()}"
    else:
        score = float(out["score"])
        if not (torch.isfinite(pred).all() and float(pred.abs().max()) <= 1.0
                and np.isfinite(score)):
            raise AssertionError(f"RefineNet ({cfg.backbone}) {dname}: "
                                 "prediction or score "
                                 "not finite and in [-1, 1]")
        extra = f"score {score:.2f}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RN_SERVE_REPEATS):
        t0 = time.perf_counter()
        trainer.eval_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    bound = rn_bound_ms(flops * RN_SERVE_BATCH, dname)
    log(f"  serve {name} ({cfg.backbone}) {dname} bs{RN_SERVE_BATCH}: "
        f"{ms:.2f} ms/batch, "
        f"{RN_SERVE_BATCH / ms * 1e3:.2f} img/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; bound "
        f"{bound:.2f} ms ({flops * RN_SERVE_BATCH / 1e12:.3f} TFLOP), "
        f"{100 * bound / ms:.1f}% of it; {extra} (median of "
        f"{RN_SERVE_REPEATS}, host clock, synchronised)")
    return ms


def rn_train(name, trainer, state, dname, flops):
    """RN_TRAIN_STEPS train steps at the config's batch (dropout on, as
    main_loop runs them), after one warm-up step: finite losses, every
    parameter with a nonzero gradient moved, every running statistic
    moved; median ms/step and peak memory."""
    from seg2eye_tpu_torch.refinenet.training import dropout_generator

    cfg = state.model.cfg
    lr = cfg.learning_rate
    net = state.model.net
    trainer.train_step(state, rn_batch(name, cfg, cfg.batch_size, seed=2), lr,
                       dropout_generator(cfg, 0, RN_DEVICE))        # warm-up
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    nonzero = set()
    for step in range(RN_TRAIN_STEPS):
        batch = rn_batch(name, cfg, cfg.batch_size, seed=3 + step)
        t0 = time.perf_counter()
        scalars, _ = trainer.train_step(state, batch, lr,
                                        dropout_generator(cfg, step + 1,
                                                          RN_DEVICE))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in scalars.items()})
        nonzero |= {n for n, p in net.named_parameters()
                    if p.grad is not None and bool(p.grad.any())}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(v) for d in losses for v in d.values()):
        raise AssertionError(f"{name} ({cfg.backbone}) {dname}: non-finite "
                             f"losses {losses}")
    after = net.state_dict()
    params = dict(net.named_parameters())
    stuck = [k for k in after if "num_batches" not in k
             and (k in nonzero or k not in params)
             and torch.equal(after[k], before[k])]
    if stuck:
        raise AssertionError(f"{name} ({cfg.backbone}) {dname}: did not "
                             f"move: {stuck[:5]}")
    ms = statistics.median(times)
    bound = rn_bound_ms(flops * cfg.batch_size, dname)
    key = "ce_loss" if name == "SegNet" else "eds_loss"
    log(f"  train {name} ({cfg.backbone}) {dname} bs{cfg.batch_size} "
        "(momentum "
        f"{trainer.momentum}, clip {cfg.gradient_norm_clip}, lr {lr:g}): "
        f"{ms:.2f} ms/step, {cfg.batch_size / ms * 1e3:.2f} img/s, peak "
        f"{peak:.2f} GiB; bound {bound:.2f} ms "
        f"({flops * cfg.batch_size / 1e12:.3f} TFLOP), {100 * bound / ms:.1f}% "
        f"of it; {key} " + ", ".join(f"{d[key]:.4f}" for d in losses)
        + f"; {len(nonzero)} parameters with a nonzero gradient and every "
        "running statistic moved (median of "
        f"{RN_TRAIN_STEPS}, host clock, synchronised)")
    return ms


def rn_gap(got, want):
    """max over tensors of ||got - want|| / (||want|| + floor ||want's
    net||), float32."""
    net = float(torch.sqrt(sum((w.double() ** 2).sum()
                               for w in want.values())))
    return max(float((got[k].double().cpu() - w.double()).norm()
                     / (w.double().norm() + RN_NET_FLOOR * net))
               for k, w in want.items())


def rn_op_checks():
    """Single ops of the DeepLab path on channels_last input, card against
    CPU, input gradients included: max_pool2d (3x3/2, pad 1), a depthwise
    3x3 conv, batch norm in train mode and resize_bilinear_ac."""
    from seg2eye_tpu_torch.ops.image import resize_bilinear_ac
    from seg2eye_tpu_torch.utils.precision import full_float32

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(4, 24, 33, 21, generator=gen)
    wdw = torch.randn(24, 1, 3, 3, generator=gen)
    ops = {"max_pool2d": lambda t, w: F.max_pool2d(t, 3, 2, padding=1),
           "depthwise conv": lambda t, w: F.conv2d(
               F.pad(t, (2, 2, 2, 2)), w, stride=2, dilation=2, groups=24),
           "batch_norm": lambda t, w: F.batch_norm(
               t, None, None, w[:, 0, 0, 0], None, True),
           "resize_bilinear_ac": lambda t, w: resize_bilinear_ac(t, 40, 25)}
    worst = {}
    for name, fn in ops.items():
        outs, grads = [], []
        for device in (RN_DEVICE, "cpu"):
            t = x.to(device).contiguous(memory_format=torch.channels_last) \
                .detach().requires_grad_(True)
            w = wdw.detach().clone().to(device).requires_grad_(True)
            with full_float32():
                y = fn(t, w)
                (y * torch.linspace(-1, 1, y.numel(), device=device)
                 .reshape(y.shape)).sum().backward()
            outs.append(y.detach().cpu())
            grads.append((t.grad.cpu(), w.grad.cpu() if w.grad is not None
                          else torch.zeros(1)))
        err = max(float((outs[0] - outs[1]).abs().max()),
                  *(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                    for a, b in zip(*grads)))
        worst[name] = err
        if not err <= 1e-4:
            raise AssertionError(f"{name}: card and CPU differ by {err:.3e} "
                                 "on channels_last input")
    log("  card vs CPU, single ops on channels_last input, max abs output "
        "difference and largest gradient difference relative to its max "
        "(tolerance 1e-4): " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in worst.items()))


def rn_run(name, cfg, device, batch, x64=False):
    """One eval forward and one train step of a seeded state (BN affine
    parameters perturbed, see RN_CARD_CPU) on ``device``: (eval outputs,
    scalars, gradients, parameter update, momentum, running statistics),
    the state in float64 when ``x64``."""
    model = rn_model(name, cfg, device)
    trainer = rn_trainer(name, model)
    state = trainer.init_state(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in model.net.parameters():
            if p.dim() == 1:                      # BN scale and bias
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(device))
    if x64:
        model.net.double()          # the optimizer keeps the same tensors
        model.dtype = torch.float64
    b = {k: v.to(device) for k, v in batch.items()}
    outs = trainer.eval_step(state, b)
    net = model.net
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    scalars, _ = trainer.train_step(state, b, cfg.learning_rate)
    return (outs, {k: float(v) for k, v in scalars.items()},
            {n: p.grad for n, p in net.named_parameters()},
            {n: p.detach() - before[n] for n, p in net.named_parameters()},
            {n: state.optimizer.state[p]["momentum_buffer"]
             for n, p in net.named_parameters()},
            {k: v for k, v in net.state_dict().items() if "running" in k})


def rn_distances(run, ref):
    """Distances of an rn_run from a reference one: eval outputs and losses
    relative to 1 + |x|, running statistics max abs, gradients, update and
    momentum as rn_gap."""
    outs, scal, grads, upd, mom, stats = run
    routs, rscal, rgrads, rupd, rmom, rstats = ref
    return {
        "outputs": max(float((outs[k].double().cpu() - v.double()).abs().max()
                             / (1 + float(v.double().abs().max())))
                       for k, v in routs.items() if v.is_floating_point()),
        "losses": max(abs(scal[k] - rscal[k]) / (1 + abs(rscal[k]))
                      for k in rscal),
        "statistics": max(float((stats[k].double().cpu() - v.double())
                                .abs().max()) for k, v in rstats.items()),
        "gradients": rn_gap(grads, rgrads), "update": rn_gap(upd, rupd),
        "momentum": rn_gap(mom, rmom)}


def rn_card_vs_cpu():
    """One eval forward and one train step of SegNet, RefineNet, a
    MobileNet RefineNet (ResNet-14 otherwise), SegNet-DRN and
    RefineNet-Xception (full depth) at the tiny config, from identical
    states on the card and on the CPU, in float32 and again in float64:
    outputs, losses, gradients, the parameter update, momentum and running
    statistics within RN_CARD_CPU_TOL (RN_FULL_DEPTH: see there)."""
    rn_op_checks()
    cases = (("SegNet", "resnet"), ("RefineNet", "resnet"),
             ("RefineNet", "mobilenet"), ("SegNet", "drn"),
             ("RefineNet", "xception"))
    for name, backbone in cases:
        cfg = rn_config(name, compute_dtype="float32", backbone=backbone,
                        **RN_CARD_CPU)
        batch = rn_batch(name, cfg, cfg.batch_size, seed=6, device="cpu")
        worst = 0.0
        cpu = {x64: rn_run(name, cfg, "cpu", batch, x64)
               for x64 in (False, True)}
        for dname, x64 in (("float32", False), ("float64", True)):
            d = rn_distances(rn_run(name, cfg, RN_DEVICE, batch, x64),
                             cpu[x64])
            tol = RN_CARD_CPU_TOL[dname]
            own = ""
            if backbone in RN_FULL_DEPTH and not x64:
                gap = rn_distances(cpu[False], cpu[True])
                tol = {k: max(v, RN_GAP_RATIO * gap[k])
                       for k, v in tol.items()}
                own = "; the CPU's own float32 against its float64: " + \
                    ", ".join(f"{k} {v:.2e}" for k, v in gap.items())
            worst = max(worst, *(v / tol[k] for k, v in d.items()))
            log(f"  card vs CPU, {name} ({backbone}), {dname}, batch "
                f"{cfg.batch_size} at {cfg.input_height}x{cfg.input_width}: "
                + ", ".join(f"{k} {v:.2e} ({tol[k]:.3g})"
                            for k, v in d.items()) + own)
        if worst > 1.0:
            raise AssertionError(f"card and CPU disagree: {name} "
                                 f"({backbone}), worst distance/tolerance "
                                 f"{worst:.3f}")


def rn_entry_point():
    """main_loop trains RefineNet for RN_TRAIN_STEPS steps into a temporary
    directory; its last checkpoint reloads into a fresh state, whose
    eval_step equals the trained state's bit for bit."""
    import tempfile

    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager
    from seg2eye_tpu_torch.refinenet.training import main_loop

    with tempfile.TemporaryDirectory() as tmp:
        cfg = rn_config("RefineNet", max_steps=RN_TRAIN_STEPS,
                        output_dir_base=tmp)

        def host(seed):
            return {k: v.cpu().numpy() for k, v in
                    rn_batch("RefineNet", cfg, cfg.batch_size, seed).items()}

        train = InMemoryBatches([host(10 + i)
                                 for i in range(RN_TRAIN_STEPS)])
        test = {"val": InMemoryBatches([host(20)])}
        t0 = time.perf_counter()
        result = main_loop(rn_model("RefineNet", cfg, RN_DEVICE), cfg, train,
                           test, loss_key="eds_loss", model_name="RefineNet")
        seconds = time.perf_counter() - t0
        if result["steps"] != RN_TRAIN_STEPS or not np.isfinite(
                result["final"]["val"]["eds_loss"]):
            raise AssertionError(f"main_loop: {result['steps']} steps, final "
                                 f"{result['final']}")
        fresh_trainer = rn_trainer("RefineNet",
                                   rn_model("RefineNet", cfg, RN_DEVICE))
        fresh = fresh_trainer.init_state(torch.Generator().manual_seed(7))
        step, fresh = CheckpointManager(result["output_dir"]) \
            .load_last_checkpoint(fresh)
        batch = {k: torch.from_numpy(v).to(RN_DEVICE)
                 for k, v in host(20).items()}
        a = result["trainer"].eval_step(result["state"], batch)
        b = fresh_trainer.eval_step(fresh, batch)
        same = all(torch.equal(a[k], b[k]) for k in a)
        if step != RN_TRAIN_STEPS or not same:
            raise AssertionError(f"checkpoint step {step}, eval outputs "
                                 f"equal: {same}")
    log(f"  main_loop: RefineNet {RN_TRAIN_STEPS} steps at bs{cfg.batch_size} "
        f"in {seconds:.1f} s (set-up and final test included); checkpoint "
        f"{step:07d}.ckpt reloads, eval_step bit for bit equal "
        f"(final val eds_loss {result['final']['val']['eds_loss']:.4f})")


def phase_refinenet():
    """The RefineNet system at full width: ResNet-101 (os16), Xception
    (os16) and DRN-D-54 (os8), 640x400, seeded weights, seeded uint8
    batches in memory."""
    from seg2eye_tpu_torch.ops import spade_style as K

    K.spade_style.launches = 0
    t_phase = time.perf_counter()
    flags = tf32_flags()
    times = {}
    for name, backbone in RN_PARAMS:
        cfg = rn_config(name, backbone=backbone)
        t0 = time.perf_counter()
        model = rn_model(name, cfg, RN_DEVICE)
        trainer = rn_trainer(name, model)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        count = sum(p.numel() for p in model.net.parameters())
        fwd, train = rn_flops(name, model)
        depth = f"-{cfg.resnet_depth}" if backbone == "resnet" else ""
        log(f"refinenet: {name} ({backbone}{depth}, os"
            f"{8 if backbone == 'drn' else cfg.output_stride}, "
            f"{cfg.input_height}x{cfg.input_width}): {count:,} parameters, "
            f"seeded init {time.perf_counter() - t0:.1f} s; "
            f"{fwd / 1e9:.1f} GFLOP per image forward, {train / 1e9:.1f} "
            "per image training step")
        if count != RN_PARAMS[(name, backbone)]:
            raise AssertionError(f"{name} ({backbone}): {count} parameters, "
                                 f"expected {RN_PARAMS[(name, backbone)]}")
        for kind, fn, flops in (("serve", rn_serve, fwd),
                                ("train", rn_train, train)):
            for dname in RN_ROW_DTYPES.get((name, backbone), DTYPES):
                model.dtype = DTYPES[dname]       # weights stay float32
                times[(name, backbone, kind, dname)] = fn(
                    name, trainer, state, dname, flops)
        del model, trainer, state
        torch.cuda.empty_cache()
    rn_card_vs_cpu()
    rn_entry_point()
    if K.spade_style.launches:
        raise AssertionError(f"phase 6 launched the SPADE+Style kernel "
                             f"{K.spade_style.launches} times")
    if tf32_flags() != flags:
        raise AssertionError(f"phase 6 left the TF32 flags at {tf32_flags()}")
    log(f"refinenet: phase 6 in {time.perf_counter() - t_phase:.1f} s, no "
        "SPADE+Style launch")
    return times


# ---------------------------------------------------------------- phase 8
SERVE_BATCHES = (1, 16, 32)
SERVE_DEVICE = "cuda"
SERVE_WARMUP, SERVE_REPEATS = 2, 7
# an artifact this much slower than its live model in the same turns has
# lost something the live model does (PR 8's float32 RefineNet program,
# whose dilated convs ran on channels_last input: 5.8 times)
SERVE_SLOWDOWN = 1.5
# the refiners (model, backbone, dtype): ResNet-101 RefineNet and SegNet in
# bfloat16, RefineNet also in float32; RefineNet with Xception and DRN in both
RN_SERVE_CASES = (("SegNet", "resnet", "bfloat16"),
                  ("RefineNet", "resnet", "bfloat16"),
                  ("RefineNet", "resnet", "float32"),
                  ("RefineNet", "xception", "bfloat16"),
                  ("RefineNet", "xception", "float32"),
                  ("RefineNet", "drn", "bfloat16"),
                  ("RefineNet", "drn", "float32"))
# the modules an artifact must load without
SERVING_BLOCKED = ("seg2eye_tpu_torch.models", "seg2eye_tpu_torch.refinenet",
                   "seg2eye_tpu_torch.options", "seg2eye_tpu", "jax", "jaxlib",
                   "flax")
# the serving processes' start: imports of SERVING_BLOCKED (argv[1]) refused
SERVING_REFUSE = r"""
import importlib.abc, json, sys, time
BLOCKED = tuple(json.loads(sys.argv[1]))

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("refused in the serving process: " + name)
        return None

sys.meta_path.insert(0, Refuse())
"""
# run in a fresh process: load each Seg2Eye artifact with the model modules
# refused, serve each batch twice (K1 launches and weight packings counted
# per call, the two calls compared bit for bit, the program's buffers
# before and after), save the first call's outputs for the parent
SERVING_CHILD = SERVING_REFUSE + r"""
import numpy as np, torch
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.serving import load_serving

batches, device, report = json.loads(sys.argv[2]), sys.argv[4], {}
for dname, art, out in json.loads(sys.argv[3]):
    t0 = time.perf_counter()
    served = load_serving(art, device=device)
    load_s = time.perf_counter() - t0
    before = [w.clone() for w in served.weights]
    outs, calls = {}, []
    for bs, seed in batches:
        rng = np.random.default_rng(seed)
        h, w = served.meta["inputs"]["label"]["shape"][1:]
        k = served.meta["inputs"]["style_image"]["shape"][1]
        label = rng.integers(0, 4, (bs, h, w)).astype(np.uint8)
        style = rng.integers(0, 256, (bs, k, h, w, 1)).astype(np.uint8)
        results = []
        for _ in range(2):
            K.spade_style.launches = K.packed_weights.packings = 0
            results.append(served(label, style))
            calls.append([bs, K.spade_style.launches,
                          K.packed_weights.packings])
        same = all(torch.equal(a, b) for a, b in zip(*results))
        calls[-1].append(same)
        outs[bs] = [t.cpu() for t in results[0]]
    unchanged = all(torch.equal(a, b) for a, b in zip(served.weights, before))
    torch.save(outs, out)
    report[dname] = dict(load_s=load_s, calls=calls, unchanged=unchanged,
                         refused=sorted(filter(blocked, sys.modules)))
    del served, before, outs, results
    torch.cuda.empty_cache()
print(json.dumps(report))
"""
# the refiners' artifacts in a fresh process, model modules refused: each
# serves its saved bs32 input once (K1 launches counted), outputs saved
SERVING_CHILD_REFINERS = SERVING_REFUSE + r"""
import numpy as np, torch
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.serving import load_serving

device, report = sys.argv[3], {}
for key, art, x_path, out in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    served = load_serving(art, device=device)
    load_s = time.perf_counter() - t0
    K.spade_style.launches = 0
    got = served(np.load(x_path))
    got = got if isinstance(got, tuple) else (got,)
    torch.save([t.cpu() for t in got], out)
    report[key] = dict(load_s=load_s, launches=K.spade_style.launches,
                       refused=sorted(filter(blocked, sys.modules)))
    del served, got
    torch.cuda.empty_cache()
print(json.dumps(report))
"""


def calibrate_running_stats(model, batch):
    """The generator's running statistics set to the batch statistics of
    one forward on ``batch`` (seeded weights leave them at 0 and 1, which
    would not normalise the activations of a deep site)."""
    from seg2eye_tpu_torch.models.normalization import SpadeStyleBlock

    def take(m, args):
        var, mean = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                   correction=0)
        m.spade.param_free_norm.running_mean.copy_(mean)
        m.spade.param_free_norm.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(take)
             for m in model.netG.modules() if isinstance(m, SpadeStyleBlock)]
    try:
        model.opt = model.opt.replace(eval_use_running_stats=False)
        model.inference(batch)
    finally:
        model.opt = model.opt.replace(eval_use_running_stats=True)
        for h in hooks:
            h.remove()


def serving_batch(opt, bs, seed):
    rng = np.random.default_rng(seed)
    h, w = opt.image_height, opt.image_width
    return (rng.integers(0, 4, (bs, h, w)).astype(np.uint8),
            rng.integers(0, 256, (bs, opt.input_ns, h, w, 1)).astype(np.uint8))


def serve_seg2eye(tmp):
    """The default model at full width, exported in both dtypes on running
    statistics, then served from a process that cannot import the model
    code, and timed against the live model in this one."""
    import os

    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.ops.image import to_255resized
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.serving import export_inference, load_serving
    from seg2eye_tpu_torch.utils.weights import init_networks

    opt = Options(isTrain=False, eval_use_running_stats=True).finalize()
    nets = init_networks(opt, torch.Generator().manual_seed(0), SERVE_DEVICE)
    calib = Pix2Pix(opt.replace(compute_dtype="float32"), nets, SERVE_DEVICE)
    label, style = serving_batch(opt, BATCH, seed=40)
    calibrate_running_stats(calib, {"label": label, "style_image": style})
    batches = [(bs, 50 + bs) for bs in SERVE_BATCHES]
    models, jobs, export_s = {}, [], {}
    for dname in ("bfloat16", "float32"):
        models[dname] = Pix2Pix(opt.replace(compute_dtype=dname), nets,
                                SERVE_DEVICE)
        art = os.path.join(tmp, f"seg2eye_{dname}")
        t0 = time.perf_counter()
        export_inference(models[dname], art)
        export_s[dname] = time.perf_counter() - t0
        jobs.append((dname, art, os.path.join(tmp, f"served_{dname}.pt")))
    size = sum(os.path.getsize(os.path.join(jobs[0][1], f))
               for f in os.listdir(jobs[0][1])) / 2 ** 20
    log(f"serving: default model (ngf {opt.ngf}, crop {opt.crop_size}, "
        f"k={opt.input_ns}) on running statistics calibrated on one seeded "
        f"batch; exported in {export_s['bfloat16']:.1f} s (bfloat16) and "
        f"{export_s['float32']:.1f} s (float32), {size:.1f} MiB each")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVING_CHILD, json.dumps(SERVING_BLOCKED),
         json.dumps(batches), json.dumps(jobs), SERVE_DEVICE], cwd=root,
        env={**os.environ, "PYTHONPATH": root}, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the serving process failed:\n"
                             f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  serving process (model modules refused): "
        f"{time.perf_counter() - t0:.1f} s, start included")
    launches = {}
    for dname, art, out in jobs:
        rep, model = report[dname], models[dname]
        served = torch.load(out)
        fake_tol = SLICE_TOL[dname][0]
        worst = {}
        for bs, seed in batches:
            label, style = serving_batch(opt, bs, seed)
            fake = model.inference({"label": label, "style_image": style})
            f255 = to_255resized(fake)
            got_fake, got_255 = served[bs]
            worst[bs] = (float((got_fake - fake.cpu()).abs().max()),
                         float((got_255 - f255.cpu()).abs().max()),
                         float((fake.abs() < 0.99).float().mean()))
            if not (got_fake.shape == fake.shape and got_255.shape ==
                    (bs, 640, 400, 1) and worst[bs][0] <= fake_tol
                    and worst[bs][1] <= 1):
                raise AssertionError(
                    f"serving {dname} bs{bs}: artifact vs live fake "
                    f"{worst[bs][0]:.3e} (tolerance {fake_tol}), fake_255 "
                    f"{worst[bs][1]} (tolerance 1)")
        # every call launches K1 at every site; only the first packs
        counts = [c[1:3] for c in rep["calls"]]
        want = [[len(SITES), len(SITES)]] + [[len(SITES), 0]] * (
            len(counts) - 1)
        if (counts != want or not all(c[3] for c in rep["calls"][1::2])
                or not rep["unchanged"] or rep["refused"]):
            raise AssertionError(f"serving {dname}: per call [batch, K1 "
                                 f"launches, packings(, bitwise repeat)] "
                                 f"{rep['calls']}, buffers unchanged "
                                 f"{rep['unchanged']}, model modules loaded "
                                 f"{rep['refused']}")
        log(f"  {dname}: loaded in {rep['load_s']:.2f} s; per call [batch, "
            f"K1 launches, weight packings] {[c[:3] for c in rep['calls']]}; "
            "second calls bit for bit equal, buffers unchanged; artifact vs "
            "live (Pix2Pix.inference, to_255resized), max abs diff fake / "
            "fake_255 (share of the live fake inside (-0.99, 0.99)): "
            + ", ".join(f"bs{bs} {a:.3e} / {b:.0f} ({100 * c:.1f}%)"
                        for bs, (a, b, c) in worst.items())
            + f" (tolerance {fake_tol} / 1)")

        # the artifact in this process, timed in turns with the live model
        t0 = time.perf_counter()
        art_model = load_serving(art, device=SERVE_DEVICE)
        load_s = time.perf_counter() - t0
        rows = []
        for bs, seed in batches:
            label, style = (torch.from_numpy(a).to(SERVE_DEVICE)
                            for a in serving_batch(opt, bs, seed))
            art_model(label, style)
            K.spade_style.launches = 0
            art_model(label, style)
            torch.cuda.synchronize()
            if bs == BATCH:
                launches[dname] = K.spade_style.launches
            a_ms, l_ms = time_turns(
                [lambda: art_model(label, style),
                 lambda: model.inference({"label": label,
                                          "style_image": style})],
                SERVE_WARMUP, SERVE_REPEATS)
            if a_ms > SERVE_SLOWDOWN * l_ms:
                raise AssertionError(f"serving {dname} bs{bs}: artifact "
                                     f"{a_ms:.2f} ms, live {l_ms:.2f} ms")
            rows.append(f"bs{bs} {a_ms:.2f} / {l_ms:.2f} ms/batch, "
                        f"{bs / a_ms * 1e3:.1f} / {bs / l_ms * 1e3:.1f} img/s "
                        f"({100 * (a_ms / l_ms - 1):+.1f}%)")
        log(f"  {dname} artifact / live, in turns (CUDA events, median of "
            f"{SERVE_REPEATS}; artifact loaded here in {load_s:.2f} s): "
            + "; ".join(rows))
        del art_model, served
        torch.cuda.empty_cache()
    if launches != {d: len(SITES) for d in DTYPES}:
        raise AssertionError(f"K1 launches per artifact call {launches}")
    return launches


def unclamp_residual(model):
    """Scale and shift RefineNet's last conv so that its residual, at
    seeded weights, has mean 0 and a standard deviation of 0.25 on a seeded
    batch: the prediction, clamp(residual + reference, -1, 1), is then
    mostly inside (-1, 1), so the artifact's prediction is compared where
    it is not clamped (the final align-corners resize keeps a constant, so
    the bias shift moves the residual's mean by as much)."""
    x = rn_batch("RefineNet", model.cfg, 4, seed=2, device=SERVE_DEVICE)
    with torch.no_grad():
        residual = model.forward({"input": x["input"]})["residual"]
        scale = 0.25 / float(residual.std())
        last = model.net.decoder.last_conv[8]
        last.weight.mul_(scale)
        last.bias.mul_(scale).sub_(scale * float(residual.mean()))


def serve_refiners(tmp):
    """SegNet and RefineNet at full width (ResNet-101 and Xception at
    os16, DRN at os8, 640x400) exported on running statistics, reloaded
    and served at bs32 against eval_step: every output bitwise equal
    (RefineNet's prediction and prediction_u8, SegNet's class ids); no K1
    launch.  Then every artifact again from a process that cannot import
    the model code, bitwise equal to this process's artifact outputs."""
    import os

    import numpy as np

    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.serving import export_refiner, load_serving

    states, jobs, expected = {}, [], {}
    for name, backbone, dname in RN_SERVE_CASES:
        if (name, backbone) not in states:
            states.clear()                            # one model at a time
            torch.cuda.empty_cache()
            model = rn_model(name, rn_config(name, backbone=backbone),
                             SERVE_DEVICE)
            trainer = rn_trainer(name, model)
            states[(name, backbone)] = (trainer, trainer.init_state(
                torch.Generator().manual_seed(0)))
            if name == "RefineNet":
                unclamp_residual(model)
        trainer, state = states[(name, backbone)]
        state.model.dtype = DTYPES[dname]            # weights stay float32
        art = os.path.join(tmp, f"{name}_{backbone}_{dname}")
        t0 = time.perf_counter()
        export_refiner(state.model, art)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_serving(art, device=SERVE_DEVICE)
        load_s = time.perf_counter() - t0
        batch = rn_batch(name, state.model.cfg, RN_SERVE_BATCH, seed=1,
                         device=SERVE_DEVICE)
        x = batch["input"]
        live = trainer.eval_step(state, {"input": x})["prediction"]
        K.spade_style.launches = 0
        got = served(x)
        torch.cuda.synchronize()
        if K.spade_style.launches:
            raise AssertionError(f"{name} ({backbone}) artifact launched "
                                 "K1")
        if name == "SegNet":
            diff = int((got != live.to(torch.uint8)).sum())
            ok = got.dtype == torch.uint8 and diff == 0
            what = f"class ids differing {diff}"
        else:
            pred, pred_u8 = got
            live_u8 = torch.clamp((live + 1.0) * (255.0 / 2.0), 0, 255).to(
                torch.uint8)[..., 0]
            d_pred = float((pred - live).abs().max())
            d_u8 = int((pred_u8.int() - live_u8.int()).abs().max())
            inside = float((live.abs() < 1).float().mean())
            ok = d_u8 == 0 and d_pred == 0 and inside > 0.5
            what = (f"prediction max abs diff {d_pred:.3e}, prediction_u8 "
                    f"{d_u8} ({100 * inside:.1f}% of the live prediction "
                    "inside (-1, 1))")
        if not ok:
            raise AssertionError(f"{name} ({backbone}) {dname} artifact vs "
                                 f"eval_step: {what}")
        key = f"{name}_{backbone}_{dname}"
        np.save(os.path.join(tmp, f"{key}_x.npy"), x.cpu().numpy())
        expected[key] = [t.cpu() for t in (got if isinstance(got, tuple)
                                           else (got,))]
        jobs.append((key, art, os.path.join(tmp, f"{key}_x.npy"),
                     os.path.join(tmp, f"{key}_served.pt")))
        a_ms, l_ms = time_turns(
            [lambda: served(x),
             lambda: trainer.eval_step(state, {"input": x})],
            SERVE_WARMUP, SERVE_REPEATS)
        if a_ms > SERVE_SLOWDOWN * l_ms:
            raise AssertionError(f"{name} ({backbone}) {dname} artifact "
                                 f"{a_ms:.2f} ms, live {l_ms:.2f} ms")
        log(f"  {name} ({backbone}) {dname} bs{RN_SERVE_BATCH}: export "
            f"{export_s:.1f} s, "
            f"load {load_s:.2f} s; artifact vs eval_step: {what}; artifact "
            f"{a_ms:.2f} ms/batch ({RN_SERVE_BATCH / a_ms * 1e3:.1f} img/s), "
            f"live {l_ms:.2f} ({RN_SERVE_BATCH / l_ms * 1e3:.1f} img/s), "
            f"{100 * (a_ms / l_ms - 1):+.1f}% (CUDA events, median of "
            f"{SERVE_REPEATS}, in turns)")
        del served
        torch.cuda.empty_cache()
    states.clear()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVING_CHILD_REFINERS,
         json.dumps(SERVING_BLOCKED), json.dumps(jobs), SERVE_DEVICE],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the refiners' serving process failed:\n"
                             f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = []
    for key, _, _, out in jobs:
        rep, served = report[key], torch.load(out)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(served, expected[key]))
        if rep["launches"] or rep["refused"] or diff:
            raise AssertionError(f"{key} in the serving process: K1 launches "
                                 f"{rep['launches']}, model modules loaded "
                                 f"{rep['refused']}, outputs {diff:.3e} from "
                                 "this process's artifact")
        rows.append(f"{key} load {rep['load_s']:.2f} s, {diff:.1e}")
    log(f"  refiners in a serving process (model modules refused, 0 K1 "
        f"launches; {time.perf_counter() - t0:.1f} s, start included), "
        "load time and max abs diff of the outputs from this process's "
        "artifact: " + "; ".join(rows))


def phase_serving():
    """8: the serving artifacts (``seg2eye_tpu_torch.serving``)."""
    import tempfile

    t_phase = time.perf_counter()
    flags = tf32_flags()
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_seg2eye(tmp)
        serve_refiners(tmp)
    if tf32_flags() != flags:
        raise AssertionError(f"phase 8 left the TF32 flags at {tf32_flags()}")
    log(f"serving: phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 9
SEG_DEVICE = "cuda"
# the CLI's pascal defaults on one card (ResNet-101 os16, 21 classes, crop
# 513, batch 4, lr 0.007 poly, SGD momentum 0.9, weight decay 5e-4, the
# head at 10x): 12 training images (3 steps of training(0)) and 10
# validation images (batches of 4, 4 and 2)
SEG_ARGV = ("--dataset", "pascal", "--workers", "0")
SEG_TRAIN_IMAGES, SEG_VAL_IMAGES = 12, 10
SEG_TIMED, SEG_EVAL_REPEATS = 3, 5
# a CPU rehearsal shrinks the phase here (resnet_layers, crop_size)
SEG_OVERRIDES = {}
# card against CPU: ResNet-14 at crop 33, batch 2, from identical states;
# held to phase 6's ResNet-14 limits (RN_CARD_CPU_TOL).  The loss is
# float64 in a float64 run, so nothing there rounds to float32.
SEG_CARD_CPU = dict(resnet_layers=(1, 1, 1, 1), crop_size=33, batch_size=2)
# DeepLab ResNet-101 with 21 classes: RN_PARAMS's RefineNet (1 class) and
# 257 parameters (the classifier's weights and bias) per further class
SEG_PARAMS = 59_339_169 + 20 * 257


class SegData:
    """Seeded, already normalised NHWC images and float32 labels in 0..20
    with an ignored (255) band, in memory: a dataset of the port's
    ``DataLoader``."""

    def __init__(self, n, crop, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.standard_normal((n, crop, crop, 3),
                                          dtype=np.float32)
        labels = rng.integers(0, 21, (n, crop, crop))
        labels[:, :max(1, crop // 8)] = 255
        self.labels = labels.astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index, rng=None):
        return {"image": self.images[index], "label": self.labels[index]}


def seg_args(tmp, *argv, **kw):
    """The CLI's arguments (``argv`` added to SEG_ARGV) with the data root
    ``tmp``, then SEG_OVERRIDES and ``kw`` set."""
    from seg2eye_tpu_torch.segtrain.trainer import (build_argparser,
                                                    finalize_args)

    args = finalize_args(build_argparser().parse_args(
        [*SEG_ARGV, "--data-root", tmp, *argv]))
    args.no_cuda = SEG_DEVICE == "cpu"
    for k, v in {**SEG_OVERRIDES, **kw}.items():
        setattr(args, k, v)
    return args


def seg_trainer(args, train, val):
    """``SegTrainer(args)`` over the in-memory datasets: the training loader
    shuffled with its last short batch dropped, the validation loader in
    order, as ``make_data_loader`` makes them."""
    from seg2eye_tpu_torch.data.openeds import DataLoader
    from seg2eye_tpu_torch.segtrain.trainer import SegTrainer

    return SegTrainer(args, loaders=(
        DataLoader(train, args.batch_size, shuffle=True, drop_last=True,
                   seed=args.seed),
        DataLoader(val, args.batch_size), None, 21))


def seg_batch(data, index, n, device):
    return (torch.from_numpy(data.images[index:index + n]).to(device),
            torch.from_numpy(data.labels[index:index + n]).to(device))


def seg_flops(t):
    """(forward FLOPs of one image in eval, of one image's training step)
    at the crop size, counted as ``rn_flops`` counts them."""
    from seg2eye_tpu_torch.utils import roofline

    crop = t.args.crop_size
    x = torch.zeros(2, crop, crop, 3, device=t.device)
    y = torch.zeros(2, crop, crop, device=t.device)
    with torch.no_grad():
        fwd = roofline.flops_of(t.net, t._input(x[:1]), False)
    state = {k: v.clone() for k, v in t.net.state_dict().items()}
    train = roofline.flops_of(
        lambda: t.criterion(t.net(t._input(x), True), y).backward())
    t.net.load_state_dict(state)
    t.net.zero_grad(set_to_none=True)
    return fwd, train / 2


def seg_moved(where, net, before, nonzero):
    """Every parameter with a nonzero gradient and every running statistic
    moved since ``before``."""
    params = dict(net.named_parameters())
    stuck = [k for k, v in net.state_dict().items()
             if "num_batches" not in k and (k in nonzero or k not in params)
             and torch.equal(v, before[k])]
    if stuck:
        raise AssertionError(f"{where}: did not move: {stuck[:5]}")


def seg_train(t, dname, flops):
    """``training(0)``, 3 steps: finite losses, the LR of both groups equal
    to LRScheduler's (the head's 10x) at each step, every parameter with a
    nonzero gradient and every running statistic moved; the host-clock
    time of each loop iteration (data, step, image dump).  Then
    SEG_TIMED synchronised train steps (dropout on): median ms/step, peak
    memory and the share of the FLOP bound."""
    from seg2eye_tpu_torch.refinenet.training import dropout_generator

    net, bs = t.net, t.args.batch_size
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    loop_ms, losses, lrs, nonzero = [], [], [], set()
    mark = [time.perf_counter()]

    def hook(i, loss):           # the loss was read: the step has finished
        loop_ms.append((time.perf_counter() - mark[0]) * 1e3)
        losses.append(loss)
        lrs.append([g["lr"] for g in t.optimizer.param_groups])
        nonzero.update(n for n, p in net.named_parameters()
                       if p.grad is not None and bool(p.grad.any()))
        mark[0] = time.perf_counter()

    epoch_loss = t.training(0, step_hook=hook)
    want = [[t.scheduler(i, 0), 10 * t.scheduler(i, 0)]
            for i in range(len(losses))]
    if len(losses) != SEG_TRAIN_IMAGES // bs or lrs != want:
        raise AssertionError(f"segtrain {dname}: {len(losses)} steps, "
                             f"group lrs {lrs}, LRScheduler's {want}")
    if not all(np.isfinite(v) for v in losses + [epoch_loss]):
        raise AssertionError(f"segtrain {dname}: losses {losses}")
    seg_moved(f"segtrain {dname}", net, before, nonzero)

    x, y = seg_batch(t.val_loader.dataset, 0, bs, t.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for step in range(SEG_TIMED):
        t0 = time.perf_counter()
        t.train_step(x, y, t.scheduler(0, 1),
                     dropout_generator(t.args, 100 + step, t.device))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    bound = rn_bound_ms(flops * bs, dname)
    log(f"  train {dname} bs{bs} at {t.args.crop_size}x{t.args.crop_size} "
        f"(lr {t.args.lr:g} poly, head 10x, momentum {t.args.momentum}, "
        f"weight decay {t.args.weight_decay}): {ms:.2f} ms/step, "
        f"{bs / ms * 1e3:.2f} img/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; bound "
        f"{bound:.2f} ms ({flops * bs / 1e12:.3f} TFLOP), "
        f"{100 * bound / ms:.1f}% of it (median of {SEG_TIMED} synchronised "
        f"steps, host clock); training(0): losses "
        + ", ".join(f"{v:.4f}" for v in losses) + ", loop iterations "
        + ", ".join(f"{v:.1f}" for v in loop_ms) + " ms (data, step, "
        f"image dump); {len(nonzero)} parameters with a nonzero gradient "
        "and every running statistic moved; group lrs = LRScheduler's")
    return ms


def seg_validate(t, dname, flops):
    """``validation(0)``: the confusion matrix summed from the device
    equals a numpy recount of the same logits (caught by a forward hook),
    mIoU in [0, 1], model_best.ckpt written; then the eval step timed, with
    its peak memory."""
    import os

    captured = []
    hook = t.net.register_forward_hook(
        lambda m, i, o: captured.append(o.detach()))
    try:
        miou = t.validation(0)
    finally:
        hook.remove()
    nc, val = t.nclass, t.val_loader.dataset
    recount = np.zeros((nc, nc), np.int64)
    start = 0
    for logits in captured:
        pred = logits.float().cpu().numpy().argmax(1)
        gt = val.labels[start:start + len(pred)].astype(np.int64)
        start += len(pred)
        keep = (gt >= 0) & (gt < nc)
        recount += np.bincount(nc * gt[keep] + pred[keep],
                               minlength=nc * nc).reshape(nc, nc)
    sizes = [len(v) for v in captured]
    best = os.path.join(t.saver.directory, "model_best.ckpt")
    if (sizes != [4, 4, 2] or start != SEG_VAL_IMAGES
            or not np.array_equal(t.evaluator.confusion, recount)
            or not 0.0 <= miou <= 1.0 or not os.path.isfile(best)):
        raise AssertionError(
            f"segtrain {dname} validation: batches {sizes}, mIoU {miou}, "
            f"matrix equal to the recount: "
            f"{np.array_equal(t.evaluator.confusion, recount)}, "
            f"model_best.ckpt {os.path.isfile(best)}")

    bs = t.args.batch_size
    x, y = seg_batch(val, 0, bs, t.device)
    t.eval_step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SEG_EVAL_REPEATS):
        t0 = time.perf_counter()
        t.eval_step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    bound = rn_bound_ms(flops * bs, dname)
    log(f"  eval {dname} bs{bs}: {ms:.2f} ms/batch, {bs / ms * 1e3:.2f} "
        f"img/s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"bound {bound:.2f} ms ({flops * bs / 1e12:.3f} TFLOP), "
        f"{100 * bound / ms:.1f}% of it (median of {SEG_EVAL_REPEATS}, host "
        f"clock, synchronised); validation(0) over {start} images in "
        f"batches {sizes}: mIoU {miou:.4f}, the device's confusion matrix "
        f"({int(recount.sum())} pixels) equal to the numpy recount, "
        "model_best.ckpt written")
    return ms


def seg_options(tmp, trained, train, val):
    """bfloat16: one step with focal loss and class-balanced weights (the
    batch holds labels in [21, 255): dropped, no device assert); one with
    --freeze-bn (running statistics bit for bit, parameters moved);
    resume from checkpoint.ckpt (eval logits bit for bit, start_epoch and
    best_pred restored) and --ft (no momentum buffer)."""
    import os

    bf16 = ("--precision", "bfloat16")
    lr = trained.scheduler(0, 0)
    x, y = seg_batch(train, 0, trained.args.batch_size, trained.device)
    y = y.clone()
    y[:, -1, :6] = torch.tensor([21.0, 30.0, 100.0, 200.0, 254.0, -1.0])

    t = seg_trainer(seg_args(tmp, *bf16, "--loss-type", "focal",
                             "--use-balanced-weights",
                             checkname="focal"), train, val)
    loss, _ = t.train_step(x, y, lr)
    torch.cuda.synchronize()
    weight = t.criterion.__self__.weight
    if not (np.isfinite(float(loss)) and weight is not None
            and bool(torch.isfinite(weight).all())):
        raise AssertionError(f"focal + balanced weights: loss {float(loss)}")
    focal = float(loss)
    del t

    t = seg_trainer(seg_args(tmp, *bf16, "--freeze-bn", "1",
                             checkname="freeze"), train, val)
    before = {k: v.clone() for k, v in t.net.state_dict().items()}
    t.train_step(x, y, lr)
    after = t.net.state_dict()
    params = dict(t.net.named_parameters())
    frozen = [k for k in after if k not in params]
    if not (frozen and all(torch.equal(after[k], before[k]) for k in frozen)
            and not any(torch.equal(after[k], before[k]) for k in params)):
        raise AssertionError("--freeze-bn: running statistics changed or "
                             "parameters did not move")
    del t

    path = os.path.join(trained.saver.experiment_dir, "checkpoint.ckpt")
    r = seg_trainer(seg_args(tmp, *bf16, resume=path, checkname="resume"),
                    train, val)
    vx, _ = seg_batch(val, 0, trained.args.batch_size, trained.device)
    with torch.no_grad():
        same = torch.equal(trained.net(trained._input(vx), False),
                           r.net(r._input(vx), False))
    restored = (r.args.start_epoch, r.best_pred, len(r.optimizer.state))
    del r
    f = seg_trainer(seg_args(tmp, *bf16, resume=path, ft=True,
                             checkname="ft"), train, val)
    if not (same and restored == (1, trained.best_pred,
                                  len(trained.optimizer.state))
            and f.args.start_epoch == 0 and not f.optimizer.state):
        raise AssertionError(f"resume: eval logits equal {same}, (epoch, "
                             f"best_pred, momentum buffers) {restored}; --ft "
                             f"epoch {f.args.start_epoch}, "
                             f"{len(f.optimizer.state)} momentum buffers")
    log(f"  bfloat16 options: focal + balanced weights (labels 21-254 and -1 "
        f"in the batch) loss {focal:.5f}; --freeze-bn: {len(frozen)} BN "
        "buffers bit for bit, every parameter moved; resumed from "
        f"checkpoint.ckpt: eval logits bit for bit, start_epoch 1, best_pred "
        f"{trained.best_pred:.4f}, {restored[2]} momentum buffers; --ft: "
        "epoch 0, no momentum buffer")


def seg_run(tmp, device, x64):
    """One eval step and one train step (no dropout) of SEG_CARD_CPU's
    seeded trainer (BN affine parameters perturbed as rn_run does) on
    ``device``, in float64 when ``x64``: rn_run's tuple."""
    from seg2eye_tpu_torch.segtrain.trainer import SegTrainer

    args = seg_args(tmp, **SEG_CARD_CPU, no_cuda=device == "cpu",
                    checkname="card-cpu")
    t = SegTrainer(args, loaders=([None] * 2, [None], None, 21))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in t.net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(device))
    if x64:
        t.net.double()
        t.dtype = torch.float64
    data = SegData(2, args.crop_size, seed=6)
    x, y = seg_batch(data, 0, 2, device)
    logits = []
    hook = t.net.register_forward_hook(lambda m, i, o: logits.append(o))
    loss, _ = t.eval_step(x, y)
    hook.remove()
    net = t.net
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    train_loss, _ = t.train_step(x, y, args.lr)
    return ({"logits": logits[0], "loss": loss},
            {"loss": float(train_loss)},
            {n: p.grad for n, p in net.named_parameters()},
            {n: p.detach() - before[n] for n, p in net.named_parameters()},
            {n: t.optimizer.state[p]["momentum_buffer"]
             for n, p in net.named_parameters()},
            {k: v for k, v in net.state_dict().items() if "running" in k})


def seg_card_vs_cpu(tmp):
    for dname, x64 in (("float32", False), ("float64", True)):
        d = rn_distances(seg_run(tmp, SEG_DEVICE, x64),
                         seg_run(tmp, "cpu", x64))
        tol = RN_CARD_CPU_TOL[dname]
        log(f"  card vs CPU, SegTrainer (ResNet-14, crop "
            f"{SEG_CARD_CPU['crop_size']}, batch {SEG_CARD_CPU['batch_size']}"
            f"), {dname}: " + ", ".join(f"{k} {v:.2e} ({tol[k]:.3g})"
                                       for k, v in d.items()))
        bad = {k: v for k, v in d.items() if not v <= tol[k]}
        if bad:
            raise AssertionError(f"segtrain card and CPU disagree in {dname}: "
                                 f"{bad}")


def phase_segtrain():
    """9: the generic DeepLabV3+ trainer (``seg2eye_tpu_torch.segtrain``) at
    the CLI's pascal defaults, seeded weights, seeded normalised batches
    in memory, in a temporary working directory."""
    import os
    import tempfile

    from seg2eye_tpu_torch.ops import spade_style as K

    K.spade_style.launches = 0
    t_phase = time.perf_counter()
    flags = tf32_flags()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            crop = seg_args(tmp).crop_size
            train = SegData(SEG_TRAIN_IMAGES, crop, seed=0)
            val = SegData(SEG_VAL_IMAGES, crop, seed=1)
            flops = None
            for dname in ("float32", "bfloat16"):
                t0 = time.perf_counter()
                argv = () if dname == "float32" else ("--precision", dname)
                t = seg_trainer(seg_args(tmp, *argv, checkname=dname),
                                train, val)
                if flops is None:
                    flops = seg_flops(t)
                    a, count = t.args, sum(p.numel()
                                           for p in t.net.parameters())
                    layers = getattr(a, "resnet_layers", (3, 4, 23, 3))
                    log(f"segtrain: DeepLab ({a.backbone} {layers}, os"
                        f"{a.out_stride}, {t.nclass} classes, crop {crop}, "
                        f"batch {a.batch_size}, {a.epochs} epochs): "
                        f"{count:,} parameters, seeded init "
                        f"{time.perf_counter() - t0:.1f} s; "
                        f"{flops[0] / 1e9:.1f} GFLOP per image forward, "
                        f"{flops[1] / 1e9:.1f} per image training step")
                    if not SEG_OVERRIDES and count != SEG_PARAMS:
                        raise AssertionError(f"segtrain: {count} parameters, "
                                             f"expected {SEG_PARAMS}")
                seg_train(t, dname, flops[1])
                seg_validate(t, dname, flops[0])
                if dname == "bfloat16":
                    seg_options(tmp, t, train, val)
                del t
                torch.cuda.empty_cache()
            seg_card_vs_cpu(tmp)
        finally:
            os.chdir(cwd)
    if K.spade_style.launches:
        raise AssertionError(f"phase 9 launched the SPADE+Style kernel "
                             f"{K.spade_style.launches} times")
    if tf32_flags() != flags:
        raise AssertionError(f"phase 9 left the TF32 flags at {tf32_flags()}")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "seg2eye_tpu"))
    if foreign:
        raise AssertionError(f"phase 9 imported {foreign[:5]}")
    log(f"segtrain: phase 9 in {time.perf_counter() - t_phase:.1f} s, no "
        "SPADE+Style launch")


# --------------------------------------------------------------- phase 10
# The JAX package's checkpoint files written by the port and read back on
# the card: the default Seg2Eye model at bs16 (both dtypes), RefineNet
# (ResNet-101 os16, 640x400, bs8) and segtrain (pascal defaults, crop
# 513, bs4).  A loaded state must equal the live one bit for bit, and so
# must the next training iteration from it: both states take that
# iteration under deterministic algorithms (``deterministic``), since the
# card's f32 backward otherwise sums in another order from run to run
# (atomics in cuDNN and in index_select's backward).
INTEROP_TRAIN_ITERS = 2
# a CPU rehearsal shrinks the Seg2Eye model here (ngf, crop_size, ...)
INTEROP_OVERRIDES = {}


def tensors_equal(where, a, b):
    """Two {name: tensor} maps bit for bit; BN ``num_batches_tracked``,
    which the JAX format has no place for, skipped."""
    bad = [k for k, v in a.items() if not k.endswith("num_batches_tracked")
           and not (v.dtype == b[k].dtype and torch.equal(v, b[k]))]
    if bad or set(a) != set(b):
        raise AssertionError(f"{where}: not bit for bit: {bad[:5]}")
    return len(a)


def optimizer_tensors(optimizer, net_params):
    """{param name/state key: tensor} of an optimizer's state."""
    return {f"{n}/{k}": v for n, p in net_params
            for k, v in optimizer.state.get(p, {}).items()}


def seg2eye_named_params(model):
    return [(f"{name}.{n}", p) for name, net in nets_of(model).items()
            for n, p in net.named_parameters()]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (index_add's sorted sums, cuDNN's
    deterministic convolutions), restored after.  In that mode PyTorch
    refuses cuBLAS calls unless CUBLAS_WORKSPACE_CONFIG fixes cuBLAS's
    workspace; PyTorch read the variable for its workspace size at its
    first cuBLAS call, long before, and on Hopper already uses the size
    named here (8 x 4096 KiB), so setting it changes no cuBLAS call."""
    import os

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        torch.backends.cudnn.benchmark = saved[2]
        if saved[3] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[3]


def interop_seg2eye(tmp, nets_cpu, opt, dname):
    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.utils import checkpoint

    dopt = opt.replace(compute_dtype=dname, checkpoints_dir=tmp,
                       name=f"interop-{dname}")
    live = train_state(dopt, nets_cpu)
    batches = [make_train_batch(dopt, TRAIN_BATCH, seed=40 + i)
               for i in range(INTEROP_TRAIN_ITERS + 1)]
    for batch in batches[:-1]:
        steps.train_step(live, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes = checkpoint.save_state_jax(live, dopt, "latest")
    write_s = time.perf_counter() - t0
    loaded = train_state(dopt, nets_cpu)
    t0 = time.perf_counter()
    checkpoint.load_state(loaded, dopt, "latest")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = 0
    for name, net in nets_of(live.model).items():
        n += tensors_equal(f"{dname} net{name}", net.state_dict(),
                           nets_of(loaded.model)[name].state_dict())
    for which in ("opt_g", "opt_d"):
        n += tensors_equal(
            f"{dname} {which}",
            optimizer_tensors(getattr(live, which),
                              seg2eye_named_params(live.model)),
            optimizer_tensors(getattr(loaded, which),
                              seg2eye_named_params(loaded.model)))
    if not loaded.step == live.step == INTEROP_TRAIN_ITERS:
        raise AssertionError(f"{dname}: step {loaded.step}")

    score = make_batch(dopt, BATCH, seed=50)
    want, want_fake = Tester(dopt).score_batch(live.model, score)
    K.spade_style.launches = 0
    got, got_fake = Tester(dopt).score_batch(loaded.model, score)
    score_launches = K.spade_style.launches
    if not (np.array_equal(got, want) and np.array_equal(got_fake, want_fake)
            and score_launches == len(SITES)):
        raise AssertionError(f"{dname}: the loaded model's scores equal: "
                             f"{np.array_equal(got, want)}, fakes equal: "
                             f"{np.array_equal(got_fake, want_fake)}, "
                             f"{score_launches} K1 launches")

    with deterministic():
        lw, _ = steps.train_step(live, batches[-1])
        K.spade_style.launches = 0
        lg, _ = steps.train_step(loaded, batches[-1])
        torch.cuda.synchronize()
    step_launches = K.spade_style.launches
    losses = [k for k in lw if not torch.equal(lg[k], lw[k])]
    if step_launches != TRAIN_LAUNCHES or losses:
        raise AssertionError(f"{dname}: the resumed iteration's losses "
                             f"{losses} differ from the live run's; "
                             f"{step_launches} K1 launches")
    m = 0
    for name, net in nets_of(live.model).items():
        m += tensors_equal(f"{dname} resumed net{name}", net.state_dict(),
                           nets_of(loaded.model)[name].state_dict())
    for which in ("opt_g", "opt_d"):
        m += tensors_equal(
            f"{dname} resumed {which}",
            optimizer_tensors(getattr(live, which),
                              seg2eye_named_params(live.model)),
            optimizer_tensors(getattr(loaded, which),
                              seg2eye_named_params(loaded.model)))
    del live, loaded
    torch.cuda.empty_cache()
    total = sum(sizes.values())
    log(f"  Seg2Eye {dname} bs{TRAIN_BATCH}: after {INTEROP_TRAIN_ITERS} "
        f"iterations save_state_jax wrote {', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())} "
        f"({total / 1e6:.1f} MB) in {write_s:.2f} s; load_state read them "
        f"into a fresh state in {load_s:.2f} s: {n} tensors bit for bit "
        f"(weights, buffers, both Adam states); the scored bs{BATCH} batch "
        f"bitwise equal ({score_launches} K1 launches); the next iteration "
        f"under deterministic algorithms ({step_launches} K1 launches) "
        f"bitwise equal to the live run's: losses and {m} tensors")
    return {"score": score_launches, "train": step_launches}


def interop_refinenet(tmp):
    import os

    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager

    cfg = rn_config("RefineNet")
    trainer = rn_trainer("RefineNet", rn_model("RefineNet", cfg, RN_DEVICE))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for i in range(INTEROP_TRAIN_ITERS):
        trainer.train_step(state, rn_batch("RefineNet", cfg, cfg.batch_size,
                                           seed=60 + i), 1e-4)
    torch.cuda.synchronize()
    manager = CheckpointManager(tmp)
    t0 = time.perf_counter()
    path = manager.save_at_step(INTEROP_TRAIN_ITERS, state, fmt="flax")
    write_s = time.perf_counter() - t0
    fresh_trainer = rn_trainer("RefineNet",
                               rn_model("RefineNet", cfg, RN_DEVICE))
    fresh = fresh_trainer.init_state(torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    step, fresh = CheckpointManager(tmp).load_last_checkpoint(fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    net, other = state.model.net, fresh.model.net
    n = tensors_equal("RefineNet", net.state_dict(), other.state_dict())
    n += tensors_equal(
        "RefineNet momentum",
        optimizer_tensors(state.optimizer, net.named_parameters()),
        optimizer_tensors(fresh.optimizer, other.named_parameters()))
    batch = rn_batch("RefineNet", cfg, cfg.batch_size, seed=70)
    K.spade_style.launches = 0
    a = trainer.eval_step(state, batch)
    b = fresh_trainer.eval_step(fresh, batch)
    same = all(torch.equal(a[k], b[k]) for k in a)
    if step != INTEROP_TRAIN_ITERS or fresh.step != step or not same \
            or K.spade_style.launches:
        raise AssertionError(f"RefineNet: step {step}/{fresh.step}, eval "
                             f"outputs equal {same}, "
                             f"{K.spade_style.launches} K1 launches")
    size = os.path.getsize(path)
    log(f"  RefineNet (resnet-{cfg.resnet_depth}, os{cfg.output_stride}, "
        f"{cfg.input_height}x{cfg.input_width}) after {INTEROP_TRAIN_ITERS} "
        f"steps at bs{cfg.batch_size}: {os.path.basename(path)} "
        f"{size / 1e6:.1f} MB written in {write_s:.2f} s, read in "
        f"{load_s:.2f} s; {n} tensors bit for bit (weights, running "
        "statistics, momentum), eval outputs bitwise equal, 0 K1 launches")


def interop_segtrain(tmp):
    import os

    from seg2eye_tpu_torch.ops import spade_style as K

    crop = seg_args(tmp).crop_size
    train = SegData(SEG_TRAIN_IMAGES, crop, seed=0)
    val = SegData(SEG_VAL_IMAGES, crop, seed=1)
    t = seg_trainer(seg_args(tmp, checkname="interop"), train, val)
    x, y = seg_batch(train, 0, t.args.batch_size, t.device)
    last = len(t.train_loader) - 1
    for i in (last - 1, last):
        t.train_step(x, y, t.scheduler(i, 0))
    t.best_pred = 0.4375
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = t.saver.save_checkpoint(t.checkpoint_state(0, "flax"), False,
                                   fmt="flax")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = seg_trainer(seg_args(tmp, resume=path, checkname="interop-resumed"),
                    train, val)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = tensors_equal("segtrain", t.net.state_dict(), r.net.state_dict())
    n += tensors_equal(
        "segtrain momentum",
        optimizer_tensors(t.optimizer, t.net.named_parameters()),
        optimizer_tensors(r.optimizer, r.net.named_parameters()))
    vx, _ = seg_batch(val, 0, t.args.batch_size, t.device)
    K.spade_style.launches = 0
    with torch.no_grad():
        same = torch.equal(t.net(t._input(vx), False),
                           r.net(r._input(vx), False))
    if not (same and r.args.start_epoch == 1 and r.best_pred == t.best_pred) \
            or K.spade_style.launches:
        raise AssertionError(f"segtrain: logits equal {same}, epoch "
                             f"{r.args.start_epoch}, best_pred {r.best_pred}")
    layers = getattr(t.args, "resnet_layers", (3, 4, 23, 3))
    log(f"  segtrain ({t.args.backbone} {tuple(layers)}, os"
        f"{t.args.out_stride}, crop {crop}, "
        f"bs{t.args.batch_size}): checkpoint.ckpt "
        f"{os.path.getsize(path) / 1e6:.1f} MB written in {write_s:.2f} s; "
        f"--resume read it in {load_s:.2f} s (trainer set-up included): "
        f"{n} tensors bit for bit, epoch 1, best_pred {r.best_pred}, eval "
        "logits bitwise equal, 0 K1 launches")


def phase_interop():
    """10: the JAX package's checkpoint files (flax msgpack) written by the
    port and read back on the card, in a temporary directory."""
    import os
    import tempfile

    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        opt = Options(batchSize=TRAIN_BATCH, **INTEROP_OVERRIDES).finalize()
        nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
        for dname in ("float32", "bfloat16"):
            launches[dname] = interop_seg2eye(tmp, nets_cpu, opt, dname)
        del nets_cpu
        interop_refinenet(tmp)
        torch.cuda.empty_cache()
        os.chdir(tmp)
        try:
            interop_segtrain(tmp)
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "seg2eye_tpu", "msgpack",
                      "optax"))
    if foreign:
        raise AssertionError(f"phase 10 imported {foreign[:5]}")
    log(f"interop: phase 10 in {time.perf_counter() - t_phase:.1f} s "
        f"({card_line()})")
    return launches


# --------------------------------------------------------------- phase 11
# one OpenEDS 2019 user (Garbin et al., arXiv:1905.03702): 12,759 labelled,
# 252,690 generative and 91,200 sequence images over 152 subjects
RANK_TARGETS = 84
RANK_CANDIDATES = (1662, 600)
RANK_HW = (640, 400)
RANK_REPEATS = {"card": 5, "cpu": 3}
ASSEMBLY_REPEATS = 20
DATA_DEVICE = "cuda"


def eye_masks(n, seed, device, h=RANK_HW[0], w=RANK_HW[1], chunk=128):
    """(n, h, w) uint8 class ids: nested ellipses (sclera 1, iris 2,
    pupil 3) on background 0, centre, radius and squash jittered from the
    seed, drawn on ``device``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 4), generator=g, dtype=torch.float64)
    cy = (h * (0.35 + 0.3 * u[:, 0])).to(device, torch.float32)
    cx = (w * (0.35 + 0.3 * u[:, 1])).to(device, torch.float32)
    r = (min(h, w) * (0.25 + 0.2 * u[:, 2])).to(device, torch.float32)
    squash = (1.0 + 0.6 * u[:, 3]).to(device, torch.float32)
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        s = slice(i, i + chunk)
        d = torch.hypot((yy - cy[s, None, None]) / squash[s, None, None],
                        xx - cx[s, None, None])
        rr = r[s, None, None]
        out[s] = ((d < rr).to(torch.uint8) + (d < 0.55 * rr).to(torch.uint8)
                  + (d < 0.25 * rr).to(torch.uint8))
    return out


def rank_user(targets, candidates):
    """The ranking of one user, as ``style_ranking.main`` computes it:
    -> (distances (T, N) float32, orders (T, N) int64)."""
    from seg2eye_tpu_torch.data import style_ranking as sr

    d = sr.mask_distances(targets, candidates)
    return d, sr.rank(d)


def data_ranking():
    from seg2eye_tpu_torch.data import style_ranking as sr

    n_cand = sum(RANK_CANDIDATES)
    targets = eye_masks(RANK_TARGETS, 11, DATA_DEVICE)
    candidates = eye_masks(n_cand, 12, DATA_DEVICE)
    # the pair above 2**24: an all-background target against a candidate
    # of pupil (80%) and iris
    g = torch.Generator().manual_seed(13)
    targets[-1] = 0
    candidates[-1] = torch.where(torch.rand(RANK_HW, generator=g) < 0.8,
                                 3, 2).to(DATA_DEVICE, torch.uint8)
    t_cpu, c_cpu = targets.cpu(), candidates.cpu()
    mb = c_cpu.numel() / 2 ** 20
    inputs = {"card": (targets, candidates), "cpu": (t_cpu, c_cpu)}
    times, results = {}, {}
    for where, reps in RANK_REPEATS.items():
        times[where] = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[where] = rank_user(*inputs[where])
            torch.cuda.synchronize()
            times[where].append((time.perf_counter() - t0) * 1e3)
    host = results["cpu"]
    d_card, o_card = (x.cpu() for x in results["card"])
    if not (torch.equal(d_card, host[0]) and torch.equal(o_card, host[1])):
        bad = (d_card != host[0]).sum().item()
        raise AssertionError(f"ranking: card and CPU differ ({bad} distances "
                             "not bit for bit, or the orders)")
    diff = (sr.mask_codes(c_cpu[-1:]).long()
            - sr.mask_codes(t_cpu[-1:]).long())
    exact = int((diff * diff).sum())
    want = torch.tensor(exact, dtype=torch.float32) / 4096
    if not exact > 2 ** 24 or d_card[-1, -1] != want:
        raise AssertionError(f"ranking: pair above 2**24: sum {exact}, "
                             f"distance {d_card[-1, -1].item()} != "
                             f"{want.item()}")
    below = (d_card * 4096 < 2 ** 24).float().mean().item()
    ms_card = statistics.median(times["card"])
    ms_cpu = statistics.median(times["cpu"])
    log(f"data: ranking one user ({RANK_TARGETS} targets x {n_cand} "
        f"candidates at {RANK_HW[0]}x{RANK_HW[1]}, {mb:.0f} MiB of candidate "
        f"masks): card {ms_card:.2f} ms/user (masks on the card; runs "
        f"{[round(t, 2) for t in times['card']]}), CPU {ms_cpu:.2f} ms/user "
        f"({torch.get_num_threads()} threads; runs "
        f"{[round(t, 1) for t in times['cpu']]}), medians; distances and "
        f"orders bit for bit over all "
        f"{RANK_TARGETS} targets ({below:.4f} of the sums below 2**24); the "
        f"pair above 2**24 (sum {exact}) = float32(sum) / 4096")
    return {"card_ms": ms_card, "cpu_ms": ms_cpu}


def data_assembly():
    from seg2eye_tpu_torch import native
    from seg2eye_tpu_torch.options import Options

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    opt = Options().finalize()
    bs, ns = TRAIN_BATCH, opt.input_ns
    h, w = opt.image_height, opt.image_width
    rng = np.random.default_rng(14)
    refs = [rng.integers(0, 256, (h, w), dtype=np.uint8)
            for _ in range(bs * ns)]
    masks = [rng.integers(0, 4, (h, w), dtype=np.uint8) for _ in range(bs)]
    sample_flips = rng.random(bs) > 0.5
    flips = np.repeat(sample_flips, ns)
    pairs = {"images": (native.assemble_images, native.assemble_images_plain,
                        refs, flips),
             "masks": (native.assemble_masks, native.assemble_masks_plain,
                       masks, sample_flips)}
    out = {}
    for what, (fn, plain, arrays, fl) in pairs.items():
        got, want = fn(arrays, fl), plain(arrays, fl)
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            raise AssertionError(f"native assemble_{what} differs from numpy")
        ms = [[], []]
        for _ in range(ASSEMBLY_REPEATS):
            for f, acc in zip((fn, plain), ms):
                t0 = time.perf_counter()
                f(arrays, fl)
                acc.append((time.perf_counter() - t0) * 1e3)
        out[what] = [statistics.median(m) for m in ms]
    log(f"data: native assembly built in {build_s:.2f} s; bs{bs} x "
        f"input_ns {ns} references at {h}x{w} (float32 in [-1, 1], "
        f"{int(sample_flips.sum())} of {bs} samples flipped): native "
        f"{out['images'][0]:.3f} ms, numpy {out['images'][1]:.3f} ms; "
        f"{bs} masks: native {out['masks'][0]:.3f} ms, numpy "
        f"{out['masks'][1]:.3f} ms (medians of {ASSEMBLY_REPEATS}, host "
        "clock); bit for bit equal")
    return out


def phase_data():
    """11: the style ranking at one OpenEDS user's size, card against CPU,
    and the native batch assembly against numpy."""
    t_phase = time.perf_counter()
    ranking = data_ranking()
    torch.cuda.empty_cache()
    assembly = data_assembly()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "seg2eye_tpu", "msgpack",
                      "optax"))
    if foreign:
        raise AssertionError(f"phase 11 imported {foreign[:5]}")
    log(f"data: phase 11 in {time.perf_counter() - t_phase:.1f} s "
        f"({card_line()})")
    return ranking, assembly


# --------------------------------------------------------------- phase 12
# Data parallelism (``parallel.data_parallel``), each rank a child process
# of this script (DP_CHILD_TIMEOUT each), rendezvous through a FileStore.
# The card machine has one GPU and NCCL refuses two ranks on one card, so:
# (a) world 1 on NCCL, the DP code path with real collectives, against the
# one-process route in the same process (``parallel.data_parallel.local``),
# and both timed; (b) world 2 on gloo with CUDA tensors on the one card,
# each rank holding half of the global batch, against the one-process run
# of the whole batch on rank 0.  Every iteration (segtrain: step) starts
# both routes from identical copies of the DP route's state, as phase 5's
# routes: losses and gradients to F32_ROUTE, then the updated state to
# compare_state's limits.  The gloo run's times are those of a correctness
# run, not a speed figure.
DP_DEVICE = "cuda"
DP_ITERS, DP_TIMED_ITERS = 2, 3
DP_CHILD_TIMEOUT = 180
# segtrain at the CLI's pascal defaults but global batch 4 over the ranks,
# so that unsynchronised BN (statistics of 2 images against 4) would show,
# in float64: in float32 ResNet-101's BNs (the ASPP pool's, over 4 values,
# above all) carried the two routes' summation orders to 5e-2 of conv1's
# gradient and 1.2e-4 of a running statistic (on an H100), where in
# float64 round-off stays far below F32_ROUTE and a real difference (local
# statistics, a misscaled gradient) does not
DP_SEG_BATCH, DP_SEG_STEPS = 4, 2
# a CPU rehearsal shrinks the Seg2Eye model here (Options fields)
DP_OVERRIDES = {}


def dp_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam_reach(lr, beta2, t):
    """The farthest Adam at beta1 = 0 moves an element in its t-th step: lr
    sqrt((1 - beta2^t) / (1 - beta2)), when that step's gradient alone
    makes the second moment (an element whose earlier gradients were
    round-off)."""
    return lr * math.sqrt((1 - beta2 ** t) / (1 - beta2))


def dp_iterations(where, opt, nets_cpu, batches, device, failures):
    """DP_ITERS Seg2Eye iterations on this rank's rows of each global batch.
    Rank 0 takes each step (G, then D) also in one process on the whole
    batch from a copy of the state before it, as phase 5's card-vs-CPU
    iteration does: across a whole iteration the two would not stay
    comparable, since the G update steps the elements whose gradient is
    round-off either way (about lr each, by Adam's sign) and the D step's
    regenerated fake and the running updates see that.  -> K1 launches of
    each DP iteration."""
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.parallel import data_parallel as dp
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.train.state import ttur_betas, ttur_lrs

    rank, world = dp.rank(), dp.world_size()
    state = train_state(opt, nets_cpu, device)
    dp.check_replicated(dp.module_tensors(nets_of(state.model)),
                        "the seeded state:")
    lrs, beta2 = ttur_lrs(opt, opt.lr), ttur_betas(opt)[1]
    launches = []
    for it, batch in enumerate(batches):
        local = dp.local_rows(batch, rank, world)
        dp_launches = 0
        for half, step, nets, lr in (("G step", steps.g_step, ("G", "E"),
                                      lrs[0]),
                                     ("D step", steps.d_step, ("D",),
                                      lrs[1])):
            ref = clone_state(state) if rank == 0 else None
            before = K.spade_style.launches
            out = step(state, local)
            dp_launches += K.spade_style.launches - before
            losses = out[0] if half == "G step" else out
            losses = {k: float(v)
                      for k, v in dp.mean_over_ranks(losses).items()}
            if rank:
                continue
            with dp.local():
                out = step(ref, batch)
            ref_losses = out[0] if half == "G step" else out
            at = f"{where}, iteration {it + 1} {half}"
            failures += compare_losses(at, losses, {
                k: float(torch.mean(v.float()))
                for k, v in ref_losses.items()}, None)
            failures += compare_grads(at, grads_of(state.model),
                                      grads_of(ref.model), None,
                                      "DP - one process", nets)
            failures += compare_state(at, state, ref,
                                      adam_reach(lr, beta2, it + 1))
            del ref
        launches.append(dp_launches)
    return launches


def dp_timed(opt, nets_cpu, batch, device):
    """ms/iteration of the DP route and the one-process route, in turns,
    medians of DP_TIMED_ITERS after one of each; -> (dp ms, one-process
    ms, K1 launches of the DP iteration)."""
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.parallel import data_parallel as dp
    from seg2eye_tpu_torch.train import steps

    state = train_state(opt, nets_cpu, device)
    times = {True: [], False: []}
    launches = 0
    for i in range(DP_TIMED_ITERS + 1):
        for synced in (True, False):
            K.spade_style.launches = 0
            dp_sync(device)
            t0 = time.perf_counter()
            with contextlib.nullcontext() if synced else dp.local():
                steps.train_step(state, batch)
            dp_sync(device)
            if i:
                times[synced].append((time.perf_counter() - t0) * 1e3)
            if synced:
                launches = K.spade_style.launches
    return (statistics.median(times[True]), statistics.median(times[False]),
            launches)


def dp_segtrain(tmp, device, overrides, failures):
    """DP_SEG_STEPS float64 segtrain steps (dropout on) on this rank's rows
    of each global batch, each also taken by rank 0 on the whole batch from
    a copy of the net and optimizer: loss and gradients to F32_ROUTE,
    running statistics to CARD_CPU_RUN_RTOL; -> (K1 launches, median host
    ms of the DP steps)."""
    import copy

    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.parallel import data_parallel as dp
    from seg2eye_tpu_torch.refinenet.training import dropout_generator
    from seg2eye_tpu_torch.segtrain.trainer import SegTrainer, make_optimizer

    rank, world = dp.rank(), dp.world_size()
    args = seg_args(tmp, "--batch-size", str(DP_SEG_BATCH), **overrides)
    args.no_cuda = device.type == "cpu"
    data = SegData(DP_SEG_BATCH * DP_SEG_STEPS, args.crop_size, seed=7)
    t = SegTrainer(args, loaders=([None] * DP_SEG_STEPS, [None], None, 21))
    t.net.double()
    t.dtype = torch.float64
    K.spade_style.launches = 0
    times = []
    for step in range(DP_SEG_STEPS):
        image, label = seg_batch(data, step * DP_SEG_BATCH, DP_SEG_BATCH,
                                 device)
        lr = t.scheduler(step, 0)
        ref = None
        if rank == 0:
            ref = copy.copy(t)
            ref.net = copy.deepcopy(t.net)
            ref.optimizer = make_optimizer(ref.net, args)
            ref.optimizer.load_state_dict(t.optimizer.state_dict())
        b = DP_SEG_BATCH // world
        dp_sync(device)
        t0 = time.perf_counter()
        loss, _ = t.train_step(image[rank * b:(rank + 1) * b],
                               label[rank * b:(rank + 1) * b], lr,
                               dropout_generator(args, step, device))
        dp_sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        if ref is None:
            continue
        with dp.local():
            ref_loss, _ = ref.train_step(image, label, lr,
                                         dropout_generator(args, step,
                                                           device))
        at = f"segtrain DP vs one process, step {step + 1}"
        failures += compare_losses(at, {"loss": float(loss)},
                                   {"loss": float(ref_loss)}, None)
        grads = {f"N.{n}": p.grad for n, p in t.net.named_parameters()}
        failures += compare_grads(at, grads, {
            f"N.{n}": p.grad for n, p in ref.net.named_parameters()}, None,
            "DP - one process", ("N",))
        worst = max(float((v - ref.net.state_dict()[k]).norm()
                          / v.norm().clamp(min=1e-30))
                    for k, v in t.net.state_dict().items()
                    if "running" in k)
        log(f"    running statistics, worst ||DP - one process|| / ||stat|| "
            f"{worst:.3e} (tolerance {CARD_CPU_RUN_RTOL})")
        if worst > CARD_CPU_RUN_RTOL:
            failures.append(f"{at}: running statistics differ")
        del ref
    return K.spade_style.launches, statistics.median(times)


def dp_child(form, rank, world, tmp, config):
    """One rank of phase 12 (run by phase_parallel in a process of its
    own): (a) form 'nccl' at world 1, (b) 'gloo' at world 2.  Writes
    ``{tmp}/{form}{rank}.json``; any failure raises."""
    import os

    import torch.distributed as dist

    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.weights import init_networks

    device = torch.device(config["device"])
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    backend = "nccl" if form == "nccl" and device.type == "cuda" else "gloo"
    store = dist.FileStore(os.path.join(tmp, f"{form}.store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        opt = Options(batchSize=config["batch"], compute_dtype="float32",
                      **config["seg2eye"]).finalize()
        nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
        batches = [make_train_batch(opt, opt.batchSize, seed=30 + i)
                   for i in range(DP_ITERS)]
        failures = []
        out = {"launches": dp_iterations(
            f"{backend} world {world} DP vs one process, float32", opt,
            nets_cpu, batches, device, failures)}
        if form == "nccl":
            for dname in ("float32", "bfloat16"):
                out[dname] = dp_timed(opt.replace(compute_dtype=dname),
                                      nets_cpu, batches[0], device)
        else:
            os.chdir(tmp)
            out["segtrain"] = dp_segtrain(tmp, device, config["segtrain"],
                                          failures)
        want = config["launches"]
        bad = [n for n in out["launches"] if n != want]
        if form == "nccl":
            bad += [v[2] for v in (out["float32"], out["bfloat16"])
                    if v[2] != want]
        else:
            bad += [out["segtrain"][0]] if out["segtrain"][0] else []
        if bad:
            failures.append(f"K1 launched {bad} times in a DP iteration "
                            f"(segtrain: in its steps); expected {want} per "
                            "Seg2Eye iteration and 0 on segtrain")
        if failures:
            raise AssertionError(f"rank {rank}: " + "; ".join(failures))
        with open(os.path.join(tmp, f"{form}{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_children(tmp, form, world, child="dp_child", config=None,
                timeout=DP_CHILD_TIMEOUT):
    """Runs the ``world`` ranks of ``form`` (``child`` of this module with
    ``config``, by default phase 12's) after this process has handed its
    cached card memory back (the ranks share the one card: with phase 3's
    16.5 GiB still held, phase 13 (c)'s four ranks ran out of memory);
    any rank that fails or outlives ``timeout`` fails the phase, and every
    child is stopped on the way out.  -> the ranks' results."""
    import os

    if config is None:
        config = {"device": DP_DEVICE, "batch": TRAIN_BATCH,
                  "seg2eye": DP_OVERRIDES, "segtrain": SEG_OVERRIDES,
                  "launches": TRAIN_LAUNCHES}
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    code = ("import json, sys; import chip_smoke as cs; "
            f"cs.{child}(*json.loads(sys.argv[1]))")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code,
         json.dumps([form, r, world, tmp, config])], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        failed = []
        for r, p in enumerate(procs):       # every rank's output, then fail
            try:
                output, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode:
                    failed.append(f"{form} rank {r} of {world} exited with "
                                  f"{p.returncode}")
            except subprocess.TimeoutExpired:
                p.kill()
                output, _ = p.communicate()
                failed.append(f"{form} rank {r} of {world} outlived "
                              f"{timeout} s")
            for line in output.splitlines():
                log(f"  [{form} rank {r}] {line}")
        if failed:
            raise AssertionError("; ".join(failed))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"{form}{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_parallel():
    """(a) world 1 on NCCL, then (b) world 2 on gloo; -> K1 launches per
    DP iteration, {"nccl": per dtype, "gloo": float32's}."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        log(f"parallel (a): Seg2Eye at bs{TRAIN_BATCH}, world 1 on NCCL "
            f"(the DP path with real collectives) against the one-process "
            f"route, {DP_ITERS} float32 iterations; then both routes timed")
        (a,) = dp_children(tmp, "nccl", 1)
        for dname in ("float32", "bfloat16"):
            dp_ms, one_ms, _ = a[dname]
            log(f"  {dname} bs{TRAIN_BATCH}: DP at world 1 {dp_ms:.2f} "
                f"ms/iteration, one process {one_ms:.2f}, the cost of the "
                f"synchronised statistics and gradient all-reduces "
                f"{dp_ms - one_ms:+.2f} ms (medians of {DP_TIMED_ITERS} in "
                f"turns, host clock, synchronised; {card_line()})")
        log(f"parallel (b): world 2 on gloo, CUDA tensors on the one card: "
            f"Seg2Eye bs{TRAIN_BATCH} ({TRAIN_BATCH // 2} per rank), "
            f"{DP_ITERS} float32 iterations, and segtrain (ResNet-101 os16, "
            f"crop 513) at global bs{DP_SEG_BATCH}, {DP_SEG_STEPS} float64 "
            "steps, each against the one-process run on rank 0")
        b = dp_children(tmp, "gloo", 2)
        log(f"  gloo segtrain steps {b[0]['segtrain'][1]:.1f} ms (median, "
            "rank 0; a correctness run, not a speed figure: the gloo "
            "all-reduces go through the host)")
    log(f"parallel: K1 launches per rank per DP iteration: NCCL "
        f"{a['launches']} (float32), {a['bfloat16'][2]} (bfloat16); gloo "
        f"{[r['launches'] for r in b]}; segtrain "
        f"{[r['segtrain'][0] for r in b]}; phase 12 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"nccl": {"float32": a["launches"][0],
                     "bfloat16": a["bfloat16"][2]},
            "gloo": b[0]["launches"][0]}


# --------------------------------------------------------------- phase 13
MP_DEVICE = "cuda"
MP_BATCH = 4
MP_ITERS = {"float32": 2, "bfloat16": 1}
MP_CP_BATCHES = (1, 2)
MP_CHILD_TIMEOUT = 150
# (c): per-sample encoding on a data 2 x model 2 grid, 4 ranks
MP_GRID = {"data": 2, "model": 2}
# a CPU rehearsal shrinks the model here (Options fields)
MP_OVERRIDES = {}


def mp_grads(model):
    """grads_of with every slice's gradient gathered (every model rank)."""
    from seg2eye_tpu_torch.parallel import tensor_parallel as tp

    return {f"{n}.{k}": p.grad if p.grad is None or not tp.is_sharded(p)
            else tp.gather(p.grad, 0)
            for n, net in nets_of(model).items()
            for k, p in net.named_parameters()}


def batches_tracked(model):
    """Every BN's ``num_batches_tracked``, by '{net}.{name}'."""
    return {f"{n}.{k}": int(t) for n, net in nets_of(model).items()
            for k, t in net.state_dict().items()
            if k.endswith("num_batches_tracked")}


def mp_state_bytes(nets):
    """Bytes of the parameters and their two Adam moments, as this rank
    holds them."""
    return sum(3 * p.numel() * p.element_size() for net in nets.values()
               for p in net.parameters() if p.requires_grad)


def mp_tensor(opt, nets_cpu, batches, device, failures, iters=None,
              label="TP model 2"):
    """``iters`` (MP_ITERS[dtype]) grid iterations from the seeded state,
    each data index taking its rows of every global batch, each step also
    taken by rank 0 in one process on the whole batch from a gathered copy
    of the state before it; ``num_batches_tracked`` equal to its.  ->
    {"launches": per iteration, "packings": (in the G step, in the D
    step's regeneration) per iteration, "after": packings in a forward
    without an update, "ms": host ms per grid iteration}."""
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.parallel import data_parallel as dp
    from seg2eye_tpu_torch.parallel import tensor_parallel as tp
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.train.state import ttur_betas, ttur_lrs
    from seg2eye_tpu_torch.utils import checkpoint

    rank, dname = torch.distributed.get_rank(), opt.compute_dtype
    state = train_state(opt, nets_cpu, device)
    tp.shard_(nets_of(state.model), (state.opt_g, state.opt_d),
              opt.tp_min_channels)
    dp.check_replicated(dp.module_tensors(nets_of(state.model)),
                        "the seeded state:")
    lrs, beta2 = ttur_lrs(opt, opt.lr), ttur_betas(opt)[1]
    out = {"launches": [], "packings": [], "ms": []}
    f32 = opt.replace(compute_dtype="float32")
    for it, batch in enumerate(batches[:iters or MP_ITERS[dname]]):
        local = dp.local_rows(batch, dp.rank(), dp.world_size())
        launches, packings, ms = 0, [], 0.0
        for half, step, nets, lr in (("G step", steps.g_step, ("G", "E"),
                                      lrs[0]),
                                     ("D step", steps.d_step, ("D",),
                                      lrs[1])):
            ref = checkpoint.whole_state(state, device)
            if rank:
                del ref
                ref = None
            before = (K.spade_style.launches, K.packed_weights.packings)
            dp_sync(device)
            t0 = time.perf_counter()
            result = step(state, local)
            dp_sync(device)
            ms += (time.perf_counter() - t0) * 1e3
            launches += K.spade_style.launches - before[0]
            packings.append(K.packed_weights.packings - before[1])
            losses = result[0] if half == "G step" else result
            losses = {k: float(v)
                      for k, v in dp.mean_over_ranks(losses).items()}
            dp.check_replicated(dp.module_tensors(nets_of(state.model)),
                                f"after {half} {it + 1}:")
            grads = mp_grads(state.model)
            after = checkpoint.whole_state(state, device)
            if rank:        # the card's room is rank 0's one-process step's
                del after, grads
                torch.cuda.empty_cache()
                continue
            ref32 = None if dname == "float32" else clone_state(ref, f32)
            with dp.local():
                out_ref = step(ref, batch)
                out32 = None if ref32 is None else step(ref32, batch)
            at = f"{label} {dname}, iteration {it + 1} {half}"

            def host(o):
                o = o[0] if half == "G step" else o
                return {k: float(torch.mean(v.float())) for k, v in o.items()}

            failures += compare_losses(at, losses, host(out_ref),
                                       None if out32 is None else host(out32))
            failures += compare_grads(at, grads, grads_of(ref.model),
                                      None if ref32 is None else
                                      grads_of(ref32.model),
                                      "TP - one process", nets,
                                      net_floor=True)
            if dname == "float32":
                failures += compare_state(at, after, ref,
                                          adam_reach(lr, beta2, it + 1))
            if batches_tracked(after.model) != batches_tracked(ref.model):
                failures.append(f"{at}: num_batches_tracked differs from "
                                "one process's")
            del ref, ref32, after
            torch.cuda.empty_cache()
        out["launches"].append(launches)
        out["packings"].append(packings)
        out["ms"].append(ms)
    before = K.packed_weights.packings
    with dp.local():
        state.model.inference(batches[0])
    out["after"] = K.packed_weights.packings - before
    out["bytes"] = mp_state_bytes(nets_of(state.model))
    return out


def mp_spatial(opt, nets_cpu, device, failures):
    """``Tester.score_batch`` in H bands over the ranks against the
    one-process Tester (rank 0), at MP_CP_BATCHES; -> {bs: (K1 launches
    of the banded forward, host ms)}."""
    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.ops import spade_style as K
    from seg2eye_tpu_torch.parallel import data_parallel as dp
    from seg2eye_tpu_torch.parallel import spatial

    import copy

    rank, dname = torch.distributed.get_rank(), opt.compute_dtype
    model = Pix2Pix(opt, {k: copy.deepcopy(nets_cpu[k]) for k in ("G", "E")},
                    device)
    banded = Tester(opt, bands=spatial.Bands())
    alone = Tester(opt)
    out = {}
    with dp.local():
        for bs in MP_CP_BATCHES:
            batch = make_batch(opt, bs, seed=50 + bs)
            banded.score_batch(model, batch, need_fake=False)    # warm-up
            K.spade_style.launches = 0
            dp_sync(device)
            t0 = time.perf_counter()
            errors, fake = banded.score_batch(model, batch)
            ms = (time.perf_counter() - t0) * 1e3
            out[bs] = (K.spade_style.launches, ms)
            if rank:
                continue
            want_errors, want = alone.score_batch(model, batch)
            fake_tol, err_rtol = SLICE_TOL[dname]
            fdiff = float(np.abs(fake - want).max())
            ediff = float(np.abs(errors / want_errors - 1).max())
            log(f"  CP {dname} bs{bs}, 2 bands of "
                f"{opt.image_height // 2} rows vs one process: fakes max abs "
                f"diff {fdiff:.3e} (tolerance {fake_tol}), errors max rel "
                f"diff {ediff:.3e} (tolerance {err_rtol})")
            if not (fake.shape == want.shape and fdiff <= fake_tol
                    and ediff <= err_rtol):
                failures.append(f"CP {dname} bs{bs}: the banded score "
                                "differs from one process's")
    return out


def mp_per_sample(rank, config, device):
    """(c): one float32 iteration of the default model with per-sample
    encoding (``norm_E = spectralbatch``, 'auto') on a data 2 x model 2
    grid at global bs MP_BATCH, each step against rank 0's one-process
    route (``mp_tensor``); K1 launches twice per norm site per rank.  ->
    ``mp_tensor``'s result; any failure raises."""
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.parallel import mesh
    from seg2eye_tpu_torch.utils.weights import init_networks

    grid = mesh.make_grid(MP_GRID["model"], MP_GRID["data"])
    opt = Options(batchSize=MP_BATCH, compute_dtype="float32",
                  model_axis=grid.model, data_axis=grid.data,
                  norm_E="spectralbatch", **config["seg2eye"]).finalize()
    if not opt.per_sample_encode_enabled:
        raise AssertionError("(c) must run per-sample encoding")
    nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
    failures = []
    out = mp_tensor(opt, nets_cpu, [make_train_batch(opt, MP_BATCH,
                                                     seed=70)],
                    device, failures, iters=1,
                    label=f"TP data {grid.data} x model {grid.model} "
                          "per-sample")
    out["peak_gib"] = (torch.cuda.max_memory_reserved(device) / 2 ** 30
                       if device.type == "cuda" else 0.0)
    want = 2 * config["launches"]
    if out["launches"] != [want]:
        failures.append(f"K1 launched {out['launches']} times in the "
                        f"per-sample grid iteration; expected {want}")
    if failures:
        raise AssertionError(f"rank {rank}: " + "; ".join(failures))
    return out


def mp_child(form, rank, world, tmp, config):
    """One rank of phase 13, in a process of its own, on gloo: form 'mp'
    a data 1 x model 2 grid ((a) and (b)), form 'grid' (c)
    (``mp_per_sample``).  Writes ``{tmp}/{form}{rank}.json``; any failure
    raises."""
    import os

    import torch.distributed as dist

    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.parallel import mesh
    from seg2eye_tpu_torch.utils.weights import init_networks

    device = torch.device(config["device"])
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(tmp, f"{form}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        if form == "grid":
            out = mp_per_sample(rank, config, device)
            with open(os.path.join(tmp, f"{form}{rank}.json"), "w") as f:
                json.dump(out, f)
            return
        mesh.make_grid(world)
        opt = Options(batchSize=MP_BATCH, compute_dtype="float32",
                      model_axis=world, **config["seg2eye"]).finalize()
        nets_cpu = init_networks(opt, torch.Generator().manual_seed(0), "cpu")
        batches = [make_train_batch(opt, MP_BATCH, seed=60 + i)
                   for i in range(max(MP_ITERS.values()))]
        one = mp_state_bytes(nets_cpu)
        failures, out = [], {"tp": {}, "cp": {}}
        for dname in MP_ITERS:
            out["tp"][dname] = mp_tensor(opt.replace(compute_dtype=dname),
                                         nets_cpu, batches, device, failures)
        out["bytes"] = (out["tp"]["float32"]["bytes"], one)
        for dname in MP_ITERS:
            out["cp"][dname] = mp_spatial(
                opt.replace(compute_dtype=dname, isTrain=False), nets_cpu,
                device, failures)
        want = config["launches"]
        bad = [f"TP {d}: {n}" for d, r in out["tp"].items()
               for n in r["launches"] if n != 2 * want]
        bad += [f"CP {d} bs{bs}: {n}" for d, r in out["cp"].items()
                for bs, (n, _) in r.items() if n != want]
        # G's weights change at the G step's update only: the D step's
        # regeneration packs them anew, the next G step's forward not
        bad += [f"TP {d}: {p} packings" for d, r in out["tp"].items()
                for i, p in enumerate(r["packings"])
                if p != [0 if i else want, want]]
        bad += [f"TP {d}: {r['after']} packings without an update"
                for d, r in out["tp"].items() if r["after"]]
        if bad:
            failures.append(f"K1 launches or packings {bad}; expected "
                            f"{2 * want} launches per TP iteration, {want} "
                            f"packings in the first forward and in each "
                            f"forward after a G update only, {want} "
                            "launches per banded forward")
        if failures:
            raise AssertionError(f"rank {rank}: " + "; ".join(failures))
        with open(os.path.join(tmp, f"{form}{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_model_parallel():
    """Tensor and H-band parallelism on two gloo ranks of the one card;
    -> K1 launches per rank, {"tp": per TP iteration, "cp": per banded
    forward}, per dtype."""
    import tempfile

    t0 = time.perf_counter()
    config = {"device": MP_DEVICE, "seg2eye": MP_OVERRIDES,
              "launches": len(SITES) if TRAIN_LAUNCHES else 0}
    with tempfile.TemporaryDirectory() as tmp:
        log(f"model and spatial parallel: 2 ranks on gloo, CUDA tensors on "
            f"the one card; (a) a data 1 x model 2 grid at full width, "
            f"bs{MP_BATCH}, {MP_ITERS['float32']} float32 iterations and "
            f"{MP_ITERS['bfloat16']} bfloat16, each step against the "
            f"one-process route on rank 0; (b) scoring in 2 H bands at bs "
            f"{MP_CP_BATCHES}")
        ranks = dp_children(tmp, "mp", 2, child="mp_child", config=config,
                            timeout=MP_CHILD_TIMEOUT)
        world = MP_GRID["data"] * MP_GRID["model"]
        log(f"model parallel (c): {world} ranks on gloo, CUDA tensors on "
            f"the one card; a data {MP_GRID['data']} x model "
            f"{MP_GRID['model']} grid at full width with norm_E = "
            f"spectralbatch (per-sample encoding through 'auto'), global "
            f"bs{MP_BATCH} ({MP_BATCH // MP_GRID['data']} per data index), "
            "1 float32 iteration, each step against the one-process route "
            "on rank 0")
        grid = dp_children(tmp, "grid", world, child="mp_child",
                           config=config, timeout=MP_CHILD_TIMEOUT)
    a = ranks[0]
    mine, one = a["bytes"]
    for dname, r in a["tp"].items():
        log(f"  TP {dname}: K1 launches per rank per iteration "
            f"{[x['tp'][dname]['launches'] for x in ranks]} (predicted "
            f"{2 * len(SITES)}), packings (G step, D step) "
            f"{r['packings']}, in a forward without an update "
            f"{r['after']}; host ms per iteration {r['ms']} (a correctness "
            f"run through the host; {card_line()})")
    log(f"  TP per-rank parameters + Adam moments {mine / 2 ** 20:.1f} MiB "
        f"against one process's {one / 2 ** 20:.1f} MiB: {mine / one:.4f} "
        f"(predicted 0.51-0.52; {card_line()})")
    for dname, r in a["cp"].items():
        log(f"  CP {dname}: K1 launches per rank per forward "
            f"{[{bs: x['cp'][dname][bs][0] for bs in x['cp'][dname]} for x in ranks]}"
            f" (predicted {len(SITES)}); host ms per scored batch "
            f"{ {bs: round(v[1], 2) for bs, v in r.items()} } (a "
            f"correctness run through the host; {card_line()})")
    log(f"  TP per-sample float32: K1 launches per rank per iteration "
        f"{[x['launches'][0] for x in grid]} (predicted "
        f"{2 * len(SITES)}), packings (G step, D step) "
        f"{grid[0]['packings'][0]}; host ms per iteration "
        f"{grid[0]['ms'][0]:.1f} (a correctness run through the host); "
        f"peak reserved card memory per rank "
        f"{[round(x['peak_gib'], 2) for x in grid]} GiB (rank 0 holds the "
        f"one-process route too; {card_line()})")
    log(f"model and spatial parallel: phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"tp": {d: r["launches"][0] for d, r in a["tp"].items()},
            "cp": {d: r[str(MP_CP_BATCHES[0])][0]
                   for d, r in a["cp"].items()},
            "tp_per_sample": grid[0]["launches"][0]}


def main():
    kind = phase_device()
    phase_build()
    summary = phase_kernel()
    backward = phase_kernel_backward()
    launches = phase_slice()
    train_launches = phase_train()
    options = phase_options()
    phase_refinenet()
    serving_launches = phase_serving()
    phase_segtrain()
    interop_launches = phase_interop()
    phase_data()
    dp_launches = phase_parallel()
    mp_launches = phase_model_parallel()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "seg2eye_tpu", "msgpack",
                      "optax"))
    if foreign:
        raise AssertionError(f"the port's run imported {foreign[:5]}")

    from seg2eye_tpu_torch.ops import spade_style as K
    log(card_line())              # again, beside the results at the end
    log("kernel summary, one entry per kernel: launches in one forward of "
        "the slice in that dtype, train_launches in one training iteration "
        "in that dtype, remat_train_launches in one --remat iteration (crop "
        f"512), serving_launches in one call of that dtype's serving "
        f"artifact (bs{BATCH}), interop_score/train_launches in scoring "
        f"bs{BATCH} from a loaded .ckpt and one resumed iteration; "
        "dp_train_launches per rank in one data-parallel iteration at world "
        "1 on NCCL, dp_gloo_train_launches at world 2 on gloo (float32); "
        "tp_launches per rank in one tensor-parallel iteration (model 2, "
        "bs4), cp_launches per rank in one forward scored in 2 H bands "
        "(bs1), tp_per_sample_launches per rank in one iteration with "
        "per-sample encoding on a data 2 x model 2 grid (float32, bs4); "
        f"max_abs_err over the crop-256 and odd "
        f"site checks; ms, plain_ms, library_ms and bound_ms summed over the "
        f"18 sites at N={SITE_N}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": SUMMARY_NAMES[d], "route": "cuda",
         "source": K.SOURCE[DTYPES[d]],
         "replaces": K.REPLACES, "launches": launches[d],
         "train_launches": train_launches[d],
         "remat_train_launches": options["7b"][d][0],
         "serving_launches": serving_launches[d],
         "interop_score_launches": interop_launches[d]["score"],
         "interop_train_launches": interop_launches[d]["train"],
         "dp_train_launches": dp_launches["nccl"][d],
         "dp_gloo_train_launches": dp_launches["gloo"]
         if d == "float32" else None,
         "tp_launches": mp_launches["tp"][d],
         "cp_launches": mp_launches["cp"][d],
         "tp_per_sample_launches": mp_launches["tp_per_sample"]
         if d == "float32" else None,
         **{k: summary[d][k] for k in keys}}
        for d in ("bfloat16", "float32")] + [
        {"name": "spade_style_bwd_bf16_sm90", "route": "cuda",
         "source": K.SOURCE[torch.bfloat16], "replaces": None,
         "train_launches": BACKWARD_LAUNCHES["bfloat16"],
         **{k: backward[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "backward_ms",
                                     "recompute_ms", "grad_worst")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
