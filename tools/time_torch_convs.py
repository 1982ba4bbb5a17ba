#!/usr/bin/env python3
"""The convolution classes of the Xception and DRN-D-54 DeepLab backbones,
timed on one CUDA card in both layouts, to set the layout rule of
``models/layers.apply_conv`` (``nchw_copy``); then whole models under each
rule.

    python3 tools/time_torch_convs.py [--parts convs models] [--repeats 10]
        [--out FILE.json]

Each conv runs at its shape on the 640x400 RefineNet/SegNet path (NCHW
shapes of the activation it reads): depthwise 3x3 at stride 1 and 2 and
dilation 1, 2 and 4 (Xception's separable convs), DRN's dilated dense 3x3
convs, and one dilated ASPP branch of each backbone as a reference.  Each
at batch 32 (``eval_step``: forward, no grad) and batch 8
(``train_step``: forward and backward, input and weight gradients), in
bfloat16 and float32 (full float32, TF32 off, as the port runs it), on
channels_last input as the model holds its activations ("cl") and on an
NCHW copy made inside the timed call ("nchw": the ``clone`` of the rule).
Median ms of ``--repeats`` calls per cell, timed in turns with CUDA
events after two warm-ups; each call's output is held against the other
layout's (they differ by summation order only).

``models``: RefineNet at 640x400 (Xception at os16 and os8, MobileNet at
os16: the backbones with dilated depthwise convs), ``eval_step`` at batch
32 and ``train_step`` at batch 8 in both dtypes, under each rule of
RULES, timed in turns (CUDA events, median of ``--repeats``), the
outputs of each rule's eval held against the first's.

Prints one line per cell and, last, one JSON object with every cell.
"""
import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (card_line, rn_batch, rn_config,  # noqa: E402
                        rn_model, rn_trainer, time_turns)
from seg2eye_tpu_torch.utils.precision import full_float32  # noqa: E402

# name, (C_in, C_out, H, W), stride, dilation, groups ("dw": C_in)
CONVS = [
    ("xception entry dw 128 s1", (128, 128, 320, 200), 1, 1, "dw"),
    ("xception entry dw 128 s2", (128, 128, 320, 200), 2, 1, "dw"),
    ("xception block3 dw 728 s2", (728, 728, 80, 50), 2, 1, "dw"),
    ("xception middle dw 728 d1 (os16)", (728, 728, 40, 25), 1, 1, "dw"),
    ("xception middle dw 728 d2 (os8)", (728, 728, 80, 50), 1, 2, "dw"),
    ("xception exit dw 1536 d2 (os16)", (1536, 1536, 40, 25), 1, 2, "dw"),
    ("xception exit dw 1536 d4 (os8)", (1536, 1536, 80, 50), 1, 4, "dw"),
    ("xception aspp 2048->256 d6 (os16)", (2048, 256, 40, 25), 1, 6, 1),
    ("drn layer5 256->256 d2", (256, 256, 80, 50), 1, 2, 1),
    ("drn layer6 512->512 d4", (512, 512, 80, 50), 1, 4, 1),
    ("drn layer7 2048->512 d2", (2048, 512, 80, 50), 1, 2, 1),
    ("drn aspp 512->256 d12", (512, 256, 80, 50), 1, 12, 1),
]
BATCHES = {"serve": 32, "train": 8}
# models/layers.nchw_copy's candidates: the float32 dilated convs alone
# (the earlier rule), and with the dilated depthwise convs in both dtypes
RULES = {
    "float32 dilated": lambda x, conv: (conv.dilation[0] > 1
                                        and x.dtype == torch.float32),
    "float32 dilated + dilated depthwise": lambda x, conv: (
        conv.dilation[0] > 1
        and (x.dtype == torch.float32 or conv.groups > 1)),
}
MODELS = (("xception", 16), ("xception", 8), ("mobilenet", 16))
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_call(x, w, stride, dilation, groups, layout, train):
    def call():
        t = x.clone(memory_format=torch.contiguous_format) \
            if layout == "nchw" else x
        y = F.conv2d(t, w, None, stride, dilation, dilation, groups)
        if train:
            gx, gw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
            return y, gx, gw
        return (y,)
    return call


def time_models(repeats):
    """RefineNet of each MODELS entry under each of RULES, in turns."""
    from seg2eye_tpu_torch.models import layers

    rows = []
    rule_fns = list(RULES.values())
    own_rule = layers.nchw_copy
    for backbone, os_ in MODELS:
        cfg = rn_config("RefineNet", backbone=backbone, output_stride=os_)
        model = rn_model("RefineNet", cfg, "cuda")
        trainer = rn_trainer("RefineNet", model)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        serve = rn_batch("RefineNet", cfg, BATCHES["serve"], seed=1)
        train = rn_batch("RefineNet", cfg, BATCHES["train"], seed=2)
        calls = {"serve": lambda: trainer.eval_step(state, serve),
                 "train": lambda: trainer.train_step(
                     state, train, 1e-6)}
        for mode, call in calls.items():
            for dname, dtype in DTYPES.items():
                model.dtype = dtype

                def under(rule, call=call):
                    def run():
                        layers.nchw_copy = rule
                        return call()
                    return run

                if mode == "serve":
                    outs = [under(r)()["prediction"] for r in rule_fns]
                    diff = max(float((o - outs[0]).abs().max())
                               for o in outs)
                else:
                    diff = float("nan")
                ms = time_turns([under(r) for r in rule_fns], 2, repeats)
                layers.nchw_copy = own_rule
                rows.append(dict(model=f"RefineNet {backbone} os{os_}",
                                 mode=mode, batch=BATCHES[mode],
                                 dtype=dname, ms=dict(zip(RULES, ms)),
                                 prediction_diff=diff))
                print(f"RefineNet {backbone} os{os_} {mode} "
                      f"bs{BATCHES[mode]} {dname}: " + ", ".join(
                          f"{r} {t:.3f} ms" for r, t in zip(RULES, ms))
                      + f"; eval predictions {diff:.1e} apart", flush=True)
        del model, trainer, state
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", nargs="+", default=["convs", "models"],
                    choices=["convs", "models"])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_convs: no CUDA device")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}",
          flush=True)
    result = {"card": card, "torch": torch.__version__}
    if "convs" in args.parts:
        result["rows"] = time_convs(args.repeats)
    if "models" in args.parts:
        result["models"] = time_models(args.repeats)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


def time_convs(repeats):
    """Each CONVS entry on channels_last input and on an NCHW copy."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, (cin, cout, h, w), stride, dilation, groups in CONVS:
        groups = cin if groups == "dw" else groups
        for mode, b in BATCHES.items():
            train = mode == "train"
            for dname, dtype in DTYPES.items():
                x = torch.randn(b, cin, h, w, device="cuda", generator=gen,
                                dtype=dtype).contiguous(
                    memory_format=torch.channels_last)
                wt = torch.randn(cout, cin // groups, 3, 3, device="cuda",
                                 generator=gen, dtype=dtype) * 0.05
                x.requires_grad_(train)
                wt.requires_grad_(train)
                calls = [make_call(x, wt, stride, dilation, groups, layout,
                                   train) for layout in ("cl", "nchw")]
                with full_float32(dtype == torch.float32), \
                        torch.set_grad_enabled(train):
                    outs = [c() for c in calls]
                    diff = max(float((a - b).detach().float().abs().max()
                                     / (b.detach().float().abs().max()
                                        + 1e-30))
                               for a, b in zip(*outs))
                    cl_ms, nchw_ms = time_turns(calls, 2, repeats)
                rows.append(dict(conv=name, mode=mode, batch=b, dtype=dname,
                                 stride=stride, dilation=dilation,
                                 depthwise=groups == cin and cin > 1,
                                 cl_ms=cl_ms, nchw_ms=nchw_ms,
                                 rel_diff=diff))
                print(f"{name:36s} {mode} bs{b} {dname:8s}: channels_last "
                      f"{cl_ms:9.3f} ms, NCHW copy {nchw_ms:9.3f} ms "
                      f"(x{cl_ms / nchw_ms:.2f}); outputs/gradients "
                      f"{diff:.1e} apart", flush=True)
                del x, wt, calls, outs
                torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
