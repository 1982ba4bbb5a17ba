"""Shared benchmark helpers (counterpart of ``seg2eye_tpu/utils/roofline.py``):
the card's peak rates keyed by its name (the MFU and roofline
denominators), FLOP counting, timing and the MFU line.

A peak hardcoded per tool misreports on any other card, so the peaks live
here, keyed by the name ``torch.cuda.get_device_name`` (and ``nvidia-smi``)
gives.  An unknown card, and the CPU, get 0.0: callers print 'n/a', never a
made-up share.  The peaks are NVIDIA's published dense rates at the full
power limit; a card set below it runs slower under load, so print its
power limit beside any share.

FLOPs are counted by ``torch.utils.flop_counter`` (matmuls and
convolutions; elementwise work is not counted), with a convolution's
backward counted with its groups (``conv_backward_flops``).  On the TPU
side XLA's cost analysis counts a SAME-padded conv without its padded taps;
this counter counts the dense product.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Sequence

import torch

# dense peak rates by card name: FLOP/s per type ("tf32": float32 products
# on the tensor cores; "float32": the FP32 pipes outside them), and the
# memory rate in bytes/s
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12,
                              "float32": 67e12},
}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _card_name(device) -> str:
    """The card's name for ``device`` (a name, a CUDA ``torch.device`` or
    index, or None for the current CUDA device); '' for the CPU and where
    no card is."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def _lookup(table: dict, device):
    name = _card_name(device).lower()
    for k, v in table.items():
        if name and k.lower() in name:
            return v
    return None


def _type_key(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return str(dtype).removeprefix("torch.")


def peak_flops(device=None, dtype=torch.bfloat16) -> float:
    """Peak dense FLOP/s of ``device`` (default: the current CUDA device)
    for ``dtype``: a torch dtype, or 'tf32' for float32 products on the
    tensor cores (``torch.float32`` is the FP32 pipes' rate).  0.0 for an
    unknown card, an unknown type and the CPU."""
    rates = _lookup(PEAK_FLOPS, device)
    return 0.0 if rates is None else rates.get(_type_key(dtype), 0.0)


def peak_bytes(device=None) -> float:
    """Peak memory rate of ``device`` in bytes/s; 0.0 where unknown."""
    rate = _lookup(PEAK_BYTES, device)
    return 0.0 if rate is None else rate


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kwargs):
    """A (non-transposed) conv's backward: each of the input and weight
    gradients costs its forward's 2 N C_out H_out W_out (C_in / groups)
    kh kw.  torch.utils.flop_counter's own formula leaves out the groups,
    which counts a depthwise conv's backward as a dense one (66 times its
    forward at 64 channels)."""
    if transposed:
        raise NotImplementedError("transposed conv")
    fwd = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)``, run once under
    ``FlopCounterMode`` (a backward inside ``fn`` counts too, a conv's
    with its groups)."""
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def compute_ms(flops: float, dtype, passes: int = 1, device=None) -> float:
    """The least ms of ``flops`` (each run ``passes`` times, as 3xTF32
    runs float32 products three times) at the card's peak for ``dtype``;
    0.0 where the peak is unknown."""
    peak = peak_flops(device, dtype)
    return passes * flops / peak * 1e3 if peak else 0.0


def memory_ms(nbytes: float, device=None) -> float:
    """The least ms to move ``nbytes`` at the card's memory rate; 0.0
    where it is unknown."""
    peak = peak_bytes(device)
    return nbytes / peak * 1e3 if peak else 0.0


def bound_ms(flops: float, nbytes: float, dtype, passes: int = 1,
             device=None) -> float:
    """The least time, in ms, the card could take for work of ``flops``
    that must move ``nbytes`` (each input read once, each output written
    once): the larger of ``compute_ms`` and ``memory_ms``; 0.0 where the
    card's peaks are unknown."""
    return max(compute_ms(flops, dtype, passes, device),
               memory_ms(nbytes, device))


def timeit(fn: Callable, args: Sequence = (), iters: int = 10) -> float:
    """Seconds per call of ``fn(*args)``: one warm-up call, then ``iters``
    calls chained and one wait at the end.  With a CUDA tensor among the
    arguments the card's time between two CUDA events; otherwise the
    host's ``time.perf_counter``."""
    fn(*args)
    if not any(torch.is_tensor(a) and a.is_cuda for a in args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def report(name: str, t: float, fl: float, peak: float,
           width: int = 28) -> None:
    """One line: ms, TFLOP, TFLOP/s and the share of ``peak`` (FLOP/s;
    'n/a' at 0)."""
    tf = fl / t / 1e12 if t else 0.0
    mfu = f"{tf / (peak / 1e12) * 100:5.1f}%" if peak else "  n/a"
    print(f"{name:>{width}}: {t * 1e3:8.2f} ms  {fl / 1e12:6.2f} TFLOP  "
          f"{tf:6.1f} TF/s  MFU {mfu}")

