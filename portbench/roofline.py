"""The benchmark's frozen arithmetic: the card's peaks, the model FLOPs of a
cell counted on the plain reference, and the work of one call of the fused
SPADE+Style norm (K1).

Peaks are NVIDIA's published dense rates of an H100 SXM at its full power
limit of 700 W.  A float32 share is taken against the TF32 tensor-core
rate, 495e12: the fastest any implementation multiplies float32 operands
(3xTF32 runs three such products), so no float32 path can read over 100%;
the FP32 pipes' 67e12 would let a tensor-core path read over it.

Model FLOPs are counted by ``torch.utils.flop_counter`` on the reference,
run on the ``meta`` device at the cell's shapes (no memory, no kernels), a
convolution's backward counted with its groups (``conv_backward_flops``).
They are not counted on the program's route: the port's
``utils/roofline.flops_of`` counts 0 FLOP for the ``seg2eye::spade_style``
op (a custom op that the counter does not know: 0.0 against 10.6 MFLOP for
the plain version of one (2, 8, 8, 16) site), and counts the plain
recompute of its backward as model work.  The reference has neither: its
norm sites are plain, and its backward recomputes nothing.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

NHIDDEN = 128
# dense FLOP/s per compute dtype of a cell, and bytes/s, by card name
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12,
                                        "float32": 495e12}}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def peaks(card: str, dtype: str) -> Tuple[float, float]:
    """(FLOP/s, bytes/s) of ``card`` for a cell computing in ``dtype``;
    raises for a card not in the table, so no share is made up."""
    for name, rates in PEAK_FLOPS.items():
        if name.lower() in card.lower():
            return rates[dtype], PEAK_BYTES[name]
    raise KeyError(f"no published peaks for {card!r}")


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kwargs):
    """Each of a convolution's input and weight gradients costs its
    forward, 2 N C_out H_out W_out (C_in / groups) kh kw; torch's own
    formula leaves out the groups."""
    if transposed:
        raise NotImplementedError("transposed conv")
    fwd = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` (a backward inside it counts)."""
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def k1_work(x_shape, seg_channels: int, dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused SPADE+Style call on x (N,H,W,C): the seg
    MLP (3x3, S -> 128) and the gamma|beta products (3x3, 128 -> 2C); x and
    seg read once in the compute dtype, style (N,2C), mean and var (N,C)
    and the float32 weights and biases read once, out written once."""
    n, h, w, c = x_shape
    s, item = seg_channels, ITEMSIZE[dtype]
    pixels = n * h * w
    flops = 2.0 * pixels * 9 * NHIDDEN * (s + 2 * c)
    nbytes = (pixels * (2 * c + s) * item + 4 * n * 4 * c
              + 4 * (9 * NHIDDEN * (s + 2 * c) + NHIDDEN + 2 * c))
    return flops, nbytes


def bound_s(flops: float, nbytes: float, card: str, dtype: str) -> float:
    """The least seconds the card could take: the larger of the products
    at the peak rate and the bytes at the memory rate."""
    peak, bw = peaks(card, dtype)
    return max(flops / peak, nbytes / bw)


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total
