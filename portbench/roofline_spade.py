"""The work of one call of the plain SPADE norm (``seg2eye::spade``,
GauGAN's norm sites), the counterpart of ``roofline.k1_work`` without the
style: the seg MLP (3x3, S -> 128) and the gamma|beta products (3x3, 128 ->
2C); x, seg, mean, var and the float32 weights and biases read once, out
written once.  And the reader of ``spade_roofline.train``."""
from __future__ import annotations

from typing import Optional, Tuple

from portbench import roofline

SPADE_OP = "seg2eye::spade"


def spade_work(x_shape, seg_channels: int, dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call on x (N,H,W,C) in ``dtype``."""
    n, h, w, c = x_shape
    s, item = seg_channels, roofline.ITEMSIZE[dtype]
    pixels = n * h * w
    flops = 2.0 * pixels * 9 * roofline.NHIDDEN * (s + 2 * c)
    nbytes = (pixels * (2 * c + s) * item + 4 * n * 2 * c
              + 4 * (9 * roofline.NHIDDEN * (s + 2 * c) + roofline.NHIDDEN
                     + 2 * c))
    return flops, nbytes


def spade_roofline(run) -> Optional[float]:
    """% of the bound: the least time of every ``seg2eye::spade`` forward
    call in the slice over the device time of all kernels under those
    calls.  The calls come in generator forwards over the configuration's
    norm sites in order (``reference.gaugan.site_shapes`` at the cell's
    batch).  None without a traced slice or without such a call (a
    program without the op)."""
    if run.trace is None:
        return None
    from portbench.reference.gaugan import semantic_nc, site_shapes

    calls = [e for e in run.trace.ops_named(SPADE_OP)
             if not (e.cpu_parent is not None
                     and e.cpu_parent.name == SPADE_OP)]
    device_s = sum(e.device_time_total for e in calls) / 1e6
    if not calls or device_s <= 0:
        return None
    sites = site_shapes(run.cfg, int(run.cell["sizes"]["batch"]))
    if len(calls) % len(sites):
        raise RuntimeError(f"{len(calls)} SPADE calls are not whole forwards "
                           f"of {len(sites)} sites")
    dtype = run.cell["dtype"]
    per_forward = sum(roofline.bound_s(*spade_work(
        shape, semantic_nc(run.cfg), dtype), run.card, dtype)
        for shape in sites)
    return 100.0 * per_forward * len(calls) / len(sites) / device_s
