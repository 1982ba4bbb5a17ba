"""Readers of the port's DeepLab spans (``models.deeplab.DeepLab.forward``'s
stages and ``models.layers.apply_conv``'s NCHW copies) in a traced slice.

The names are copies of the program's (``seg2eye_tpu_torch/utils/
spans.py``), kept beside ``spans.py``'s so that the benchmark imports
nothing of the port.  A stage's device time is ``spans.span_ms``'s: every
op that starts inside the stage, on any thread; the backward's kernels
start inside ``train.backward``, so a stage reads its forward alone.  A
program without these spans (an older checkout) gives nothing to read:
the readers return None.
"""
from __future__ import annotations

from typing import Optional

DEEPLAB_BACKBONE = "deeplab.backbone"
DEEPLAB_ASPP = "deeplab.aspp"
# no reader of its own: with the other two it marks a slice of a program
# that has these spans, in which ``copies_per_step`` may read 0
DEEPLAB_DECODER = "deeplab.decoder"
NCHW_COPY = "layers.nchw_copy"

STAGES = (DEEPLAB_BACKBONE, DEEPLAB_ASPP, DEEPLAB_DECODER)
NAMES = STAGES + (NCHW_COPY,)


def copies_per_step(run) -> Optional[float]:
    """``NCHW_COPY`` spans per step (the program opens one per copy): 0
    where the slice holds DeepLab's stage spans and no copy, None where it
    holds no stage span."""
    if run.trace is None:
        return None
    names = [o.name for o in run.trace.ops]
    if not any(n in STAGES for n in names):
        return None
    return names.count(NCHW_COPY) / run.trace.steps
