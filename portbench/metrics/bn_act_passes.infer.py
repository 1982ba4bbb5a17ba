"""Fused eval BN, residual add and ReLU passes per batch: the program's
``layers.bn_act`` spans, one per launch of its bn_act kernel (the name is a
copy of ``seg2eye_tpu_torch/utils/spans.py``'s, kept here so that the
benchmark imports nothing of the port).  0 where the slice holds DeepLab's
stage spans and none of these (a program without the kernel), None where
it holds no stage span."""
from portbench.spans_deeplab import STAGES

BN_ACT = "layers.bn_act"
NAMES = (BN_ACT,)


def read(run):
    if run.trace is None:
        return None
    names = [o.name for o in run.trace.ops]
    if not any(n in STAGES for n in names):
        return None
    return names.count(BN_ACT) / run.trace.steps
