"""The generic DeepLabV3+ trainer (``seg2eye_tpu_torch.segtrain``) with the
Aligned Xception-65 backbone, full depth and width, against the
benchmark's plain reference (``portbench/reference/xception.py``) on the
CPU: one ``SegTrainer.train_step`` in float32 from the same seeded state
and batch (the loss, the first gradient of every leaf, the BN buffers
after the step), the published parameter count, and the phase and
DeepLab spans of a profiled step.

Crop 97, batch 2 (the deepest maps 7x7 at output stride 16), 21
classes, labels with 255 ignored.  Dropout draws its masks from one
seeded generator on both sides.
"""
import os
import statistics

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.driver import buffer_gap
from portbench.drivers import segtrain_train as driver
from portbench.reference import xception as ref
from portbench.reference.common import parameter_count
from seg2eye_tpu_torch.models.deeplab import DeepLab
from seg2eye_tpu_torch.segtrain.trainer import SegTrainer
from seg2eye_tpu_torch.utils import spans

CELL = "segtrain-pascal-train-bs16-bf16"
CROP, BATCH = 97, 2
SEED = 2 ** 33 + 21
CPU = torch.autograd.DeviceType.CPU
# float32 on both sides, the sums in other orders (channels_last against
# NCHW convs, another BN kernel) and amplified by ~140 train-mode BNs over
# few values: over 7 seeds the loss read 0-1.4e-7, the worst leaf's
# gradient 4e-5 to 3.0e-3 of the median leaf's norm, the buffers 7e-7 of
# the median buffer's; the limits leave about 3 times the worst gradient
# and 10-30 times the rest, where a wrong layer reads O(1)
LOSS_RTOL = 2e-6
GRAD_TOL = 1e-2
BUFFER_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (see
    test_torch_refinenet.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    cell = harness.find_cell(CELL, harness.benchmark())
    cell["sizes"].update(batch=BATCH, height=CROP, width=CROP)
    cell["dtype"] = "float32"
    return cell, harness.find_config(cell["config"])


def _batch(void_label):
    rng = np.random.default_rng(SEED % 2 ** 32)
    label = rng.integers(0, void_label + 1, (BATCH, CROP, CROP)).astype(
        np.uint8)
    label[label == void_label] = ref.IGNORE
    return {"image": rng.integers(0, 256, (BATCH, CROP, CROP, 3),
                                  dtype=np.uint8),
            "label": label}


def _dropout():
    return torch.Generator().manual_seed(SEED)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """The port's trainer after one step from the seeded state, and the
    reference after the same step."""
    cell, cfg = _config()
    batch = _batch(cell["void_label"])
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("segtrain"))     # the Saver's run/
    try:
        trainer = SegTrainer(driver.trainer_args(cfg, cell, "cpu"), loaders=(
            [batch], None, None, cfg["num_classes"]))
    finally:
        os.chdir(cwd)
    sd = driver.weights(cfg, SEED, "cpu")
    trainer.net.load_state_dict(sd, strict=True)
    loss, _ = trainer.train_step(ref.normalize(torch.from_numpy(
        batch["image"])), torch.from_numpy(batch["label"]), cfg["lr"],
        _dropout())
    reference = ref.Trainer(cfg, {k: v.clone() for k, v in sd.items()})
    ref_loss, grads = reference.step(batch, "cpu", _dropout())
    yield dict(cfg=cfg, batch=batch, trainer=trainer, initial=sd, loss=loss,
               ref_loss=ref_loss, grads=grads, ref_state=reference.net.sd)
    trainer.writer.close()


def test_train_step_matches_the_reference(stepped):
    cfg, trainer = stepped["cfg"], stepped["trainer"]
    assert float(stepped["loss"]) == pytest.approx(
        float(stepped["ref_loss"]), rel=LOSS_RTOL)
    # the gradient as SGD got it: its momentum buffer after one step, less
    # the weight decay of the initial weight
    params = dict(trainer.net.named_parameters())
    got = {k: trainer.optimizer.state[p]["momentum_buffer"]
           - cfg["weight_decay"] * stepped["initial"][k]
           for k, p in params.items()}
    grads = stepped["grads"]
    assert set(got) == set(grads) == set(ref.trained_keys(
        stepped["initial"]))
    size = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    # a leaf whose true gradient is 0 (the BN bias before a pointwise conv
    # and another BN) holds round-off alone: gaps over the median leaf's
    # norm where a leaf's own is smaller
    median = statistics.median(size.values())
    gaps = {k: float(torch.linalg.vector_norm(got[k] - grads[k]))
            / max(size[k], median) for k in grads}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < GRAD_TOL, worst
    # the running statistics by the benchmark's rule (a mean of ~0, as
    # after a pointwise conv of a BN's output, is held to the median
    # buffer's norm), and every BN counted one batch
    buffers = dict(trainer.net.named_buffers())
    ref_state = stepped["ref_state"]
    assert buffer_gap(buffers, {k: ref_state[k] for k in buffers}) \
        < BUFFER_TOL
    assert all(int(v) == 1 for k, v in buffers.items()
               if k.endswith("num_batches_tracked"))


def test_parameter_count_is_the_published_models():
    """54,705,317 parameters at 21 classes: the port's network, the
    reference's specs and the configuration agree, key by key."""
    _, cfg = _config()
    with torch.device("meta"):
        net = DeepLab("xception", 16, cfg["num_classes"])
    specs = ref.specs(cfg)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {s.name: tuple(s.shape) for s in specs}
    count = sum(p.numel() for p in net.parameters())
    assert count == parameter_count(specs) == cfg["parameters"] == 54705317


def _inside(inner, outer) -> bool:
    return (inner.time_range.start >= outer.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_profiled_step_opens_each_new_span(stepped):
    """The step's three phases in turn, the DeepLab stages in turn inside
    the forward, and one NCHW-copy span per copy: in float32 the ASPP's
    three dilated convs and the exit flow's three dilated depthwise
    convs."""
    cfg, batch, trainer = stepped["cfg"], stepped["batch"], \
        stepped["trainer"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_step(ref.normalize(torch.from_numpy(batch["image"])),
                           torch.from_numpy(batch["label"]), cfg["lr"],
                           _dropout())
    events = sorted((e for e in prof.events() if e.device_type == CPU
                     and e.name in spans.NAMES),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    counts = {n: names.count(n) for n in set(names)}
    assert counts == {spans.FORWARD: 1, spans.BACKWARD: 1,
                      spans.OPTIMIZER: 1, spans.DEEPLAB_BACKBONE: 1,
                      spans.DEEPLAB_ASPP: 1, spans.DEEPLAB_DECODER: 1,
                      spans.NCHW_COPY: 6}
    one = {e.name: e for e in events if e.name != spans.NCHW_COPY}
    phases = [one[n] for n in (spans.FORWARD, spans.BACKWARD,
                               spans.OPTIMIZER)]
    stages = [one[n] for n in (spans.DEEPLAB_BACKBONE, spans.DEEPLAB_ASPP,
                               spans.DEEPLAB_DECODER)]
    for seq in (phases, stages):
        assert all(a.time_range.end <= b.time_range.start
                   for a, b in zip(seq, seq[1:]))
    assert all(_inside(s, one[spans.FORWARD]) for s in stages)
    copies = [e for e in events if e.name == spans.NCHW_COPY]
    assert sum(_inside(c, one[spans.DEEPLAB_BACKBONE]) for c in copies) == 3
    assert sum(_inside(c, one[spans.DEEPLAB_ASPP]) for c in copies) == 3
