"""The plain reference against the port's CPU route at tiny widths, for
every driver, in float32: a first training step from the same seeded state
(losses and the first gradient of every leaf), and served or scored batches
(outputs)."""
import statistics

import pytest
import torch

from portbench import harness
from portbench.driver import kept_leaves, leaf_gaps
from portbench.reference import deeplab, seg2eye
from portbench.reference.common import parameter_count

TRAIN = ["seg2eye-train-bs16-bf16", "refinenet-train-bs8-f32"]
SERVE = ["refinenet-serve-bs32-bf16", "seg2eye-score-bs32-bf16"]


@pytest.mark.parametrize("name", TRAIN)
def test_first_training_step_matches_the_reference(name, tiny):
    cell, cfg = tiny(name)
    driver = harness.load_driver(cell["driver"])(cell, cfg, 2 ** 33 + 1,
                                                 "cpu")
    driver.setup()
    driver.release()
    prog = driver.readings()
    ref = driver.reference_readings("f32")
    for k, v in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(v, rel=1e-4), k
    assert set(prog["grad1"]) == set(ref["grad1"])
    gaps = leaf_gaps(prog["grad1"], ref["grad1"], kept_leaves(ref["grad1"]))
    assert max(gaps.values()) < 2e-3, max(gaps, key=gaps.get)
    assert statistics.median(gaps.values()) < 1e-4


@pytest.mark.parametrize("name", SERVE)
def test_served_batches_match_the_reference(name, tiny):
    cell, cfg = tiny(name)
    cell.update(sample=2, warmup=1)
    driver = harness.load_driver(cell["driver"])(cell, cfg, 12, "cpu")
    driver.setup()
    harness.window(driver, 0.3)
    driver.release()
    got = driver.compare(driver.readings(), driver.reference_readings("f32"))
    assert got and max(got.values()) < 1e-4, got


def test_the_weights_are_the_published_models_whole():
    """The benchmark's state dicts have every key and shape of the port's
    networks at the configurations' widths and depth, and the published
    parameter counts."""
    from seg2eye_tpu_torch.models.deeplab import RESNET_LAYERS, DeepLab
    from seg2eye_tpu_torch.models.pix2pix import build_networks
    from seg2eye_tpu_torch.options import Options

    cfg = harness.find_config("seg2eye-default")
    with torch.device("meta"):
        nets = build_networks(Options(isTrain=True).finalize())
    for name, specs in seg2eye.specs(cfg, train=True).items():
        port = {k: tuple(v.shape) for k, v in nets[name].state_dict().items()}
        assert port == {s.name: s.shape for s in specs}
        assert parameter_count(specs) == cfg["parameters"][name]
    cfg = harness.find_config("refinenet-r101-os16")
    with torch.device("meta"):
        net = DeepLab("resnet", 16, 1, RESNET_LAYERS[101])
    specs = deeplab.specs(cfg)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {s.name: s.shape for s in specs}
    assert parameter_count(specs) == cfg["parameters"]
