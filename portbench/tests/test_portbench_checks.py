"""``correct`` comes out false for the control and for each fault a cell
can have, at CPU-test sizes, with the cells' own limits.

The control is the reference put in the program's place, with the products
of the precision below the cell's (``driver.CONTROL``).  The faults
(``portbench.faults``) break the timed path underneath the driver, which
then runs as it does on the card (the look for a card is skipped).  The
sound program, in float32 at these sizes, comes out correct (RefineNet
training: its first step, ``HELD_AT_TEST_SIZE``)."""
import time

import pytest

from portbench import harness
from portbench.driver import CONTROL, correct
from portbench.faults import FAULTS, plant

TRAIN = ["seg2eye-train-bs16-bf16", "refinenet-train-bs8-f32"]
SERVE = ["refinenet-serve-bs32-bf16", "seg2eye-score-bs32-bf16"]


def _run(cell, cfg, seed=2 ** 31 + 3):
    cell.update(sample=2, warmup=1) if "sample" in cell else None
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), harness.benchmark(),
                            cfg=cfg)


def _numbers(driver, readings, ref):
    got = driver.compare(readings, ref)
    return [{"name": k, "value": got[k], "limit": v}
            for k, v in driver.cell["limits"].items()]


# At 64x40 a ResNet-101's batch statistics over a few values let its
# second and third SGD steps drift apart on round-off (loss 1.7e-2, change
# 0.19 in float32), where at 640x400 on the card they read 1e-4 and 1e-2:
# there the first step's gradient is what this size can hold.
HELD_AT_TEST_SIZE = {"refinenet-train-bs8-f32": ("grad1_gap",)}


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_sound_program_is_correct(name, tiny):
    checks = _run(*tiny(name))["checks"]
    held = HELD_AT_TEST_SIZE.get(name, tuple(checks))
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in held), \
        checks


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_control_is_not_correct(name, tiny):
    cell, cfg = tiny(name)
    driver = harness.load_driver(cell["driver"])(cell, cfg, 9, "cpu")
    driver.make_ring()
    if not driver.training:
        driver.reservoir_from_slots(range(2))
    ref = driver.reference_readings("f32")
    control = driver.reference_readings(CONTROL[harness.find_cell(
        name)["dtype"]])
    assert not correct(_numbers(driver, control, ref))


# ---- faults in the timed path
@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in TRAIN + SERVE
    for fault in FAULTS[harness.find_cell(name)["driver"]]])
def test_a_fault_is_not_correct(name, fault, tiny):
    cell, cfg = tiny(name)
    with plant(cell["driver"], fault):
        result = _run(cell, cfg)
    assert not result["correct"], result["checks"]
