"""The segtrain cell at CPU-test sizes (full-depth Xception-65 at crop 65,
batch 4, float32: the half-batch fault leaves the ASPP pool's BN two
values) and the readers of the DeepLab spans on synthetic events.  The
cell's check: the sound program's first gradient within its limit, the
control and each fault of ``faults.FAULTS['segtrain_train']`` not
correct."""
import time
from types import SimpleNamespace

import pytest

from portbench import faults, harness, spans, spans_deeplab
from portbench.driver import CONTROL, correct
from portbench.trace import Slice

CELL = "segtrain-pascal-train-bs16-bf16"


def _tiny():
    cell = harness.find_cell(CELL, harness.benchmark())
    cell["sizes"].update(batch=4, height=65, width=65)
    cell.update(ring=3, dtype="float32")
    return cell, harness.find_config(cell["config"])


def _run(cell, cfg, seed=2 ** 31 + 3):
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), harness.benchmark(), cfg=cfg)


def test_the_sound_programs_first_gradient_is_correct():
    """At crop 65 the BNs of the 5x5 maps, and the ASPP pool's over four
    values, let three SGD steps drift apart on float32 round-off: the
    first step's gradient is what this size can hold."""
    checks = _run(*_tiny())["checks"]
    assert checks["grad1_median_gap"]["value"] <= \
        checks["grad1_median_gap"]["limit"], checks


def test_the_control_is_not_correct():
    cell, cfg = _tiny()
    driver = harness.load_driver(cell["driver"])(cell, cfg, 9, "cpu")
    driver.make_ring()
    ref = driver.reference_readings("f32")
    control = driver.reference_readings(CONTROL[harness.find_cell(
        CELL)["dtype"]])
    got = driver.compare(control, ref)
    assert not correct([{"name": k, "value": got[k], "limit": v}
                        for k, v in cell["limits"].items()])


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_fault_is_not_correct(fault):
    cell, cfg = _tiny()
    harness.load_driver(cell["driver"])          # registers its faults
    assert faults.FAULTS[cell["driver"]] == ("unchanged", "half")
    with faults.plant(cell["driver"], fault):
        result = _run(cell, cfg)
    assert not result["correct"], result["checks"]


def _op(name, start, end, device_us=0.0, op_id=None):
    return SimpleNamespace(name=name, self_device_time_total=device_us,
                           thread=1, id=op_id if op_id is not None else start,
                           time_range=SimpleNamespace(start=start, end=end))


def _run_of(ops, steps=2):
    return SimpleNamespace(trace=Slice(steps=steps, wall_s=1.0,
                                       kernels=[("k", 0.0, 0.5)], ops=ops))


def test_stage_readers_and_the_copy_counter():
    ops = [_op(spans.FORWARD, 0, 1000),
           _op(spans_deeplab.DEEPLAB_BACKBONE, 10, 400),
           _op(spans_deeplab.NCHW_COPY, 300, 310),
           _op("aten::clone", 301, 309, 50.0),
           _op("aten::convolution", 320, 390, 400.0),
           _op(spans_deeplab.DEEPLAB_ASPP, 400, 700),
           _op("aten::convolution", 410, 690, 1000.0),
           _op(spans_deeplab.DEEPLAB_DECODER, 700, 900),
           _op(spans.FORWARD, 1000, 2000),
           _op(spans_deeplab.DEEPLAB_BACKBONE, 1010, 1400),
           _op(spans_deeplab.NCHW_COPY, 1300, 1310),
           _op(spans_deeplab.DEEPLAB_ASPP, 1400, 1700),
           _op(spans_deeplab.DEEPLAB_DECODER, 1700, 1900)]
    run = _run_of(ops)
    assert spans.span_ms(run, spans_deeplab.DEEPLAB_BACKBONE) == \
        pytest.approx(450.0 / 1e3 / 2)
    assert spans.span_ms(run, spans_deeplab.DEEPLAB_ASPP) == \
        pytest.approx(1000.0 / 1e3 / 2)
    assert spans_deeplab.copies_per_step(run) == 1.0


def test_the_copy_counter_reads_0_or_nothing():
    """0 in a slice with DeepLab's stages and no copy (bfloat16 ResNet);
    None in a slice of a program without the spans, and untraced."""
    stages = [_op(n, 10 * i, 10 * i + 5)
              for i, n in enumerate(spans_deeplab.STAGES)]
    assert spans_deeplab.copies_per_step(_run_of(stages)) == 0.0
    older = [_op(spans.FORWARD, 0, 100), _op("aten::clone", 1, 2, 5.0)]
    assert spans_deeplab.copies_per_step(_run_of(older)) is None
    assert spans.span_ms(_run_of(older), spans_deeplab.DEEPLAB_ASPP) is None
    assert spans_deeplab.copies_per_step(SimpleNamespace(trace=None)) is None
