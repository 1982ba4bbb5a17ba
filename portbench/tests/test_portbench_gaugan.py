"""The GauGAN cell at CPU-test sizes (ngf 8, 32x64, 6 labels and the
instance edges, batch 4, float32) and the readers of its two per-layer
metrics on synthetic events.  The cell's check: the sound program within
every limit, the control and each fault of ``faults.FAULTS['gaugan_train']``
not correct."""
import time
from types import SimpleNamespace

import pytest

from portbench import faults, harness, roofline, roofline_spade, spans, \
    spans_gaugan
from portbench.driver import CONTROL, correct
from portbench.reference import gaugan as ref
from portbench.trace import Slice

CELL = "gaugan-cityscapes-train-bs16-bf16"


def _tiny():
    cell = harness.find_cell(CELL, harness.benchmark())
    cfg = harness.find_config(cell["config"])
    cfg.update(ngf=8, ndf=8, crop_size=64, label_nc=6,
               num_upsampling_layers="normal")
    cell["sizes"].update(batch=4, height=32, width=64)
    cell["arrays"]["label"][1] = 6
    cell.update(ring=3, dtype="float32")
    return cell, cfg


def _run(cell, cfg, seed=2 ** 31 + 25):
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), harness.benchmark(), cfg=cfg)


def test_the_sound_program_is_correct():
    result = _run(*_tiny())
    assert result["correct"], result["checks"]


def test_the_control_is_not_correct():
    cell, cfg = _tiny()
    driver = harness.load_driver(cell["driver"])(cell, cfg, 9, "cpu")
    driver.make_ring()
    want = driver.reference_readings("f32")
    control = driver.reference_readings(CONTROL[harness.find_cell(
        CELL)["dtype"]])
    got = driver.compare(control, want)
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


def _op(name, start, end, device_us=0.0, parent=None, op_id=None):
    return SimpleNamespace(name=name, self_device_time_total=device_us,
                           device_time_total=device_us, cpu_parent=parent,
                           thread=1, id=op_id if op_id is not None else start,
                           time_range=SimpleNamespace(start=start, end=end))


def _run_of(ops, cfg, steps=2, card="NVIDIA H100 80GB HBM3"):
    cell = harness.find_cell(CELL, harness.benchmark())
    return SimpleNamespace(
        cell=cell, cfg=cfg, card=card,
        trace=Slice(steps=steps, wall_s=1.0, kernels=[("k", 0.0, 0.5)],
                    ops=ops))


def test_spade_roofline_reads_whole_forwards_of_the_op():
    """Σ bound of the calls over their device time; a call nested in
    another of the same name (the op's own dispatch) counts once; None
    without a call."""
    cfg = harness.find_config("spade-gaugan-cityscapes")
    sites = ref.site_shapes(cfg, 16)
    bound = sum(roofline.bound_s(*roofline_spade.spade_work(
        s, ref.semantic_nc(cfg), "bfloat16"), "NVIDIA H100 80GB HBM3",
        "bfloat16") for s in sites)
    ops = []
    for i in range(2 * len(sites)):
        outer = _op(roofline_spade.SPADE_OP, 10 * i, 10 * i + 9, 1000.0)
        ops += [outer, _op(roofline_spade.SPADE_OP, 10 * i + 1, 10 * i + 8,
                           1000.0, parent=outer)]
    got = roofline_spade.spade_roofline(_run_of(ops, cfg))
    assert got == pytest.approx(100.0 * 2 * bound / (2 * len(sites) * 1e-3))
    assert roofline_spade.spade_roofline(
        _run_of([_op("aten::mm", 0, 1, 5.0)], cfg)) is None
    with pytest.raises(RuntimeError, match="whole forwards"):
        roofline_spade.spade_roofline(_run_of(ops[:2], cfg))


def test_spade_work_counts_the_products_and_each_byte_once():
    flops, nbytes = roofline_spade.spade_work((2, 4, 8, 16), 36, "bfloat16")
    assert flops == 2.0 * 64 * 9 * 128 * (36 + 32)
    assert nbytes == (64 * (32 + 36) * 2 + 4 * 2 * 2 * 16
                      + 4 * (9 * 128 * (36 + 32) + 128 + 32))


def test_vgg_ms_reads_the_loss_span():
    cfg = harness.find_config("spade-gaugan-cityscapes")
    ops = [_op(spans.FORWARD, 0, 1000),
           _op(spans_gaugan.LOSS_VGG, 100, 400),
           _op("aten::convolution", 150, 390, 700.0),
           _op("aten::convolution", 500, 600, 300.0),
           _op(spans_gaugan.LOSS_VGG, 1100, 1400),
           _op("aten::convolution", 1150, 1390, 500.0)]
    read = harness.load_reader("vgg_ms.train")
    assert read(_run_of(ops, cfg)) == pytest.approx(1200.0 / 1e3 / 2)
    assert read(_run_of(ops[:1], cfg)) is None
    assert read(SimpleNamespace(trace=None)) is None
