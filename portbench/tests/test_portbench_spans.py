"""The span readers (``portbench/spans.py``) on synthetic events, as the
profiler gives them: CPU ops with a host interval, a thread and their own
device time."""
import itertools
from types import SimpleNamespace

import pytest

from portbench import spans
from portbench.trace import Slice


_ids = itertools.count(1)


def _op(name, start, end, device_us=0.0, thread=1, op_id=None):
    return SimpleNamespace(name=name, self_device_time_total=device_us,
                           thread=thread, id=next(_ids) if op_id is None
                           else op_id,
                           time_range=SimpleNamespace(start=start, end=end))


def _run(ops, steps=2):
    sl = Slice(steps=steps, wall_s=1.0, kernels=[("k", 0.0, 0.5)], ops=ops)
    return SimpleNamespace(trace=sl)


def test_ops_of_another_thread_inside_the_interval_count():
    """The backward's kernels are launched from the autograd device
    thread: its ops count toward the span that the main thread holds."""
    ops = [_op(spans.BACKWARD, 100, 200),
           _op("autograd::engine::evaluate_function", 110, 150, 5.0, 2),
           _op("aten::convolution_backward", 120, 140, 300.0, 2),
           _op("aten::mul", 190, 230, 40.0, 2)]       # starts inside
    assert spans.span_ms(_run(ops), spans.BACKWARD) == pytest.approx(
        (5.0 + 300.0 + 40.0) / 1e3 / 2)


def test_a_nested_span_of_the_same_name_counts_once():
    ops = [_op(spans.FORWARD, 0, 100, 1.0),
           _op(spans.FORWARD, 10, 50, 2.0),
           _op("aten::conv", 20, 30, 100.0),
           _op(spans.FORWARD, 200, 300),                 # a second forward
           _op("aten::add", 250, 260, 10.0, 3)]
    assert spans.host_intervals(ops, spans.FORWARD) == [(0, 100), (200, 300)]
    assert spans.device_us(ops, spans.FORWARD) == pytest.approx(113.0)


def test_kernels_hung_on_two_events_of_one_id_count_once():
    """CUPTI's "Command Buffer Full" events inside a launch share the
    launching op's id, and the profiler hangs the op's kernels on them
    too."""
    ops = [_op(spans.FORWARD, 0, 100),
           _op("aten::cudnn_convolution", 10, 40, 500.0, op_id=7),
           _op("Command Buffer Full", 12, 30, 500.0, op_id=7),
           _op("Command Buffer Full", 31, 35, 500.0, op_id=7),
           _op("aten::add", 50, 60, 20.0, op_id=8)]
    assert spans.device_us(ops, spans.FORWARD) == pytest.approx(520.0)
    assert [o.name for o in spans.holders(ops)] == ["aten::cudnn_convolution",
                                                     "aten::add"]


def test_ops_outside_every_span_count_toward_none():
    ops = [_op("aten::copy_", 0, 5, 1000.0),
           _op(spans.OPTIMIZER, 10, 20),
           _op("aten::_foreach_add_", 12, 18, 7.0),
           _op("aten::fill_", 21, 22, 500.0),
           _op(spans.TO_DEVICE, 30, 40)]
    run = _run(ops, steps=1)
    assert spans.span_ms(run, spans.OPTIMIZER) == pytest.approx(0.007)
    assert spans.span_ms(run, spans.TO_DEVICE) == 0.0
    assert spans.span_ms(run, spans.FORWARD) is None


def test_none_without_a_trace_or_without_the_span():
    assert spans.span_ms(SimpleNamespace(trace=None), spans.FORWARD) is None
    assert spans.span_count(SimpleNamespace(trace=None),
                            spans.K1_PACK) is None
    run = _run([_op("aten::mm", 0, 1, 3.0)])
    for name in spans.NAMES:
        assert spans.span_ms(run, name) is None
        assert spans.span_count(run, name) is None


def test_packings_are_counted_per_step():
    ops = [_op(spans.K1_PACK, 10 * i, 10 * i + 5) for i in range(36)]
    assert spans.span_count(_run(ops, steps=2), spans.K1_PACK) == 18.0


def test_no_packing_in_a_slice_with_spans_reads_zero():
    """A program that records its spans and packs nothing reads 0, not
    the None of a program without spans."""
    ops = [_op(spans.FORWARD, 0, 100), _op("aten::conv", 10, 20, 50.0),
           _op(spans.BACKWARD, 100, 200)]
    assert spans.span_count(_run(ops, steps=2), spans.K1_PACK) == 0.0
    assert spans.span_count(_run([_op("aten::conv", 10, 20, 50.0)]),
                            spans.K1_PACK) is None


@pytest.mark.parametrize("metric, name", [
    ("forward_ms.train", spans.FORWARD),
    ("backward_ms.train", spans.BACKWARD),
    ("optimizer_ms.train", spans.OPTIMIZER),
    ("to_device_ms.infer", spans.TO_DEVICE),
])
def test_metric_files_read_their_span(metric, name):
    from portbench.harness import load_reader

    read = load_reader(metric)
    ops = [_op(name, 0, 10), _op("aten::x", 1, 2, 4000.0)]
    assert read(_run(ops, steps=4)) == pytest.approx(1.0)
    assert read(_run([_op("aten::x", 1, 2, 4000.0)])) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_packing_metric_file_reads_the_counter():
    from portbench.harness import load_reader

    read = load_reader("k1_packings.train")
    assert read(_run([_op(spans.K1_PACK, 0, 1)] * 6, steps=2)) == 3.0
    assert read(_run([])) is None

