"""The port's phase spans (``seg2eye_tpu_torch/utils/spans.py``) on the
CPU: each timed path records its spans under ``torch.profiler``, nested as
the benchmark's readers expect, each packing of K1's weights is one span,
and with no profiler running no path enters ``record_function``.  Tiny
configurations: Seg2Eye at ngf 4, crop 32, batch 2; RefineNet at
ResNet-14, 64x40, batch 2."""
import numpy as np
import pytest
import torch

from portbench import harness as bench_harness
from portbench import spans as bench_spans
from portbench import spans_deeplab as bench_spans_deeplab
from portbench import spans_gaugan as bench_spans_gaugan
from portbench import trace as bench_trace
from seg2eye_tpu_torch.data.openeds import to_device
from seg2eye_tpu_torch.eval import tester as tester_lib
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.refinenet import model as rn_model
from seg2eye_tpu_torch.refinenet import training as rn_training
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.utils import spans, weights

CPU = torch.autograd.DeviceType.CPU
STEP_PHASES = (spans.FORWARD, spans.BACKWARD, spans.OPTIMIZER)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seg2eye_batch(opt, native=None, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w = opt.batchSize, opt.image_height, opt.image_width
    batch = {"label": rng.integers(0, opt.label_nc,
                                   (b, h, w)).astype(np.int32),
             "style_image": rng.integers(0, 256, (b, opt.input_ns, h, w, 1),
                                         dtype=np.uint8)}
    if native is None:
        batch["target"] = rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8)
    else:
        batch["target_original"] = rng.integers(0, 256, (b, *native, 1),
                                                dtype=np.uint8)
    return batch


@pytest.fixture(scope="module")
def seg2eye():
    opt = Options(ngf=4, ndf=4, crop_size=32, aspect_ratio=1.0, w_dim=8,
                  input_ns=2, batchSize=2, compute_dtype="float32",
                  isTrain=True).finalize()
    nets = weights.init_networks(opt, torch.Generator().manual_seed(0),
                                 "cpu")
    return state_lib.create_state(Pix2Pix(opt, nets, "cpu"))


@pytest.fixture(scope="module")
def refinenet():
    cfg = RefineNetConfig(batch_size=2, test_batch_size=2,
                          compute_dtype="float32", resnet_depth=14,
                          input_width=40, input_height=64)
    m = rn_model.RefineNetModel(cfg, "cpu")
    trainer = rn_training.Trainer(m, cfg, "eds_loss")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 64, 40, c),
                                              dtype=np.uint8))
             for k, c in (("input", 3), ("target", 1))}
    return trainer, state, batch


def _paths(seg2eye, refinenet):
    """{path: a call of it}, each path one of the benchmark's timed ones."""
    opt = seg2eye.model.opt
    trainer, rn_state, rn_batch = refinenet
    train_batch = _seg2eye_batch(opt)
    score_batch = _seg2eye_batch(opt, native=(64, 40), seed=1)
    return {
        "seg2eye_train": lambda: steps.train_step(seg2eye, train_batch),
        "refinenet_train": lambda: trainer.train_step(rn_state, rn_batch,
                                                      1e-4),
        "refinenet_serve": lambda: trainer.eval_step(rn_state, rn_batch),
        "seg2eye_score": lambda: tester_lib.Tester(opt).score_batch(
            seg2eye.model, score_batch),
        "to_device": lambda: to_device(train_batch, torch.device("cpu")),
    }


# per path: {span: times recorded}, and (inner, outer) pairs where each
# inner span lies inside an outer one
EXPECTED = {
    "seg2eye_train": ({spans.G_STEP: 1, spans.D_STEP: 1, spans.FORWARD: 2,
                       spans.BACKWARD: 2, spans.OPTIMIZER: 2},
                      [(p, (spans.G_STEP, spans.D_STEP))
                       for p in STEP_PHASES]
                      + [(spans.BACKWARD_RANGE, (spans.BACKWARD,))]),
    "refinenet_train": ({spans.FORWARD: 1, spans.BACKWARD: 1,
                         spans.OPTIMIZER: 1}, []),
    "refinenet_serve": ({spans.REFINENET_SERVE: 1}, []),
    "seg2eye_score": ({spans.SCORE: 1, spans.TO_DEVICE: 2},
                      [(spans.TO_DEVICE, (spans.SCORE,))]),
    "to_device": ({spans.TO_DEVICE: 1}, []),
}


def _recorded(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.device_type == CPU
            and e.name in spans.NAMES]


def _inside(inner, outer) -> bool:
    return (inner.time_range.start >= outer.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_each_path_records_its_spans(path, seg2eye, refinenet):
    events = _recorded(_paths(seg2eye, refinenet)[path])
    counts, nesting = EXPECTED[path]
    got = {name: sum(e.name == name for e in events) for name in counts}
    assert got == counts
    for inner, outers in nesting:
        found = [e for e in events if e.name == inner]
        assert found, inner
        for e in found:
            assert any(_inside(e, o) for o in events if o.name in outers), \
                (inner, outers)
    if path == "seg2eye_train":
        # each step span holds exactly one forward, backward and optimizer
        for step in (spans.G_STEP, spans.D_STEP):
            outer = next(e for e in events if e.name == step)
            assert sorted(e.name for e in events if e.name in STEP_PHASES
                          and _inside(e, outer)) == sorted(STEP_PHASES)
    if path == "refinenet_train":
        # forward, backward and optimizer in turn, none inside another
        phases = sorted((e for e in events if e.name in STEP_PHASES),
                        key=lambda e: e.time_range.start)
        assert [e.name for e in phases] == list(STEP_PHASES)
        assert all(a.time_range.end <= b.time_range.start
                   for a, b in zip(phases, phases[1:]))


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_no_profiler_no_range(path, seg2eye, refinenet, monkeypatch):
    """Off, a span is one flag check: the path never enters
    ``record_function``.  The same patch counts the spans under a
    profiler, so the patch point is the one ``span`` uses."""
    names = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *args, **kw):
            names.append(name)
            super().__init__(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    fn = _paths(seg2eye, refinenet)[path]
    fn()
    assert names == []
    recorded = _recorded(fn)
    assert names and sorted(names) == sorted(e.name for e in recorded)


def test_each_packing_is_one_span():
    g = torch.Generator().manual_seed(0)
    c = 8
    wg, wb = (torch.randn(c, K.NHIDDEN, 3, 3, generator=g) for _ in "gb")
    bg, bb = torch.randn(c, generator=g), torch.randn(c, generator=g)
    packed = K.PackedWeights()

    def calls():
        packed(wg, bg, wb, bb, torch.float32)          # packs
        packed(wg, bg, wb, bb, torch.float32)          # cache hit
        wg.add_(1.0)                                   # _version moves
        packed(wg, bg, wb, bb, torch.float32)          # packs again
        packed(wg, bg, wb, bb, torch.bfloat16)         # another dtype

    events = _recorded(calls)
    assert packed.packings == 3
    assert [e.name for e in events] == [spans.K1_PACK] * 3
    packed(wg, bg, wb, bb, torch.float32)
    assert _recorded(lambda: packed(wg, bg, wb, bb, torch.float32)) == []


def test_backward_range_keeps_its_name():
    assert spans.BACKWARD_RANGE == "spade_style backward (plain recompute)"
    assert bench_trace.BACKWARD_RANGE == spans.BACKWARD_RANGE


def test_benchmark_copies_every_span_name():
    """The benchmark keeps the names in ``portbench/spans.py``,
    ``portbench/spans_deeplab.py`` (the DeepLab stages and the NCHW copy),
    ``portbench/spans_gaugan.py`` (the VGG loss) and the reader of
    ``bn_act_passes.infer`` (the fused BN passes): together, and with no
    name in two, they copy the program's."""
    program = {k: v for k, v in vars(spans).items()
               if k.isupper() and isinstance(v, str) and k != "BACKWARD_RANGE"}
    modules = (bench_spans, bench_spans_deeplab, bench_spans_gaugan,
               bench_harness._load_file(
                   bench_harness.HERE / "metrics" / "bn_act_passes.infer.py",
                   "portbench_metric_bn_act_passes_infer"))
    copies = [{k: v for k, v in vars(module).items()
               if k.isupper() and isinstance(v, str)}
              for module in modules]
    assert sum(map(len, copies)) == len({k for c in copies for k in c})
    assert {k: v for c in copies for k, v in c.items()} == program
    names = [n for module in modules for n in module.NAMES]
    assert len(set(names)) == len(names)
    assert set(names) | {spans.BACKWARD_RANGE} == set(spans.NAMES)
    assert len(set(spans.NAMES)) == len(spans.NAMES)


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::spade_style_sm90_kernel_bwd<128>("
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)",
    "void (anonymous namespace)::spade_style_sm90_kernel_bwd<64>("
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)",
    "_ZN12_GLOBAL__N_127spade_style_sm90_kernel_bwdILi128EEEv14CUtensorMap_st",
    "void (anonymous namespace)::spade_style_sm90_kernel_nostyle<256>("
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)",
    "void (anonymous namespace)::spade_style_3xtf32_sm90_kernel_nostyle("
    "CUtensorMap_st, CUtensorMap_st, float const*)",
    "void (anonymous namespace)::spade_style_sm90_kernel_bwd_nostyle<64>("
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)"])
def test_backward_kernel_groups_with_k1(symbol):
    """The backward kernel's name, and those of the plain-SPADE kernels
    (``ops.spade``), fall in the benchmark's K1 group, not in cuDNN's:
    their ``sm90_`` would otherwise count them in ``conv_ms.train``."""
    assert bench_trace.group_of(symbol) == "k1"


def test_op_backward_is_one_backward_range():
    """The op's backward, whatever its route, runs inside one
    ``BACKWARD_RANGE`` span per site, the range ``norm_bwd_ms.train``
    reads (``portbench.readers`` takes the name from ``portbench.trace``)."""
    from portbench import readers

    assert readers.BACKWARD_RANGE == spans.BACKWARD_RANGE
    g = torch.Generator().manual_seed(1)
    n, h, w, c = 2, 5, 6, 8
    x = torch.randn(n, h, w, c, generator=g).requires_grad_()
    seg = torch.nn.functional.one_hot(
        torch.randint(0, 4, (n, h, w), generator=g), 4).float()
    var, mean = torch.var_mean(x.detach(), dim=(0, 1, 2), correction=0)
    args = [x, seg, torch.randn(n, 2 * c, generator=g), mean.expand(n, c),
            var.expand(n, c), torch.randn(128, 4, 3, 3, generator=g),
            torch.randn(128, generator=g),
            torch.randn(c, 128, 3, 3, generator=g).requires_grad_(),
            torch.randn(c, generator=g), torch.randn(c, 128, 3, 3, generator=g),
            torch.randn(c, generator=g)]
    events = _recorded(lambda: K.spade_style(*args).sum().backward())
    assert [e.name for e in events] == [spans.BACKWARD_RANGE]
    assert x.grad is not None and args[7].grad is not None


def test_forward_then_backward_packs_once():
    """The cache entry made on a miss holds both layouts: a bfloat16
    forward's packing serves the backward's gamma-only layout and
    cat(wg, wb) in bfloat16, one packing (one ``K1_PACK`` span) in all."""
    g = torch.Generator().manual_seed(2)
    c = 12
    wg, wb = (torch.randn(c, K.NHIDDEN, 3, 3, generator=g) for _ in "gb")
    bg, bb = torch.randn(c, generator=g), torch.randn(c, generator=g)
    packed = K.PackedWeights()
    calls = []

    def forward_backward():
        calls.append(packed(wg, bg, wb, bb, torch.bfloat16))
        calls.append(packed.backward(wg, bg, wb, bb, torch.bfloat16))

    events = _recorded(forward_backward)
    assert packed.packings == 1
    assert [e.name for e in events] == [spans.K1_PACK]
    (wcat, bcat), (wgam, bcat_g, wgb) = calls
    assert bcat_g is bcat
    torch.testing.assert_close(
        wgam, K.pack_gamma_weights(wg, torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(
        wgb, torch.cat([wg, wb]).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(
        wcat, K.pack_weights(wg, bg, wb, bb, torch.bfloat16)[0], rtol=0,
        atol=0)
