"""PyTorch port, GauGAN (SPADE on Cityscapes): the plain SPADE op
(``ops.spade``), instance edges, the label channels, and the model through
the port's normal path against the benchmark's plain reference
(``portbench/reference/gaugan.py``).

The CUDA kernels run only on the card, where ``chip_smoke.py`` phase 16
holds them against the plain version at the cell's 18 site shapes.  Here,
on the CPU at tiny sizes (ngf 8, 32x64, 6 labels and the edges; 'more' at
64x128): the op's CPU route against SPADE's math, the backward kernel's
closed form against autograd, ``get_edges`` on a hand-made map, the norm
and option parsing, and the port's generator, losses and first gradients
against the reference from one seeded state loaded ``strict=True``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness as bench_harness
from portbench.driver import buffer_gap
from portbench.drivers import _seg2eye as bench_s2e
from portbench.drivers import gaugan_train as bench_driver
from portbench.reference import gaugan as ref
from portbench.traffic import Ring
from seg2eye_tpu_torch.models import normalization
from seg2eye_tpu_torch.models.normalization import SpadeBlock, parse_norm_g
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
from seg2eye_tpu_torch.models.vgg import to_rgb
from seg2eye_tpu_torch.ops import spade as P
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.ops.image import instance_edges
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps

SEED = 2 ** 33 + 25
# the benchmark's configuration at a tiny size: every key as the cell has
# it but the widths, the crop and the labels
TINY = {**bench_harness.find_config("spade-gaugan-cityscapes"), "ngf": 8,
        "ndf": 8, "crop_size": 64, "label_nc": 6,
        "num_upsampling_layers": "normal"}
MORE = {**TINY, "crop_size": 128, "num_upsampling_layers": "more"}


def tiny_cell(cfg, batch=2):
    h, w = ref.image_hw(cfg)
    return {"dtype": "float32", "ring": 1,
            "sizes": {"batch": batch, "height": h, "width": w},
            "arrays": {"label": [["batch", "height", "width"],
                                 cfg["label_nc"], [1, 4, 4]],
                       "instance": [["batch", "height", "width"], 256,
                                    [1, 8, 8]],
                       "target": [["batch", "height", "width", 3], 256]}}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def site_args(dtype, n=2, h=5, w=7, c=12, s=7, seed=0):
    """One site's inputs (x, seg, mean, var, ws, bs, wg, bg, wb, bb)."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, dtype=torch.float64)
                * scale)

    x = r(n, h, w, c) + 0.5
    var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
    stats = [mean.expand(n, c), var.expand(n, c)]
    if dtype != torch.float64:
        stats = [t.to(torch.float32) for t in stats]
    return [x.to(dtype), r(n, h, w, s).to(dtype), *stats,
            r(128, s, 3, 3, scale=0.1), r(128, scale=0.1),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1)]


def spade_math(x, seg, mean, var, ws, bs, wg, bg, wb, bb):
    """NVlabs/SPADE's SPADE.forward on NHWC tensors, float64."""
    def conv(t, w, b):
        return F.conv2d(t.permute(0, 3, 1, 2), w, b, padding=1)

    d = torch.float64
    actv = torch.relu(conv(seg.to(d), ws.to(d), bs.to(d)))
    gamma = F.conv2d(actv, wg.to(d), bg.to(d), padding=1).permute(0, 2, 3, 1)
    beta = F.conv2d(actv, wb.to(d), bb.to(d), padding=1).permute(0, 2, 3, 1)
    normalized = (x.to(d) - mean.to(d)[:, None, None]) / torch.sqrt(
        var.to(d)[:, None, None] + 1e-5)
    return normalized * (1 + gamma) + beta


# the op's CPU route against SPADE's math: float64 to its round-off; float32
# to float32's over 1152-term products (about 1e-6 of |out|, 1e-5 leaves
# room); bfloat16 computes each product in bfloat16 (the operands and
# actv rounded, 2^-8 relative each), about 1e-2 of |out| at these sizes
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)],
                         ids=["float64", "float32", "bfloat16"])
def test_spade_op_cpu_route_is_spade_math(dtype, tol):
    args = site_args(dtype)
    before = (P.spade.launches, K.spade_style.launches)
    out = P.spade(*args)
    want = spade_math(*args)
    assert out.dtype == dtype and out.shape == args[0].shape
    scale = float(want.abs().max())
    assert float((out.double() - want).abs().max()) <= tol * scale
    assert (P.spade.launches, K.spade_style.launches) == before


@pytest.mark.parametrize("needs", [(True,) * 10,
                                   (True, False, True, True, False, False,
                                    True, True, True, True)],
                         ids=["all", "training"])
def test_spade_backward_closed_form_is_autograd(needs):
    """``spade_backward_reference`` (the kernel route's closed form: h =
    dout, no style term) against autograd of the plain version, float64,
    every input that takes a gradient; the op's CPU backward is the
    autograd itself."""
    args = site_args(torch.float64, seed=3)
    dout = torch.randn(args[0].shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(4))
    leaves = [a.clone().requires_grad_(need) for a, need in zip(args, needs)]
    out = P.spade(*leaves)
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, dout))
    auto = [next(grads) if t.requires_grad else None for t in leaves]
    closed = P.spade_backward_reference(*args, dout, needs=needs)
    for i, (a, c) in enumerate(zip(auto, closed)):
        if not needs[i]:
            assert c is None
            continue
        assert float((a - c).abs().max()) <= 1e-10 * float(a.abs().max()), i


def test_instance_edges_on_a_hand_made_map():
    """The 4-neighbour inequality of ``get_edges``: both pixels of every
    differing pair are edges, in the port (NHWC) and the reference
    (NCHW)."""
    inst = torch.tensor([[[1, 1, 1, 2],
                          [1, 1, 1, 2],
                          [3, 3, 1, 1]]], dtype=torch.uint8)
    want = torch.tensor([[[0, 0, 1, 1],
                          [1, 1, 1, 1],
                          [1, 1, 1, 1]]], dtype=torch.float32)
    assert torch.equal(instance_edges(inst)[..., 0], want)
    assert torch.equal(instance_edges(inst[..., None])[..., 0], want)
    assert torch.equal(ref.get_edges(inst[:, None])[:, 0], want)


@pytest.mark.parametrize("norm_g,want", [
    ("spectralspadesyncbatch3x3", (True, "batch", 3)),
    ("spadesyncbatch3x3", (False, "batch", 3)),
    ("spectralspadebatch3x3", (True, "batch", 3)),
    ("spectralspadeinstance3x3", (True, "instance", 3))])
def test_parse_norm_g_takes_syncbatch_as_batch(norm_g, want):
    assert parse_norm_g(norm_g) == want


def test_to_rgb_passes_three_channels():
    x = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 4, 3)
    assert torch.equal(to_rgb(x), x)
    assert torch.equal(to_rgb(x[..., :1]), x[..., :1].expand(2, 3, 4, 3))


@pytest.mark.parametrize("flags,want", [
    ({}, 35), ({"no_instance": False}, 36),
    ({"no_instance": False, "contain_dontcare_label": True}, 37)],
    ids=["labels", "edges", "edges-dontcare"])
def test_semantic_nc_counts_dontcare_and_edges(flags, want):
    opt = Options(label_nc=35, **flags).finalize()
    assert opt.semantic_nc == want
    assert opt.semantic_nc == ref.semantic_nc(
        {"label_nc": 35, "no_instance": opt.no_instance,
         "contain_dontcare_label": opt.contain_dontcare_label})


def port_model(cfg, sd):
    """The port's networks for ``cfg`` as the benchmark builds them: the
    options of the configuration, ``build_networks``, the seeded state
    dicts loaded ``strict=True``."""
    cell = tiny_cell(cfg)
    opt = bench_s2e.options(cfg, cell, train=True)
    nets = bench_s2e.port_nets(
        opt, {n: {k: v.clone() for k, v in d.items()} for n, d in sd.items()},
        "cpu")
    return Pix2Pix(opt, nets, "cpu")


def test_gaugan_builds_without_an_encoder():
    sd = bench_driver.weights(TINY, SEED, "cpu")
    model = port_model(TINY, sd)
    assert model.netE is None and set(sd) == {"G", "D", "VGG"}
    sites = [m for m in model.netG.modules() if isinstance(m, SpadeBlock)]
    assert len(sites) == len(ref.site_shapes(TINY, 2)) == 18
    assert model.netD.discriminator_0.model0[0].weight.shape[1] == \
        ref.semantic_nc(TINY) + 3 == 10
    with pytest.raises(ValueError, match="style encoder"):
        port_model({**TINY, "lambda_gram": 1.0}, sd)


# float32 on the CPU, port against reference from the same state.  The two
# sum their products in other orders and the port rounds the norm sites'
# maps at other places (NHWC, the op's plain route), about 1e-6 relative
# per op; through 18 norm sites, the hinge and VGG19 that grows to some
# 1e-5 of the fake and the losses (1e-4 leaves room), and to some 1e-4 of a
# leaf's gradient norm (1e-3 leaves room).  A wrong term (a missing
# halving, the style's, an edge channel, a VGG slice's weight) moves them
# by 1e-2 or more.
FAKE_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-4, 1e-3


@pytest.mark.parametrize("cfg", [TINY, MORE], ids=["normal", "more"])
def test_generator_matches_reference(cfg):
    sd = bench_driver.weights(cfg, SEED, "cpu")
    model = port_model(cfg, sd)
    batch = Ring(tiny_cell(cfg), SEED, "cpu")[0]
    with torch.no_grad():
        seg, _, target = model.preprocess(batch)
        fake = model.generate(seg, None)
        rseg, rtarget = ref.preprocess(cfg, batch, "cpu")
        want = ref.Nets(cfg, sd).generate(rseg, False)
    assert torch.equal(seg.permute(0, 3, 1, 2), rseg)
    assert torch.allclose(target.permute(0, 3, 1, 2), rtarget, atol=1e-6)
    assert fake.shape == (2, *ref.image_hw(cfg), 3)
    gap = (fake.permute(0, 3, 1, 2) - want).abs().max()
    assert float(gap) <= FAKE_TOL * float(want.abs().max())


def test_training_iteration_matches_reference():
    """One ``train_step`` (G step with the hinge, feature-matching and VGG
    losses, D step on the regenerated fake, TTUR Adam) against the
    reference's iteration: every loss, every leaf's first gradient (Adam's
    first moment at beta1 = 0) and the buffers after it."""
    sd = bench_driver.weights(TINY, SEED, "cpu")
    model = port_model(TINY, sd)
    state = state_lib.create_state(model)
    batch = Ring(tiny_cell(TINY), SEED, "cpu")[0]
    losses, _ = steps.train_step(state, batch)
    trainer = ref.Trainer(TINY, sd)
    want, grads = trainer.step(batch, "cpu")
    got = bench_driver._totals(losses)
    for k, v in bench_driver._totals(want).items():
        assert abs(got[k] - v) <= LOSS_TOL * abs(v), (k, got[k], v)
    named = {**{("G", k): p for k, p in model.netG.named_parameters()},
             **{("D", k): p for k, p in model.netD.named_parameters()}}
    # each leaf's gap over the larger of its norm and the median leaf's, as
    # the benchmark's check reads it: a bias ahead of a batch norm has a
    # gradient of round-off alone (1e-7 against the median's 1e-2)
    gaps = {}
    for opt in (state.opt_g, state.opt_d):
        for p in (p for g in opt.param_groups for p in g["params"]):
            key = next(k for k, q in named.items() if q is p)
            gaps[key] = float((opt.state[p]["exp_avg"] - grads[key]).norm())
    sizes = {k: float(g.norm()) for k, g in grads.items()}
    median = float(np.median(list(sizes.values())))
    assert set(gaps) == set(grads) == set(named)
    worst = max(gaps, key=lambda k: gaps[k] / max(sizes[k], median))
    assert gaps[worst] <= GRAD_TOL * max(sizes[worst], median), worst
    # the buffers as the benchmark reads them: the worst float buffer's gap
    # over the larger of its norm and the median's, integer counts equal;
    # running statistics of activations 1e-4 apart (above) read 2e-4,
    # GRAD_TOL leaves room
    buffers = {f"{n}.{k}": b for n, net in (("G", model.netG),
                                            ("D", model.netD))
               for k, b in net.named_buffers()}
    want_buffers = {f"{n}.{k}": v for n in ("G", "D")
                    for k, v in sd[n].items() if f"{n}.{k}" in buffers}
    assert set(want_buffers) == set(buffers)
    assert buffer_gap(buffers, want_buffers) <= GRAD_TOL


def test_norm_sites_call_the_plain_op(monkeypatch):
    """Every GauGAN norm site goes through ``seg2eye::spade`` once per
    forward, never through K1's SPADE+Style op."""
    calls = {"spade": 0, "spade_style": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(normalization, "spade",
                        counting("spade", normalization.spade))
    monkeypatch.setattr(normalization, "spade_style",
                        counting("spade_style", normalization.spade_style))
    sd = bench_driver.weights(TINY, SEED, "cpu")
    model = port_model(TINY, sd)
    batch = Ring(tiny_cell(TINY), SEED, "cpu")[0]
    with torch.no_grad():
        model.generate(model.preprocess(batch)[0], None)
    assert calls == {"spade": 18, "spade_style": 0}


def test_edges_follow_the_one_hot_channels():
    """``Pix2Pix.preprocess``: the one-hot label map, then the edge map of
    the instance ids, in the compute dtype; no edges without
    ``instance``'s channel."""
    opt = Options(netG="spade", label_nc=3, no_instance=False,
                  compute_dtype="float32").finalize()
    model = Pix2Pix.__new__(Pix2Pix)
    model.opt, model.device, model.dtype = opt, torch.device("cpu"), \
        torch.float32
    label = np.array([[[0, 1], [2, 2]]], np.uint8)
    inst = np.array([[[5, 5], [5, 7]]], np.uint8)
    seg, style, target = model.preprocess({"label": label, "instance": inst})
    assert style is None and target is None
    assert seg.shape == (1, 2, 2, 4)
    assert torch.equal(seg[..., 3], torch.tensor([[[0., 1.], [1., 1.]]]))
    assert torch.equal(seg[..., :3].argmax(-1), torch.as_tensor(label).long())
