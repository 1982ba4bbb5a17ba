"""PyTorch port, the RefineNet system's modules against the JAX package on
the CPU: ``resize_bilinear_ac``, batch norm, the class head, DeepLab
(ResNet, Xception, DRN-D-54 and MobileNet, 1 and 4 classes, os16 and os8,
eval and train), the weight bridge and parameter counts, the port's
checkpoints back into JAX, the config, the datasets and the loader, and
the RefineNet/SegNet output dicts.  Tiny sizes: ResNet depth 14, 64x40
and 64x64 inputs, batch 2; Xception and DRN have no depth knob and run
at full depth.

Tolerances.  In eval mode the port and JAX agree in float32 to about
1e-7.  In train mode every BN normalises over few values (ResNet-14's
layer4 at os16 sees 2x4x3 = 24 per channel, the ASPP global pool's BN 2),
which amplifies float32 round-off from layer to layer: the port and JAX
then differ by up to 3e-4 at outputs of size 3, as JAX's own float32 run
differs from its float64 run by about as much.  So train mode is held in
float64 on both sides (JAX under ``jax.enable_x64``; the one float32 step,
the global pool's mean, which JAX takes in float32 also there, leaves
5e-6), to 1e-4; and in float32 within JAX's own float32-vs-float64 gap.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.data import schema
from seg2eye_tpu.models.deeplab import DeepLab as JDeepLab
from seg2eye_tpu.refinenet import config as jconfig
from seg2eye_tpu.refinenet.dataset import write_synthetic_refinenet_fixtures
from seg2eye_tpu.utils import torch_convert, torch_export
from seg2eye_tpu_torch.models.deeplab import RESNET_LAYERS, DeepLab
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-4
F64_ATOL = 1e-4
# float32 train mode: within this multiple of JAX's own float32-vs-float64
# distance (measured: at most 1.3)
GAP_RATIO = 2.0


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in
    parallel workers, and each worker's full share of OpenMP threads
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def free_disk(request):
    """A test's files go when it ends, not when the whole run does: a
    checkpoint or an export of these nets is 0.1-0.4 GB, and the suite
    would otherwise hold some 8 GB at its end.  Its ``tmp_path`` and the
    ``loops`` outputs of the module data (``fixtures``)."""
    dirs = []
    if "tmp_path" in request.fixturenames:
        dirs.append(request.getfixturevalue("tmp_path"))
    if "fixtures" in request.fixturenames:
        dirs.append(request.getfixturevalue("fixtures")[0] / "loops")
    yield
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------- helpers
def tiny_cfg(**kw) -> RefineNetConfig:
    base = dict(batch_size=2, test_batch_size=2, num_epochs=1,
                num_warmup_epochs=0, test_every_n_steps=10 ** 6,
                log_every_n_steps=2, compute_dtype="float32",
                resnet_depth=14, input_width=40, input_height=64,
                prefetch=0)
    return RefineNetConfig(**{**base, **kw})


def jax_cfg(cfg: RefineNetConfig):
    return jconfig.RefineNetConfig(**dataclasses.asdict(cfg))


def seeded_net(backbone, nc, os_=16, seed=0) -> DeepLab:
    """A port DeepLab with seeded weights and perturbed BN state, so that
    eval mode exercises the running statistics and the affine terms.
    DRN's classifier is scaled by 2^-7 (exactly, a power of two): on the
    init's running statistics its eval activations grow layer by layer to
    logits of about 166 at 64x64, where float32 rounding alone (JAX's own
    float32 against its float64) is 2e-4; scaled, the logits are about 1
    and every relative error is the same."""
    cfg = tiny_cfg(backbone=backbone, output_stride=os_)
    net = weights.init_deeplab(cfg, nc, torch.Generator().manual_seed(seed),
                               "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("running_mean", "bias")) and "last_conv.8" \
                    not in name:
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith(("running_var", ".weight")) and t.dim() == 1:
                t.mul_(1 + 0.2 * torch.rand(t.shape, generator=gen))
        if backbone == "drn":
            for t in net.decoder.last_conv[8].parameters():
                t.mul_(2.0 ** -7)
    return net


def jax_deeplab(backbone, nc, os_=16) -> JDeepLab:
    kw = dict(resnet_layers=RESNET_LAYERS[14]) if backbone == "resnet" else {}
    return JDeepLab(backbone=backbone, output_stride=os_, num_classes=nc,
                    **kw)


def to_jax(net: DeepLab, jnet: JDeepLab, backbone: str, hw=(64, 40)):
    """The port's DeepLab weights as JAX variables, through the JAX
    package's own torch_convert on a template shaped by tracing (not
    compiling) the JAX init."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    return torch_convert.convert_deeplab(sd, template, backbone)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def two_inputs(hw, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, *hw, 3)).astype(dtype)


def assert_state_close(net: DeepLab, jvariables, backbone, atol):
    """The port's running statistics (and every other tensor) against the
    JAX variables'."""
    want = torch_export.export_deeplab(jax.device_get(jvariables), backbone)
    got = net.state_dict()
    assert set(got) - {k for k in got if "num_batches" in k} <= set(want)
    worst = max(float(np.abs(got[k].double().numpy() - want[k]).max())
                for k in want if "num_batches" not in k)
    assert worst <= atol, worst


# ----------------------------------------------------------- image op
@pytest.mark.parametrize("shape,out", [
    ((2, 40, 25, 3), (160, 100)), ((1, 160, 100, 2), (640, 400)),
    ((2, 1, 1, 3), (5, 3)), ((2, 7, 1, 2), (3, 4)), ((2, 6, 5, 3), (6, 5))],
    ids=["aspp-to-decoder", "decoder-to-input", "1-pixel", "1-wide",
         "same-size"])
def test_resize_bilinear_ac_matches_jax(shape, out):
    """align_corners bilinear at the DeepLab sizes (40x25 -> 160x100,
    160x100 -> 640x400), a 1-pixel and a 1-wide input, and the same-size
    early return; float32 to 1e-6, bfloat16 computed in float32 and cast
    back as JAX does, one bfloat16 rounding apart at most."""
    from seg2eye_tpu.ops.image import resize_bilinear_ac as jresize
    from seg2eye_tpu_torch.ops.image import resize_bilinear_ac

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), *out))
    t = nchw(x)
    got = resize_bilinear_ac(t, *out)
    if out == shape[1:3]:
        assert got is t
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    want16 = np.asarray(jresize(jnp.asarray(x, jnp.bfloat16), *out),
                        np.float32)
    got16 = resize_bilinear_ac(t.to(torch.bfloat16), *out)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got16), want16, rtol=2 ** -8, atol=1e-6)


# ---------------------------------------------------------- batch norm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_torch_batchnorm(dtype):
    """layers.BatchNorm against JAX's TorchBatchNorm: a train forward
    (biased variance to normalise, unbiased into running_var, momentum
    0.1) then an eval forward on the running statistics; statistics in
    float32, the result in the input's dtype."""
    from seg2eye_tpu.models.layers import TorchBatchNorm
    from seg2eye_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 3, 4)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=4).astype(np.float32)
    bias = rng.normal(size=4).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jbn = TorchBatchNorm(use_running_average=False)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.zeros(4, np.float32),
                         "var": np.ones(4, np.float32)}}
    jx = jnp.asarray(x, jdt)
    y_train, mut = jbn.apply(v, jx, mutable=["batch_stats"])
    v = {**v, **mut}
    y_eval = TorchBatchNorm(use_running_average=True).apply(v, jx)

    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    t = nchw(x).to(tdt)
    got_train = bn(t, train=True)
    got_eval = bn(t, train=False)
    assert got_train.dtype == got_eval.dtype == tdt
    assert int(bn.num_batches_tracked) == 1
    # JAX returns float32; its call sites cast back to the compute dtype
    for got, want in ((got_train, y_train), (got_eval, y_eval)):
        want = np.asarray(jnp.asarray(want).astype(jdt), np.float32)
        np.testing.assert_allclose(nhwc(got), want, rtol=2 ** -8 if
                                   dtype == "bfloat16" else 1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]),
                               rtol=1e-6)


# ---------------------------------------------------------- class head
def test_classhead_matches_jax_with_ties_and_poisoned_labels():
    """sliced_argmax keeps the first maximal index on ties; sliced_nll
    equals JAX's and is NaN exactly where the label is 255 or -1."""
    from seg2eye_tpu.ops import classhead as jhead
    from seg2eye_tpu_torch.ops import classhead

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, 9, 4)).astype(np.float32)
    logits[0, 0, 0, :] = 1.5
    logits[1, 2, 3, 1] = logits[1, 2, 3, 3] = logits[1, 2, 3].max() + 1.0
    labels = rng.integers(0, 4, (2, 8, 9)).astype(np.int32)
    labels[0, 1, 2], labels[1, 3, 0] = 255, -1
    jnll, jarg = jhead.sliced_nll(jnp.asarray(logits), jnp.asarray(labels))
    nll, arg = classhead.sliced_nll(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    assert arg.dtype == torch.int32
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    np.testing.assert_array_equal(
        classhead.sliced_argmax(torch.from_numpy(logits)).numpy(),
        np.asarray(jhead.sliced_argmax(jnp.asarray(logits))))
    assert arg[0, 0, 0] == 0 and arg[1, 2, 3] == 1
    bad = np.zeros(labels.shape, bool)
    bad[0, 1, 2] = bad[1, 3, 0] = True
    assert np.isnan(nll.numpy()[bad]).all()
    assert np.isfinite(nll.numpy()[~bad]).all()
    np.testing.assert_allclose(nll.numpy()[~bad], np.asarray(jnll)[~bad],
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- DeepLab
DEEPLAB_CASES = [("resnet", 4, 16, (64, 40)), ("resnet", 1, 8, (64, 64)),
                 ("mobilenet", 1, 16, (64, 40)),
                 ("mobilenet", 4, 8, (64, 64)),
                 ("xception", 4, 16, (64, 40)), ("xception", 1, 8, (64, 64)),
                 ("drn", 1, 16, (64, 64))]


@pytest.mark.parametrize("backbone,nc,os_,hw", DEEPLAB_CASES,
                         ids=[f"{b}-nc{n}-os{o}" for b, n, o, _ in
                              DEEPLAB_CASES])
def test_deeplab_matches_jax(backbone, nc, os_, hw):
    """Eval forward in float32 to 1e-4; a train forward (batch
    statistics, running-statistic update) in float64 to 1e-4 and in
    float32 within JAX's own float32-vs-float64 gap, outputs and running
    statistics."""
    net = seeded_net(backbone, nc, os_)
    jnet = jax_deeplab(backbone, nc, os_)
    v32 = to_jax(net, jnet, backbone, hw)
    x = two_inputs(hw)

    want = jax.jit(jnet.apply)(v32, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(net(nchw(x))), np.asarray(want),
                               atol=F32_ATOL)

    train = jax.jit(functools.partial(jnet.apply, train=True,
                                      mutable=["batch_stats"]))
    want32, mut32 = train(v32, jnp.asarray(x))
    with jax.enable_x64(True):
        want64, mut64 = train(f64(v32), jnp.asarray(x, jnp.float64))
        want64, mut64 = np.asarray(want64), jax.device_get(mut64)
    net64 = seeded_net(backbone, nc, os_).double()
    got64 = nhwc(net64(nchw(x.astype(np.float64)), train=True))
    np.testing.assert_allclose(got64, want64, atol=F64_ATOL)
    assert_state_close(net64, {"params": v32["params"], **mut64}, backbone,
                       F64_ATOL)

    got32 = nhwc(net(nchw(x), train=True))
    gap = np.abs(np.asarray(want32) - want64).max()
    assert np.abs(got32 - np.asarray(want32)).max() <= GAP_RATIO * gap
    assert_state_close(net, {"params": v32["params"], **mut32}, backbone,
                       F32_ATOL)


def test_deeplab_bf16_within_jax_gap():
    """A bfloat16 forward (eval and train) stays bfloat16 and is no
    further from JAX's bfloat16 output than JAX's bfloat16 is from its
    float32: ResNet, and Xception and DRN (depthwise and dilated convs)
    within GAP_RATIO of that.  Two bfloat16 runs that round apart are up
    to twice as far from each other as each is from float32: over three
    inputs, ResNet's ratio is 0.91-1.65 (held at 1 on this one input, as
    before), Xception's 0.95-1.25 and DRN's 0.91-1.40."""
    for backbone, ratio in (("resnet", 1.0), ("xception", GAP_RATIO),
                            ("drn", GAP_RATIO)):
        net = seeded_net(backbone, 4)
        jnet = jax_deeplab(backbone, 4)
        v = to_jax(net, jnet, backbone)
        x = two_inputs((64, 40))
        for train in (False, True):
            fn = jax.jit(functools.partial(jnet.apply, train=train,
                                           mutable=["batch_stats"]))
            j32 = np.asarray(fn(v, jnp.asarray(x))[0])
            j16 = np.asarray(fn(v, jnp.asarray(x, jnp.bfloat16))[0],
                             np.float32)
            out = seeded_net(backbone, 4)(nchw(x).to(torch.bfloat16), train)
            assert out.dtype == torch.bfloat16
            assert np.abs(nhwc(out) - j16).max() <= \
                ratio * np.abs(j16 - j32).max(), backbone


def test_deeplab_dropout_runs_only_with_a_generator():
    """Without a generator a train forward is deterministic (as JAX's
    deterministic=rng is None); with one, its draws are the generator's."""
    net = seeded_net("mobilenet", 1)
    x = nchw(two_inputs((64, 40)))
    state = {k: v.clone() for k, v in net.state_dict().items()}

    def run(gen):
        net.load_state_dict(state)
        return net(x, True, gen)

    assert torch.equal(run(None), run(None))
    a = run(torch.Generator().manual_seed(3))
    assert torch.equal(a, run(torch.Generator().manual_seed(3)))
    assert not torch.equal(a, run(None))


PARAM_COUNTS = {"resnet": 59_339_169, "xception": 54_700_177,
                "drn": 40_731_921, "mobilenet": 5_810_913}


@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("backbone", list(PARAM_COUNTS))
def test_deeplab_param_counts(backbone, nc):
    """Parameter counts of the reference (tests/test_refinenet.py) at one
    class, and 771 more at four (the classifier's 3 x 257), on the meta
    device."""
    with torch.device("meta"):
        net = DeepLab(backbone, 16, nc)
    assert sum(p.numel() for p in net.parameters()) == \
        PARAM_COUNTS[backbone] + 257 * (nc - 1)


# ------------------------------------------------------- weight bridge
@pytest.mark.parametrize("backbone", ["resnet", "mobilenet", "xception",
                                      "drn"])
def test_export_deeplab_bit_for_bit(backbone):
    """The port's export_deeplab equals the JAX package's: keys, dtypes,
    shapes and bytes, at full depth and on unique values; the result
    strict-loads into the port's DeepLab, MobileNet's
    low/high_level_features aliases included."""
    jnet = JDeepLab(backbone=backbone, num_classes=4)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    start = np.cumsum([0] + [int(np.prod(s.shape)) for s in leaves])
    variables = jax.tree_util.tree_unflatten(tree, [
        (np.arange(n, n + int(np.prod(s.shape))) * 1e-7).astype(
            np.float32).reshape(s.shape) for n, s in zip(start, leaves)])
    got = weights.export_deeplab(variables, backbone)
    want = torch_export.export_deeplab(variables, backbone)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    net = DeepLab(backbone, 16, 4)
    net.load_state_dict(weights.deeplab_from_jax_variables(variables,
                                                           backbone),
                        strict=True)
    if backbone == "mobilenet":
        assert net.backbone.low_level_features[3] is net.backbone.features[3]
        assert any(k.startswith("backbone.high_level_features.4.")
                   for k in net.state_dict())


def test_load_pretrained_backbone(tmp_path):
    """A ResNet state_dict under the reference's names (written here from
    a seeded net's backbone) loads into backbone.*; a stray or a missing
    key raises."""
    from seg2eye_tpu_torch.refinenet.model import load_pretrained_backbone

    src = seeded_net("resnet", 1, seed=5).backbone.state_dict()
    path = str(tmp_path / "resnet.pth")
    torch.save(src, path)
    net = load_pretrained_backbone(seeded_net("resnet", 1), path)
    for k, v in src.items():
        assert torch.equal(net.backbone.state_dict()[k], v), k
    torch.save({**src, "fc.weight": torch.zeros(3)}, path)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_pretrained_backbone(seeded_net("resnet", 1), path)
    torch.save({k: v for k, v in src.items() if k != "bn1.weight"}, path)
    with pytest.raises(RuntimeError, match="Missing"):
        load_pretrained_backbone(seeded_net("resnet", 1), path)


@pytest.mark.parametrize("backbone", ["xception", "drn"])
def test_pretrained_extra_backbone(backbone, tmp_path):
    """The port's export_{xception,drn}_backbone equal the JAX package's
    bit for bit, on unique values; their state_dict, saved as a .pth,
    is what a configuration's ``pretrained_backbone`` loads into
    backbone.* at init."""
    from seg2eye_tpu.models.backbones_extra import (DRNBackbone,
                                                    XceptionBackbone)
    from seg2eye_tpu_torch.refinenet.model import SegNetModel

    jnet = XceptionBackbone() if backbone == "xception" else DRNBackbone()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_unflatten(tree, [
        rng.normal(size=s.shape).astype(np.float32) for s in leaves])
    export = getattr(weights, f"export_{backbone}_backbone")
    got = export(variables)
    want = getattr(torch_export, f"export_{backbone}_backbone")(variables)
    assert list(got) == list(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    path = str(tmp_path / f"{backbone}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in got.items()}, path)
    m = SegNetModel(tiny_cfg(backbone=backbone, pretrained_backbone=path),
                    "cpu").init(torch.Generator().manual_seed(0))
    sd = m.net.backbone.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert np.array_equal(sd[k].numpy(), v), k


@pytest.mark.parametrize("backbone", ["resnet", "xception", "drn",
                                      "mobilenet"])
def test_port_checkpoint_loads_into_jax(backbone, tmp_path):
    """A port checkpoint (``CheckpointManager``, after one train step)
    goes back to JAX: its DeepLab state_dict, as numpy, through the JAX
    package's ``torch_convert.convert_deeplab``; the JAX forward on the
    result equals the port's in float32 to F32_ATOL."""
    from seg2eye_tpu_torch.refinenet import model, training
    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager

    cfg = tiny_cfg(backbone=backbone, resnet_depth=14)
    m = model.SegNetModel(cfg, "cpu")
    trainer = training.Trainer(m, cfg, "ce_loss", 0.9)
    state = trainer.init_state(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, 64, 40, 1),
                                                    dtype=np.uint8)),
             "target": torch.from_numpy(rng.integers(0, 4, (2, 64, 40),
                                                     dtype=np.uint8))}
    trainer.train_step(state, batch, 1e-3)
    path = CheckpointManager(str(tmp_path)).save_at_step(1, state)
    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    jnet = jax_deeplab(backbone, 4)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 40, 3)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    v = torch_convert.convert_deeplab({k: t.numpy() for k, t in sd.items()},
                                      template, backbone)
    x = two_inputs((64, 40), seed=4)
    want = jax.jit(jnet.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(m.net(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL)


# -------------------------------------------------------------- config
def test_config_mirrors_jax(tmp_path):
    """Field for field: names, types, defaults, learning_rate; from_json
    overlays in order and refuses unknown keys; from_args over the repo's
    JSON files; full_json; the identifier's md5."""
    got = dataclasses.fields(RefineNetConfig)
    want = dataclasses.fields(jconfig.RefineNetConfig)
    assert [(f.name, f.type, f.default) for f in got] == \
        [(f.name, f.type, f.default) for f in want]
    assert RefineNetConfig().learning_rate == \
        jconfig.RefineNetConfig().learning_rate
    overlays = [os.path.join(REPO, "refinenet", "configs", f)
                for f in ("refinenet.json", "segnet.json")]
    argv = [*overlays, "--batch_size", "3", "--device_normalize",
            "--compute_dtype", "float32", "--lr_decay_factor", "0.25"]
    a, b = RefineNetConfig.from_args(argv), \
        jconfig.RefineNetConfig.from_args(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.full_json() == b.full_json()
    assert a.learning_rate == b.learning_rate
    assert a.identifier("X").split(".")[-1] == b.identifier("X").split(".")[-1]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no_such_key": 1}))
    with pytest.raises(ValueError, match="no_such_key"):
        RefineNetConfig.from_json(overlays[0], str(bad))


# ------------------------------------------------- datasets and loader
@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("refinenet_data")
    data = schema.write_synthetic_h5(str(d / "data.h5"), h=64, w=40)
    paths = write_synthetic_refinenet_fixtures(str(d), data)
    return d, tiny_cfg(dataroot=data, output_dir_base=str(d / "out"),
                       **paths)


def assert_same_item(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, k


def dataset_pairs(cfg):
    """(port dataset, JAX dataset) of every kind, uint8 and float32."""
    from seg2eye_tpu.refinenet import dataset as jds
    from seg2eye_tpu.refinenet import segnet_dataset as jsds
    from seg2eye_tpu_torch.refinenet import dataset as ds
    from seg2eye_tpu_torch.refinenet import segnet_dataset as sds

    for c in (cfg, cfg.replace(device_normalize=False)):
        jc = jax_cfg(c)
        yield ds.RefineNetDataset(c, "train"), jds.RefineNetDataset(jc,
                                                                    "train")
        yield (ds.RefineNetDataset(c, "validation", pick1=True),
               jds.RefineNetDataset(jc, "validation", pick1=True))
        yield (ds.RefineNetDataset(c, "test", pick1=True),
               jds.RefineNetDataset(jc, "test", pick1=True))
        yield sds.SegNetDataset(c, "train"), jsds.SegNetDataset(jc, "train")
        yield (sds.SegNetEvalDataset(c, "validation", "images_seq"),
               jsds.SegNetEvalDataset(jc, "validation", "images_seq"))


def test_datasets_match_jax_byte_for_byte(fixtures):
    """RefineNetDataset (train with random neighbours, validation and test
    with the top-1), SegNetDataset and SegNetEvalDataset give the JAX
    package's samples, uint8 and float32 transport; U111 is left out of
    train; a sequence neighbour without the sequence map is the JAX
    package's error; colorize_segmap is the same."""
    from seg2eye_tpu.refinenet.dataset import colorize_segmap as jcolor
    from seg2eye_tpu_torch.refinenet import dataset as ds

    _, cfg = fixtures
    for mine, theirs in dataset_pairs(cfg):
        assert mine.idx_to_kv == theirs.idx_to_kv and len(mine) > 0
        for i in range(len(mine)):
            for seed in range(2):
                assert_same_item(
                    mine.__getitem__(i, rng=np.random.default_rng(seed)),
                    theirs.__getitem__(i, rng=np.random.default_rng(seed)))
    seg = np.random.default_rng(0).integers(0, 4, (5, 7)).astype(np.uint8)
    assert ds.colorize_segmap(seg).tobytes() == jcolor(seg).tobytes()
    no_seq = ds.RefineNetDataset(cfg.replace(segmentations_sequence=""),
                                 "train")
    with pytest.raises(ValueError, match="segmentations_sequence"):
        for i in range(len(no_seq)):
            for s in range(8):
                no_seq.__getitem__(i, rng=np.random.default_rng(s))


def test_refinenet_train_split_drops_u111(tmp_path):
    from seg2eye_tpu_torch.refinenet.dataset import RefineNetDataset

    data = schema.write_synthetic_h5(str(tmp_path / "d.h5"),
                                     users=("U001", "U111"), h=32, w=32)
    paths = write_synthetic_refinenet_fixtures(str(tmp_path), data)
    cfg = tiny_cfg(dataroot=data, input_width=32, input_height=32, **paths)
    assert all(p != "U111" for p, _ in RefineNetDataset(cfg, "train")
               .idx_to_kv)
    assert any(p == "U111" for p, _ in RefineNetDataset(cfg, "validation")
               .idx_to_kv)


def test_loader_and_subsample_match_jax(fixtures):
    """subsample (seeded choice, sorted indices) and DataLoader batches
    over a RefineNet dataset, shuffled over two epochs, with a tail batch,
    byte for byte against the JAX package's."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.refinenet import dataset as jds
    from seg2eye_tpu_torch.data import openeds
    from seg2eye_tpu_torch.refinenet import dataset as ds

    _, cfg = fixtures
    sub = openeds.subsample(ds.RefineNetDataset(cfg, "validation"), 5, 3)
    jsub = jloader.subsample(jds.RefineNetDataset(jax_cfg(cfg),
                                                  "validation"), 5, 3)
    np.testing.assert_array_equal(sub.indices, jsub.indices)
    assert openeds.subsample(sub, 10) is sub and openeds.subsample(sub, 0) \
        is sub
    for shuffle, drop_last in ((True, True), (False, False)):
        mine = openeds.DataLoader(sub, 2, shuffle, drop_last, seed=4,
                                  prefetch=1)
        theirs = jloader.DataLoader(jsub, 2, shuffle, drop_last, seed=4,
                                    prefetch=0)
        assert len(mine) == len(theirs)
        for _ in range(2):
            got, want = list(mine), list(theirs)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert_same_item(g, w)


# ------------------------------------------------------- model outputs
@pytest.mark.parametrize("kind", ["refinenet", "segnet"])
def test_model_outputs_match_jax(fixtures, kind):
    """RefineNetModel/SegNetModel.forward against the JAX package's on a
    loader batch (uint8 transport), eval and train (no dropout), and
    without a target; every output key, float32."""
    from seg2eye_tpu.refinenet import model as jmodel
    from seg2eye_tpu_torch.data import openeds
    from seg2eye_tpu_torch.refinenet import dataset as ds
    from seg2eye_tpu_torch.refinenet import model
    from seg2eye_tpu_torch.refinenet import segnet_dataset as sds

    _, cfg = fixtures
    if kind == "refinenet":
        m, jm = model.RefineNetModel(cfg, "cpu"), jmodel.RefineNetModel(
            jax_cfg(cfg))
        data = ds.RefineNetDataset(cfg, "train")
    else:
        m, jm = model.SegNetModel(cfg, "cpu"), jmodel.SegNetModel(
            jax_cfg(cfg))
        data = sds.SegNetDataset(cfg, "train")
    m.init(torch.Generator().manual_seed(0))
    v = to_jax(m.net, jm.net, "resnet")
    batch = next(iter(openeds.DataLoader(data, 2, seed=1)))
    assert batch["input"].dtype == np.uint8
    arrays = {k: batch[k] for k in ("input", "target")}
    for train in (False, True):
        for keys in (("input", "target"), ("input",)):
            b = {k: arrays[k] for k in keys}
            want, _ = jax.jit(functools.partial(jm.forward, train=train))(
                v, jax.tree_util.tree_map(jnp.asarray, b))
            state = {k: t.clone() for k, t in m.net.state_dict().items()}
            got = m.forward(openeds.to_device(b, torch.device("cpu"), keys),
                            train=train)
            m.net.load_state_dict(state)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                g = got[k].detach()
                w = np.asarray(w)
                assert tuple(g.shape) == w.shape, k
                if w.dtype.kind in "iu":
                    # argmax of logits that agree to 1e-6
                    assert (g.numpy() != w).mean() < 1e-3, k
                else:
                    tol = F32_ATOL * (1 + (np.abs(w).max() if train else 0))
                    if k in ("score", "per_image_score"):
                        tol = 1e-4 * np.abs(w).max()
                    np.testing.assert_allclose(g.float().numpy(), w,
                                               atol=tol, err_msg=k)


# ------------------------------------------------------------- imports
def test_port_imports_without_h5py_cv2_pil():
    """Every module of the port imports with h5py, cv2 and PIL blocked, as
    on the card's machine, which has none of them."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil\n"
        "import seg2eye_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'seg2eye_tpu_torch.refinenet.training' in names\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 25
