"""PyTorch port, serving export: the port's ``torch.export`` artifacts
(``seg2eye_tpu_torch.serving``) against the JAX package's ``jax.export``
artifacts on the same weights (through the weight bridges
``utils.weights.from_jax_variables`` and ``deeplab_from_jax_variables``)
and seeded numpy inputs, mirroring every test of ``tests/test_serving.py``;
then what only the port has: the ``seg2eye::spade_style`` op under
``torch.library.opcheck``, the op in the exported graph, repeatable calls,
refusals (per-sample encoding, a foreign device) and the two CLIs.

Tolerances.  float32: ``fake`` within 1e-5 of JAX's artifact, ``fake_255``
within one truncated-integer step (a 1e-7 drift can cross an integer); the
port's artifact and its live model run the same ATen ops and agree
exactly.  bfloat16: within ``test_torch_slice.BF16_ATOL``, the port's
measured bfloat16 bound against JAX at this config.  RefineNet's
prediction within 1e-5; SegNet's class ids equal but at a near tie of the
logits, where float32 round-off decides (at most 1e-3 of the pixels, as
``test_torch_refinenet`` holds the live models)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.options import Options as JOptions
from seg2eye_tpu.serving import export_inference as jexport_inference
from seg2eye_tpu.serving import export_refiner as jexport_refiner
from seg2eye_tpu.serving import load_serving as jload_serving
from seg2eye_tpu_torch.models.normalization import SpadeStyleBlock
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.ops.image import to_255resized
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.serving import (FORMAT_VERSION, export_inference,
                                       export_refiner, load_serving)
from seg2eye_tpu_torch.utils.weights import (deeplab_from_jax_variables,
                                             from_jax_variables)
from test_torch_refinenet import free_disk  # noqa: F401
from test_torch_slice import BF16_ATOL, bf16_exact

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
NATIVE_HW = (64, 40)
SEGNET_FLIPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (the suite runs in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_opt(cls=Options, **kw):
    base = dict(ngf=4, ndf=4, crop_size=32, aspect_ratio=1.0, batchSize=2,
                input_ns=2, w_dim=8, compute_dtype="float32", isTrain=False)
    return cls(**{**base, **kw}).finalize()


def with_running_stats(variables, seed=0):
    """The generator's running statistics drawn away from (0, 1), so that
    an artifact on running statistics reads them."""
    rng = np.random.default_rng(seed)
    bs = jax.tree_util.tree_map(np.asarray, variables["G"]["batch_stats"])
    for blk in bs.values():
        for norm in blk.values():
            norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(
                np.float32)
            norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(
                np.float32)
    return {**variables, "G": {**variables["G"], "batch_stats": bs}}


def jax_variables(dtype="float32"):
    opt = small_opt(JOptions, compute_dtype=dtype)
    v = JPix2Pix(opt).init_variables(jax.random.PRNGKey(0), with_disc=False)
    return with_running_stats(jax.device_get(v))


def port_model(opt, variables):
    nets = build_networks(opt)
    for name, sd in from_jax_variables(variables).items():
        nets[name].load_state_dict(sd, strict=True)
    return Pix2Pix(opt, nets, "cpu")


def batch_of(opt, bs, seed=0):
    rng = np.random.default_rng(seed)
    h, w = opt.image_height, opt.image_width
    label = rng.integers(0, opt.semantic_nc, (bs, h, w)).astype(np.uint8)
    style = rng.integers(0, 256, (bs, opt.input_ns, h, w, 1)).astype(
        np.uint8)
    return label, style


def live(model, label, style):
    fake = model.inference({"label": label, "style_image": style})
    return fake, to_255resized(fake, w=NATIVE_HW[1], h=NATIVE_HW[0])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One JAX artifact and the port's artifact of the same weights
    (batch statistics, as the JAX test's), float32."""
    variables = jax_variables()
    root = tmp_path_factory.mktemp("serving")
    jdir, pdir = str(root / "jax"), str(root / "port")
    jexport_inference(JPix2Pix(small_opt(JOptions)), variables, jdir,
                      native_hw=NATIVE_HW, platforms=("cpu",))
    opt = small_opt()
    model = port_model(opt, variables)
    program = export_inference(model, pdir, native_hw=NATIVE_HW)
    return dict(jax=jload_serving(jdir), port=load_serving(pdir),
                port_dir=pdir, model=model, opt=opt, program=program,
                variables=variables)


def assert_fake_255(f255, bs):
    assert f255.shape == (bs, *NATIVE_HW, 1)
    assert f255.dtype == torch.float32
    torch.testing.assert_close(f255, torch.trunc(f255), rtol=0, atol=0)
    assert f255.min() >= 0 and f255.max() <= 255


def test_roundtrip_matches_jax_artifact(artifacts):
    """The port's artifact against the JAX package's artifact and against
    its own live model (inference + the score epilogue), at the export
    batch."""
    opt = artifacts["opt"]
    label, style = batch_of(opt, 2)
    fake, f255 = artifacts["port"](label, style)
    jfake, jf255 = artifacts["jax"](label, style)
    np.testing.assert_allclose(fake.numpy(), jfake, atol=ATOL, rtol=0)
    assert np.abs(f255.numpy() - jf255).max() <= 1
    assert_fake_255(f255, 2)
    lfake, lf255 = live(artifacts["model"], label, style)
    torch.testing.assert_close(fake, lfake, rtol=0, atol=0)
    torch.testing.assert_close(f255, lf255, rtol=0, atol=0)


@pytest.mark.parametrize("bs", [1, 5])
def test_batch_polymorphism(artifacts, bs):
    """One artifact, exported at batch 2, serves batches 1 and 5."""
    label, style = batch_of(artifacts["opt"], bs, seed=bs)
    fake, f255 = artifacts["port"](label, style)
    jfake, _ = artifacts["jax"](label, style)
    np.testing.assert_allclose(fake.numpy(), jfake, atol=ATOL, rtol=0)
    torch.testing.assert_close(fake, live(artifacts["model"], label,
                                          style)[0], rtol=0, atol=0)
    assert_fake_255(f255, bs)


def test_meta_spec(artifacts):
    """meta.json has the JAX artifact's fields, with the torch version and
    the export device in place of jax_version and platforms."""
    meta, jmeta = artifacts["port"].meta, artifacts["jax"].meta
    assert meta["format_version"] == FORMAT_VERSION
    assert meta["inputs"]["label"]["dtype"] == "uint8"
    assert meta["baked_options"]["w_dim"] == artifacts["opt"].w_dim
    assert meta["native_hw"] == [64, 40]
    assert meta["torch_version"] == torch.__version__
    assert meta["device"] == "cpu"
    assert set(meta) - {"torch_version", "device"} == \
        set(jmeta) - {"jax_version", "platforms"}
    assert meta["inputs"] == jmeta["inputs"]
    assert meta["outputs"] == jmeta["outputs"]
    assert meta["baked_options"] == jmeta["baked_options"]


BLOCKED_LOAD = r"""
import importlib.abc, sys
BLOCKED = ("seg2eye_tpu_torch.models", "seg2eye_tpu_torch.refinenet",
           "seg2eye_tpu_torch.options", "seg2eye_tpu", "jax", "flax")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np, torch
from seg2eye_tpu_torch.serving import load_serving
art, out = sys.argv[1], sys.argv[2]
served = load_serving(art)
rng = np.random.default_rng(9)
label = rng.integers(0, 4, (3, 32, 32)).astype(np.uint8)
style = rng.integers(0, 256, (3, 2, 32, 32, 1)).astype(np.uint8)
fake, f255 = served(label, style)
loaded = sorted(filter(blocked, sys.modules))
torch.save({"fake": fake, "fake_255": f255, "loaded": loaded}, out)
"""


def test_no_model_code_needed(artifacts, tmp_path):
    """A process whose imports of the model modules (models, refinenet,
    options) and of JAX raise loads and runs the artifact, and gets what
    the artifact gives in this process."""
    out = str(tmp_path / "out.pt")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_LOAD, artifacts["port_dir"], out],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(out)
    assert got["loaded"] == []
    rng = np.random.default_rng(9)
    label = rng.integers(0, 4, (3, 32, 32)).astype(np.uint8)
    style = rng.integers(0, 256, (3, 2, 32, 32, 1)).astype(np.uint8)
    fake, f255 = artifacts["port"](label, style)
    assert got["fake"].shape == (3, 32, 32, 1)
    torch.testing.assert_close(got["fake"], fake, rtol=0, atol=0)
    torch.testing.assert_close(got["fake_255"], f255, rtol=0, atol=0)


def test_running_stats_bundle_is_batch_composition_invariant(tmp_path):
    """On running statistics (``--stats running``) sample i's output does
    not depend on its batch neighbours; on batch statistics (the reference
    Tester's) it does.  Both bundles from the same weights, each equal to
    the live model in that mode."""
    variables = jax_variables()
    opt = small_opt()
    label, style = batch_of(opt, 3, seed=7)
    bundles = {}
    for stats in ("running", "batch"):
        sopt = small_opt(eval_use_running_stats=stats == "running")
        model = port_model(sopt, variables)
        out = str(tmp_path / f"art_{stats}")
        export_inference(model, out, native_hw=NATIVE_HW)
        served = load_serving(out)
        assert served.meta["baked_options"]["eval_use_running_stats"] == \
            (stats == "running")
        bundles[stats] = served
        torch.testing.assert_close(served(label, style)[0],
                                   live(model, label, style)[0], rtol=0,
                                   atol=0)
    for stats, served in bundles.items():
        full, _ = served(label, style)
        solo0, _ = served(label[:1], style[:1])
        row_drift = float((full[0] - solo0[0]).abs().max())
        if stats == "running":
            assert row_drift < 1e-5, row_drift
        else:
            assert row_drift > 1e-3, row_drift
    f_run, _ = bundles["running"](label, style)
    f_bat, _ = bundles["batch"](label, style)
    assert float((f_run - f_bat).abs().max()) > 1e-3


def output_shapes(program):
    out = next(n for n in program.graph.nodes if n.op == "output")
    return [tuple(a.meta["val"].shape) for a in out.args[0]]


def test_default_native_orientation(tmp_path):
    """The default export bakes OpenEDS's native size in the orientation
    the Tester scores at: H=640, W=400."""
    opt = small_opt()
    nets = build_networks(opt)
    model = Pix2Pix(opt, nets, "cpu")
    program = export_inference(model, str(tmp_path / "art"))
    assert output_shapes(program)[1][1:] == (640, 400, 1)
    label, style = batch_of(opt, 1)
    assert load_serving(str(tmp_path / "art"))(label, style)[1].shape == \
        (1, 640, 400, 1)


# ---------------------------------------------------------------- refiner
def tiny_rn_cfg(cls, **kw):
    return cls(**{**dict(compute_dtype="float32", resnet_depth=14,
                         input_width=40, input_height=64), **kw})


def refiner_pair(kind, tmp_path, seed, classifier_scale=1.0, **cfg):
    """JAX and port artifacts of one seeded task model (ResNet-14, 64x40,
    unless ``cfg`` says otherwise), its running statistics drawn away from
    (0, 1) and its classifier scaled by ``classifier_scale``; and the
    port's live model."""
    from seg2eye_tpu.refinenet import config as jconfig
    from seg2eye_tpu.refinenet import model as jmodel
    from seg2eye_tpu_torch.refinenet import config, model

    name = {"refinenet": "RefineNetModel", "segnet": "SegNetModel"}[kind]
    jm = getattr(jmodel, name)(tiny_rn_cfg(jconfig.RefineNetConfig, **cfg))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.min() == 1.0
                   else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for k in ("kernel", "bias"):
        params["decoder"]["classifier"][k] = (
            params["decoder"]["classifier"][k] * classifier_scale)
    variables = {"params": params, "batch_stats": stats}
    jexport_refiner(jm, variables, str(tmp_path / "jax"), platforms=("cpu",))
    m = getattr(model, name)(tiny_rn_cfg(config.RefineNetConfig, **cfg),
                             "cpu")
    m.init(torch.Generator().manual_seed(0))
    m.net.load_state_dict(
        deeplab_from_jax_variables(variables, m.cfg.backbone), strict=True)
    export_refiner(m, str(tmp_path / "port"))
    return (jload_serving(str(tmp_path / "jax")),
            load_serving(str(tmp_path / "port")), m)


def test_refinenet_export_roundtrip(tmp_path):
    """RefineNet artifact against JAX's artifact and the live eval forward,
    the submission uint8 included; batch-polymorphic."""
    jserved, served, m = refiner_pair("refinenet", tmp_path, 0)
    assert served.meta["model_type"] == "refinenet"
    assert served.meta["baked_config"]["resnet_depth"] == 14
    assert served.meta["outputs"] == jserved.meta["outputs"]
    rng = np.random.default_rng(0)
    for bs in (1, 3):
        x = rng.integers(0, 256, (bs, 64, 40, 3)).astype(np.uint8)
        pred, pred_u8 = served(x)
        jpred, jpred_u8 = jserved(x)
        np.testing.assert_allclose(pred.numpy(), jpred, atol=ATOL, rtol=0)
        assert pred_u8.dtype == torch.uint8 and pred_u8.shape == (bs, 64, 40)
        assert np.abs(pred_u8.numpy().astype(np.int32)
                      - jpred_u8.astype(np.int32)).max() <= 1
        want = m.forward({"input": torch.from_numpy(x)})["prediction"]
        torch.testing.assert_close(pred, want, rtol=0, atol=0)
        want_u8 = torch.clamp((want + 1.0) * 255.0 / 2.0, 0, 255).to(
            torch.uint8)[..., 0]
        torch.testing.assert_close(pred_u8, want_u8, rtol=0, atol=0)


@pytest.mark.parametrize("backbone", ["xception", "drn"])
def test_refinenet_export_extra_backbones(backbone, tmp_path):
    """A RefineNet artifact with the Xception or DRN backbone (full depth,
    64x40) against the JAX package's artifact of the same weights, float32
    within 1e-5, and against the live eval forward exactly; the baked
    configuration records the backbone and the configured output stride
    (DRN's model forces 8 by itself).  DRN's classifier is scaled by 2^-7,
    so that its residual leaves most of the prediction unclamped (at the
    JAX init on these running statistics 2% of it is inside (-1, 1))."""
    jserved, served, m = refiner_pair(
        "refinenet", tmp_path, 2, 2.0 ** -7 if backbone == "drn" else 1.0,
        backbone=backbone)
    baked = served.meta["baked_config"]
    assert baked["backbone"] == backbone and baked["output_stride"] == 16
    assert baked == {**jserved.meta["baked_config"],
                     "compute_dtype": "float32"}
    x = np.random.default_rng(2).integers(0, 256, (2, 64, 40, 3)).astype(
        np.uint8)
    pred, _ = served(x)
    want = m.forward({"input": torch.from_numpy(x)})["prediction"]
    torch.testing.assert_close(pred, want, rtol=0, atol=0)
    inside = float((pred.abs() < 1).float().mean())
    assert inside > 0.5, inside
    np.testing.assert_allclose(pred.numpy(), jserved(x)[0], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refinenet_program_keeps_float32_dilated_convs_nchw(dtype, tmp_path):
    """The float32 dilated-conv rule of ``models/layers.apply_conv`` (an NCHW
    copy of the channels_last input, which cuDNN runs far faster on the
    card) is in the exported program: each float32 dilated conv reads an
    NCHW clone, whatever layout the trace gave its input (on CUDA the
    traced convolutions come out NCHW where the card's are channels_last,
    so a ``contiguous()`` would be left out); bfloat16 has no such copy.
    The program's compute dtype is the model's."""
    from seg2eye_tpu_torch.refinenet import config, model

    cfg = tiny_rn_cfg(config.RefineNetConfig, compute_dtype=dtype)
    m = model.RefineNetModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    program = export_refiner(m, str(tmp_path / "art"))
    convs = [n for n in program.graph.nodes
             if n.target is torch.ops.aten.conv2d.default]
    dilated = [n for n in convs
               if len(n.args) > 5 and tuple(n.args[5]) != (1, 1)]
    assert len(dilated) == 6          # layer4's 3 blocks, 3 ASPP branches
    copied = [n.args[0].target is torch.ops.aten.clone.default and
              n.args[0].kwargs.get("memory_format") == torch.contiguous_format
              for n in dilated]
    assert copied == [dtype == "float32"] * 6
    meta = json.load(open(tmp_path / "art" / "meta.json"))
    assert meta["baked_config"]["compute_dtype"] == dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_program_copies_dilated_depthwise_convs_nchw(dtype, tmp_path):
    """``models/layers.nchw_copy``'s depthwise part in the exported
    program: the dilated depthwise conv (MobileNet's last stage, dilation 2
    at os16) reads an NCHW clone in both dtypes, the 16 undilated ones
    read their input as it is."""
    from seg2eye_tpu_torch.refinenet import config, model

    cfg = tiny_rn_cfg(config.RefineNetConfig, compute_dtype=dtype,
                      backbone="mobilenet")
    m = model.RefineNetModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    program = export_refiner(m, str(tmp_path / "art"))
    depthwise = [n for n in program.graph.nodes
                 if n.target is torch.ops.aten.conv2d.default
                 and len(n.args) > 6 and n.args[6] > 1]
    dilated = [len(n.args) > 5 and tuple(n.args[5]) != (1, 1)
               for n in depthwise]
    copied = [n.args[0].target is torch.ops.aten.clone.default
              for n in depthwise]
    assert sum(dilated) == 1 and len(depthwise) == 17
    assert copied == dilated


def test_segnet_export_roundtrip(tmp_path):
    """SegNet artifact: the live model's class map exactly, JAX's but at
    near ties."""
    jserved, served, m = refiner_pair("segnet", tmp_path, 1)
    assert served.meta["model_type"] == "segnet"
    x = np.random.default_rng(1).integers(0, 256, (2, 64, 40, 1)).astype(
        np.uint8)
    pred = served(x)
    assert pred.dtype == torch.uint8 and pred.shape == (2, 64, 40)
    assert (pred.numpy() != jserved(x)).mean() <= SEGNET_FLIPS
    want = m.forward({"input": torch.from_numpy(x)})["prediction"]
    torch.testing.assert_close(pred, want.to(torch.uint8), rtol=0, atol=0)


# ------------------------------------------------------- the port's own
def site_args(dtype, n=2, h=5, w=4, c=8, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    x = r(n, h, w, c).to(dtype)
    seg = torch.nn.functional.one_hot(
        torch.randint(0, 4, (n, h, w), generator=gen), 4).float()
    var, mean = torch.var_mean(x.float(), dim=(0, 1, 2), correction=0)
    return [x, seg, r(n, 2 * c) * 0.1, mean.expand(n, c), var.expand(n, c),
            r(128, 4, 3, 3) * 0.1, r(128) * 0.1, r(c, 128, 3, 3) * 0.1,
            r(c) * 0.1, r(c, 128, 3, 3) * 0.1, r(c) * 0.1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_passes_opcheck(dtype):
    """``seg2eye::spade_style`` under ``torch.library.opcheck``: schema,
    fake tensor (shape, dtype and strides of the real output), autograd
    registration and AOT dispatch with a dynamic batch.  Its kernels are
    the CPU's (the plain version) and CUDA's; no other backend and no
    composite fallback."""
    args = [a.requires_grad_(a.is_floating_point() and i in (0, 2, 7))
            for i, a in enumerate(site_args(dtype))]
    result = torch.library.opcheck(K.spade_style_op, (*args, K.EPS))
    assert set(result.values()) == {"SUCCESS"}, result
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    name = "seg2eye::spade_style"
    assert has(name, "CPU") and has(name, "CUDA")
    assert not has(name, "CompositeImplicitAutograd")
    assert not has(name, "CompositeExplicitAutograd")
    out = K.spade_style(*site_args(dtype))
    assert out.is_contiguous() and out.dtype == dtype


def test_op_gradient_is_the_plain_versions():
    """The op's backward (the plain version's autograd, recomputed) gives
    the plain version's gradients."""
    grads = []
    for fn in (K.spade_style, K.spade_style_reference):
        leaves = [a.detach().clone().requires_grad_(i in (0, 2, 7, 10))
                  for i, a in enumerate(site_args(torch.float32))]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([leaves[i].grad for i in (0, 2, 7, 10)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_kernel_packs_once_per_weight_set(monkeypatch):
    """The op's CUDA registration packs the weights through the shared
    cache (behind the op boundary, where the weights are real tensors):
    once for a weight set, again only after a weight changes.  The launch
    itself is replaced by its plain version to run here."""
    def fake_launch(x, actv, style, mean, var, wcat, bcat, eps=K.EPS):
        return torch.empty_like(x)

    monkeypatch.setattr(K, "spade_style_cuda", fake_launch)
    monkeypatch.setattr(K.packed_weights, "packings", 0)
    args = site_args(torch.float32)
    for _ in range(3):
        K._kernel(*args, K.EPS)
    assert K.packed_weights.packings == 1
    with torch.no_grad():
        args[7].mul_(2.0)
    K._kernel(*args, K.EPS)
    K._kernel(*args, K.EPS)
    assert K.packed_weights.packings == 2


def test_graph_holds_one_op_per_norm_site(artifacts):
    """The exported program calls the op once per norm site (18 at the
    'normal' config), writes no buffer, and keeps none of export's
    per-``.to`` metadata checks (``ServingModel`` checks the inputs)."""
    program = artifacts["program"]
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    sites = [m for m in artifacts["model"].netG.modules()
             if isinstance(m, SpadeStyleBlock)]
    assert targets.count(torch.ops.seg2eye.spade_style.default) == \
        len(sites) == 18
    assert torch.ops.aten._assert_tensor_metadata.default not in targets
    assert not program.graph_signature.buffers_to_mutate
    assert output_shapes(program)[0][1:] == (32, 32, 1)


def test_serving_model_checks_input_dtypes(artifacts):
    """An input of another dtype than meta.json declares is refused (a
    float style image in [0, 255] would otherwise skip the uint8
    normalisation), as is a wrong number of inputs."""
    served = artifacts["port"]
    label, style = batch_of(artifacts["opt"], 2)
    with pytest.raises(ValueError, match="style_image is torch.float32"):
        served(label, style.astype(np.float32))
    with pytest.raises(ValueError, match="label is torch.int64"):
        served(label.astype(np.int64), style)
    with pytest.raises(ValueError, match="takes 2 inputs"):
        served(label)


def test_two_calls_are_bitwise_equal_and_write_nothing(artifacts):
    served = artifacts["port"]
    before = [w.clone() for w in served.weights]
    label, style = batch_of(artifacts["opt"], 4, seed=3)
    first = served(label, style)
    second = served(label, style)
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(served.weights) == len(before) > 0
    assert all(torch.equal(a, b) for a, b in zip(served.weights, before))


@pytest.mark.parametrize("options", [
    dict(norm_E="spectralbatch"), dict(per_sample_encode="on")],
    ids=["spectralbatch-auto", "per-sample-on"])
def test_per_sample_encoding_refuses_export(options, tmp_path):
    """Per-sample encoding runs the encoder once per sample, which a
    symbolic batch cannot unroll: the port refuses at export, with a clear
    error and no artifact.  The JAX package's export fails on it too, on a
    symbolic comparison of the batch (checked with ``--per_sample_encode
    on``, the faster of the two to trace)."""
    opt = small_opt(**options)
    assert opt.per_sample_encode_enabled
    model = Pix2Pix(opt, build_networks(opt), "cpu")
    with pytest.raises(ValueError, match="per-sample encoding"):
        export_inference(model, str(tmp_path / "art"))
    assert not os.path.exists(tmp_path / "art")
    if options.get("per_sample_encode") == "on":
        jm = JPix2Pix(small_opt(JOptions, **options))
        variables = jm.init_variables(jax.random.PRNGKey(0), with_disc=False)
        with pytest.raises(Exception, match="inconclusive"):
            jexport_inference(jm, variables, str(tmp_path / "jax"),
                              platforms=("cpu",))


def test_serving_model_refuses_another_device(artifacts):
    """An artifact runs on its export device only: asking for another
    device, or passing a tensor on one, raises; nothing is moved."""
    art = artifacts["port_dir"]
    for device in ("meta", "cuda", "cuda:1"):
        with pytest.raises(ValueError, match="runs only there"):
            load_serving(art, device=device)
    served = load_serving(art, device="cpu")
    label, style = batch_of(artifacts["opt"], 2)
    with pytest.raises(ValueError, match="runs on cpu"):
        served(torch.from_numpy(label).to("meta"), style)
    assert all(t.device.type == "cpu" for t in served.weights)
    with pytest.raises(ValueError, match="takes"):
        served(label[:, :16], style)


# ------------------------------------------------------------------ CLIs
def run_cli(module, args):
    return subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", "--verify", *args],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=600)


def test_export_seg2eye_cli_verifies(artifacts, tmp_path):
    """``python -m seg2eye_tpu_torch.serving.export_seg2eye --device cpu
    --verify`` on a run directory (opt.pkl, latest_net_{G,E}.pth): exit 0,
    and the artifact serves what the checkpoint's live model gives."""
    opt = artifacts["opt"].replace(checkpoints_dir=str(tmp_path), name="exp")
    opt.save()
    for name, net in (("G", artifacts["model"].netG),
                      ("E", artifacts["model"].netE)):
        torch.save(net.state_dict(),
                   os.path.join(opt.expr_dir, f"latest_net_{name}.pth"))
    out = str(tmp_path / "art")
    proc = run_cli("seg2eye_tpu_torch.serving.export_seg2eye",
                   ["--name", "exp", "--checkpoints_dir", str(tmp_path),
                    "--native_hw", "64,40", "--out_dir", out])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    served = load_serving(out)
    assert served.meta["baked_options"]["eval_use_running_stats"] is True
    label, style = batch_of(opt, 2)
    want = artifacts["model"].opt.replace(eval_use_running_stats=True)
    model = Pix2Pix(want, {"G": artifacts["model"].netG,
                           "E": artifacts["model"].netE}, "cpu")
    torch.testing.assert_close(served(label, style)[0],
                               live(model, label, style)[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["refinenet", "segnet"])
def test_export_refiner_cli_verifies(kind, tmp_path):
    """``python -m seg2eye_tpu_torch.serving.export_refiner --device cpu
    --verify`` on a checkpoint of ``CheckpointManager``: exit 0."""
    from seg2eye_tpu_torch.refinenet import config, model
    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager
    from seg2eye_tpu_torch.refinenet.training import Trainer

    cfg = tiny_rn_cfg(config.RefineNetConfig, resume_from=str(tmp_path))
    m = (model.RefineNetModel if kind == "refinenet"
         else model.SegNetModel)(cfg, "cpu")
    trainer = Trainer(m, cfg, "eds_loss" if kind == "refinenet"
                      else "ce_loss")
    CheckpointManager(str(tmp_path)).save_at_step(
        3, trainer.init_state(torch.Generator().manual_seed(2)))
    proc = run_cli("seg2eye_tpu_torch.serving.export_refiner",
                   ["--model", kind, "--resume_from", str(tmp_path),
                    "--resnet_depth", "14", "--input_height", "64",
                    "--input_width", "40", "--compute_dtype", "float32"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded checkpoint at step 3" in proc.stdout and "OK" in proc.stdout
    meta = json.load(open(tmp_path / f"serving_{kind}" / "meta.json"))
    assert meta["model_type"] == kind and meta["device"] == "cpu"


# ---------------------------------------------------------------- bfloat16
def test_bf16_artifact_matches_jax(tmp_path):
    """bfloat16: the port's artifact equals its live bfloat16 model, whose
    fake lies on the bfloat16 grid, and is within the slice's measured
    bfloat16 bound of the JAX package's bfloat16 artifact."""
    variables = jax_variables("bfloat16")
    jexport_inference(JPix2Pix(small_opt(JOptions, compute_dtype="bfloat16")),
                      variables, str(tmp_path / "jax"), native_hw=NATIVE_HW,
                      platforms=("cpu",))
    opt = small_opt(compute_dtype="bfloat16")
    model = port_model(opt, variables)
    export_inference(model, str(tmp_path / "port"), native_hw=NATIVE_HW)
    served = load_serving(str(tmp_path / "port"))
    label, style = batch_of(opt, 2, seed=1)
    fake, f255 = served(label, style)
    lfake, lf255 = live(model, label, style)
    torch.testing.assert_close(fake, lfake, rtol=0, atol=0)
    torch.testing.assert_close(f255, lf255, rtol=0, atol=0)
    assert bf16_exact(fake.numpy())
    jfake, _ = jload_serving(str(tmp_path / "jax"))(label, style)
    np.testing.assert_allclose(fake.numpy(), jfake, atol=BF16_ATOL, rtol=0)


def test_bench_tool_runs_on_the_cpu():
    """``tools/bench_torch_serving.py --device cpu --tiny`` prints its one
    JSON line, artifact and live equal (its times are the host's)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "bench_torch_serving.py"),
         "--device", "cpu", "--tiny", "--batches", "1", "3", "--iters", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["card"] == "cpu" and result["dtype"] == "bfloat16"
    assert [r["bs"] for r in result["rows"]] == [1, 3]
    assert all(r["max_abs_diff"] == 0.0 for r in result["rows"])
