"""PyTorch port, models: JAX-initialised weights carried into the port by
``from_jax_variables`` (strict load), then the same numpy inputs through
both (CPU, float32, atol 1e-4).

Two geometries: square (crop 32) and aspect 0.8 at crop 128, the
smallest crop where the 0.8 latent (5x4) makes H != W all the way up, so
an H/W swap cannot pass unnoticed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.layers import SpectralConv as JSpectralConv
from seg2eye_tpu.models.layers import param_count
from seg2eye_tpu.models.normalization import SpadeStyleBlock as JSpadeStyleBlock
from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu_torch.models.pix2pix import build_networks
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.utils.weights import from_jax_variables

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

ATOL = 1e-4
GEOMETRIES = {"square": dict(crop_size=32, aspect_ratio=1.0),
              "aspect0.8": dict(crop_size=128, aspect_ratio=0.8)}


def tiny_opt(**kw):
    base = dict(ngf=4, crop_size=32, w_dim=8, input_ns=2,
                compute_dtype="float32", isTrain=False)
    return Options(**{**base, **kw}).finalize()


def randomize_running_stats(variables, seed=0):
    """Non-trivial running statistics, so the running-stat path is tested."""
    rng = np.random.default_rng(seed)
    bs = jax.tree_util.tree_map(np.asarray, variables["G"]["batch_stats"])
    for blk in bs.values():
        for norm in blk.values():
            norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(np.float32)
            norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(np.float32)
    variables["G"] = {**variables["G"], "batch_stats": bs}
    return variables


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def pair(request):
    """(opt, JAX model, JAX variables as numpy, port networks)."""
    opt = tiny_opt(**GEOMETRIES[request.param])
    jm = JPix2Pix(opt)
    variables = jax.device_get(
        jm.init_variables(jax.random.PRNGKey(0), with_disc=False))
    variables = randomize_running_stats(dict(variables))
    nets = build_networks(opt)
    for name, sd in from_jax_variables(variables).items():
        nets[name].load_state_dict(sd, strict=True)
    return opt, jm, variables, {k: v.eval() for k, v in nets.items()}


def nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_param_counts_equal_jax(pair):
    _, _, variables, nets = pair
    for name in ("G", "E"):
        port = sum(p.numel() for p in nets[name].parameters())
        assert port == param_count(variables[name]["params"]), name


@pytest.mark.parametrize("conv,kw", [
    ("conv_0", dict(features=4, kernel_size=(3, 3))),
    ("conv_s", dict(features=4, kernel_size=(1, 1), padding=((0, 0), (0, 0)),
                    use_bias=False))])
def test_spectral_conv(pair, conv, kw):
    _, _, variables, nets = pair
    g = variables["G"]
    jvars = {"params": g["params"]["up_3"][conv],
             "spectral": g["spectral"]["up_3"][conv]}
    x = np.random.default_rng(1).normal(size=(2, 12, 10, 8)).astype(np.float32)
    want = jax.jit(JSpectralConv(**kw).apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(nets["G"].up_3, conv)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("running", [False, True],
                         ids=["batch_stats", "running_stats"])
def test_spade_style_block(pair, running):
    _, _, variables, nets = pair
    g = variables["G"]
    jvars = {"params": g["params"]["up_3"]["norm_0"],
             "batch_stats": g["batch_stats"]["up_3"]["norm_0"]}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    seg = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 12, 10))]
    w = rng.normal(size=(2, 8)).astype(np.float32)

    @jax.jit
    def jfn(v, x, seg, w):
        out, _ = JSpadeStyleBlock("batch", 3).apply(
            v, x, seg, w, use_running_average=running,
            mutable=["batch_stats"])
        return out

    want = jfn(jvars, x, seg, w)
    with torch.no_grad():
        got = nets["G"].up_3.norm_0(nchw(x), nchw(seg), torch.tensor(w),
                                    running)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("block,seed", [("up_3", 0), ("head_0", 1),
                                        ("head_0", 3)])
def test_spade_style_block_bf16(pair, block, seed):
    """bfloat16 x and seg through one norm site: the port rounds where JAX
    rounds, so nearly every element is equal and none is more than one
    bf16 ulp apart.  Readings: at least 99.99% equal; the same block in
    float32 (the control) is equal nowhere and up to 1.6e-2 apart, at an
    output range of about 8."""
    _, _, variables, nets = pair
    g = variables["G"]
    jvars = {"params": g["params"][block]["norm_0"],
             "batch_stats": g["batch_stats"][block]["norm_0"]}
    mod = getattr(nets["G"], block).norm_0
    c = mod.adain.linear.weight.shape[0] // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 10, c)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    seg = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 12, 10))]
    w = rng.normal(size=(2, 8)).astype(np.float32)

    @jax.jit
    def jfn(v, x, seg, w):
        out, _ = JSpadeStyleBlock("batch", 3).apply(
            v, x, seg, w, use_running_average=False, mutable=["batch_stats"])
        return out.astype(jnp.float32)

    want = np.asarray(jfn(jvars, x.astype(jnp.bfloat16),
                          seg.astype(jnp.bfloat16), w))
    with torch.no_grad():
        got = {dt: nhwc(mod(nchw(x).to(dt), nchw(seg).to(dt),
                            torch.tensor(w)).float())
               for dt in (torch.bfloat16, torch.float32)}
    assert np.mean(got[torch.bfloat16] == want) >= 0.999
    np.testing.assert_allclose(got[torch.bfloat16], want, rtol=2.0 ** -7,
                               atol=0)
    assert np.mean(got[torch.float32] == want) < 0.01


def test_encoder_mu_and_features(pair):
    opt, jm, variables, nets = pair
    x = np.random.default_rng(3).uniform(
        -1, 1, (3, opt.image_height, opt.image_width, 1)).astype(np.float32)
    mu, logvar, feats = jax.jit(jm.enc.apply)(variables["E"], x)
    with torch.no_grad():
        tmu, tlogvar, tfeats = nets["E"](nchw(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar),
                               atol=ATOL, rtol=0)
    assert len(tfeats) == len(feats)
    for got, want in zip(tfeats, feats):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("running", [False, True],
                         ids=["batch_stats", "running_stats"])
def test_generator(pair, running):
    opt, jm, variables, nets = pair
    rng = np.random.default_rng(4)
    h, w = opt.image_height, opt.image_width
    seg = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, h, w))]
    wvec = rng.normal(size=(2, opt.w_dim)).astype(np.float32)

    @jax.jit
    def jfn(v, seg, wvec):
        out, _ = jm.gen.apply(v, seg, wvec, use_running_average=running,
                              mutable=["batch_stats"])
        return out

    want = np.asarray(jfn(variables["G"], seg, wvec))
    with torch.no_grad():
        got = nets["G"](torch.tensor(seg), torch.tensor(wvec), running)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = nhwc(got)
    assert got.shape == want.shape
    if opt.aspect_ratio != 1.0:
        assert got.shape[1] != got.shape[2]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
