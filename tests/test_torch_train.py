"""PyTorch port, training: each module of the training path and one, then
three, G+D iterations of the port against the JAX package at a tiny
config (ngf 4, ndf 4, crop 32, aspect 1.0, w_dim 8, k = 2, batch 2).

The weights are the port's seeded ``init_networks``, carried into the JAX
package by its own ``torch_convert`` (the reverse of the port's bridge), so
both sides start from the same numbers.  Tolerances, float32:
  * modules (power iteration, running statistics, pooling, discriminator,
    losses): atol 1e-5 to 1e-4, stated per test;
  * one iteration: losses rtol 1e-4; step-1 gradients of G, E and D within
    1e-4 of each tensor's norm; updated spectral u/v and BN running
    statistics atol 1e-5; updated parameters atol 1e-6 (see
    ``assert_params_close`` for the Adam elements whose gradient is
    round-off);
  * three iterations: losses rtol 1e-4 or atol 1e-4, buffers atol 1e-5.
bfloat16: see ``test_one_iteration_bf16``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu import options as jopts
from seg2eye_tpu.models.layers import SpectralConv as JSpectralConv
from seg2eye_tpu.models.normalization import SpadeStyleBlock as JSpadeStyleBlock
from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.ops import image as jimage
from seg2eye_tpu.ops import losses as jlosses
from seg2eye_tpu.ops import metrics as jmetrics
from seg2eye_tpu.train import state as jstate
from seg2eye_tpu.train import steps as jsteps
from seg2eye_tpu.utils import torch_convert, torch_export
from seg2eye_tpu_torch.models.layers import SpectralConv
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
from seg2eye_tpu_torch.ops import image, losses, metrics
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.utils import weights

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

TINY = dict(ngf=4, ndf=4, crop_size=32, aspect_ratio=1.0, w_dim=8,
            input_ns=2, batchSize=2, compute_dtype="float32", isTrain=True,
            lambda_l2=10.0)
# the style-consistency terms run the encoder a second time in the G step
STYLE = dict(lambda_style_w=1.0, lambda_style_feat=1.0, lambda_gram=1.0)
LOSS_RTOL = 1e-4
# |g_port - g_jax| <= GRAD_RTOL |g_jax| + GRAD_ATOL, norms per tensor; the
# floor is for tensors whose gradient is zero up to round-off (D's last
# bias under the hinge loss, where the fake and real terms cancel)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STATE_ATOL = 1e-5          # spectral u/v, BN running statistics
PARAM_ATOL = 1e-6
# three iterations: D's last bias has a gradient that is zero up to
# round-off (above), which JAX's Adam turns into steps of a fraction of lr
# and the port's exact zero does not; every logit moves with it, so the D
# and GAN losses drift apart by about 2e-5 per iteration (measured).  The
# other losses stay within 3e-6, the buffers within 3.3e-6.
LOSS_ATOL_3 = 1e-4
# buffers after several steps, where those round-off steps of Adam have
# moved the weights that later power iterations read: 3.3e-6 after three
# iterations here, 1.24e-5 after the D_steps_per_G = 2 schedule
# (test_torch_train_loop.py)
STATE_ATOL_N = 5e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in
    parallel workers, and each worker's full share of OpenMP threads
    oversubscribes the cores (a loop test took 28 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(**kw):
    return Options(**{**TINY, **kw}).finalize()


def jax_opt(opt):
    return jopts.Options(**dataclasses.asdict(opt)).finalize()


def make_batch(opt, seed=0):
    """Random labels and uint8 references and target, as the loader gives
    them (uint8 transport)."""
    rng = np.random.default_rng(seed)
    b, h, w = opt.batchSize, opt.image_height, opt.image_width
    return {
        "label": rng.integers(0, opt.label_nc, (b, h, w)).astype(np.int32),
        "style_image": rng.integers(0, 256, (b, opt.input_ns, h, w, 1),
                                    dtype=np.uint8),
        "target": rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8),
    }


def numpy_state(nets):
    return {k: {n: t.detach().numpy().copy()
                for n, t in net.state_dict().items()}
            for k, net in nets.items()}


def to_jax_variables(opt, nets):
    """The port's networks as JAX variables, through the JAX package's own
    torch_convert on a template shaped by tracing (not compiling) the JAX
    init."""
    jm = JPix2Pix(jax_opt(opt))
    shapes = jax.eval_shape(functools.partial(jm._init_variables,
                                              with_disc=True),
                            jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = numpy_state(nets)
    return {
        "G": torch_convert.convert_generator(sd["G"], template["G"]),
        "E": torch_convert.convert_encoder(sd["E"], template["E"], opt.w_dim),
        "D": torch_convert.convert_discriminator(
            sd["D"], template["D"], opt.num_D, opt.n_layers_D),
    }


def port_model(opt, seed=0, device="cpu"):
    nets = weights.init_networks(opt, torch.Generator().manual_seed(seed),
                                 device)
    return Pix2Pix(opt, nets, device)


def exported(variables, opt):
    """JAX variables (or a gradient tree shaped as 'params') -> torch-keyed
    numpy dicts, through the port's export."""
    return {"G": weights.export_generator(variables["G"]),
            "E": weights.export_encoder(variables["E"]),
            "D": weights.export_discriminator(variables["D"], opt.num_D,
                                              opt.n_layers_D)}


def is_buffer(key):
    return key.endswith(("weight_u", "weight_v", "running_mean",
                         "running_var"))


def port_grads(model):
    out = {}
    for name, net in (("G", model.netG), ("E", model.netE),
                      ("D", model.netD)):
        out[name] = {k: None if p.grad is None else p.grad.numpy().copy()
                     for k, p in net.named_parameters()}
    return out


def rel_err(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_losses_close(got, want, rtol, atol=1e-6):
    assert sorted(got) == sorted(want)     # a jitted dict comes back sorted
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(jnp.mean(want[k])),
                                   rtol=rtol, atol=atol, err_msg=k)


def assert_buffers_close(model, want, atol):
    for name, net in (("G", model.netG), ("E", model.netE),
                      ("D", model.netD)):
        for k, t in net.state_dict().items():
            if is_buffer(k):
                np.testing.assert_allclose(t.numpy(), want[name][k],
                                           atol=atol, rtol=0,
                                           err_msg=f"{name}.{k}")


def assert_params_close(model, want, grads, atol, lr_max):
    """Parameters after one step.  Adam at beta1 = 0 moves an element by
    about lr times the sign of its gradient, whatever the gradient's size.
    So where the JAX gradient is round-off (below 1e-5 of its tensor's
    largest, or 1e-7), the two sides may step apart, by at most 2 lr;
    everywhere else they agree to ``atol``."""
    for name, net in (("G", model.netG), ("E", model.netE),
                      ("D", model.netD)):
        for k, p in net.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name][k])
            g = np.abs(grads[name][k])
            noise = g <= 1e-5 * g.max() + 1e-7
            assert np.all(diff[~noise] <= atol), f"{name}.{k}"
            assert np.all(diff[noise] <= 2 * lr_max + atol), f"{name}.{k}"


# ---------------------------------------------------------------- modules
def test_power_iteration_matches_jax():
    """One training forward of a spectral conv: output, and the stored
    (u, v) replaced by one power iteration, as JAX's update_stats."""
    opt = tiny_opt()
    model = port_model(opt)
    conv = model.netG.up_3.conv_0
    g = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                               "D": model.netD})["G"]
    jvars = {"params": g["params"]["up_3"]["conv_0"],
             "spectral": g["spectral"]["up_3"]["conv_0"]}
    x = np.random.default_rng(1).normal(size=(2, 12, 10, 8)).astype(np.float32)

    @jax.jit
    def jfn(v, x):
        return JSpectralConv(4, (3, 3)).apply(v, x, update_stats=True,
                                              mutable=["spectral"])

    want, mut = jfn(jvars, x)
    u0 = conv.weight_u
    got = conv(torch.tensor(x).permute(0, 3, 1, 2), update_stats=True)
    assert conv.weight_u is not u0           # a new tensor, not written in
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(conv.weight_u.numpy(),
                               np.asarray(mut["spectral"]["u"]), atol=1e-6)
    # JAX flattens v in (kh, kw, I) order, torch in (I, kh, kw)
    np.testing.assert_allclose(
        conv.weight_v.numpy(),
        weights._unperm_v(mut["spectral"]["v"], jvars["params"]["kernel"]),
        atol=1e-6)
    # sigma comes from the new pair: a second forward without an update
    # gives the same output
    again = conv(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(again.detach().numpy(),
                                  got.detach().numpy())


def test_power_iteration_keeps_earlier_graph_intact():
    """Two training forwards, then backward through both: the second
    forward's update must not touch the (u, v) the first one saved."""
    conv = port_model(tiny_opt()).netG.up_3.conv_0
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    w = conv.weight_orig
    u0, v0 = conv.weight_u.clone(), conv.weight_v.clone()
    loss = conv(x, update_stats=True).sum()
    u1, v1 = conv.weight_u.clone(), conv.weight_v.clone()
    (loss + conv(x, update_stats=True).sum()).backward()
    assert not torch.equal(u0, u1) and not torch.equal(u1, conv.weight_u)
    # the gradient equals that of the same two forwards written out
    grad = w.grad.clone()
    w.grad = None
    for u, v in ((u1, v1), (conv.weight_u, conv.weight_v)):
        mat = w.reshape(w.shape[0], -1)
        k = w / torch.dot(u, mat @ v)
        torch.nn.functional.conv2d(x, k, conv.bias, padding=1).sum().backward()
    torch.testing.assert_close(grad, w.grad, rtol=1e-5, atol=1e-7)


def test_bn_running_update_matches_jax():
    """The param-free BN of a SPADE+Style site on a training forward:
    output with batch statistics, and running_mean/var after momentum 0.1
    with the unbiased variance, as JAX's batch_stats update."""
    opt = tiny_opt()
    model = port_model(opt)
    g = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                               "D": model.netD})["G"]
    rng = np.random.default_rng(2)
    stats = g["batch_stats"]["up_3"]["norm_0"]
    stats = {"mean": rng.normal(0, 0.1, stats["mean"].shape).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)}
    mod = model.netG.up_3.norm_0
    pfn = mod.spade.param_free_norm
    pfn.running_mean.copy_(torch.tensor(stats["mean"]))
    pfn.running_var.copy_(torch.tensor(stats["var"]))
    jvars = {"params": g["params"]["up_3"]["norm_0"], "batch_stats": stats}
    x = rng.normal(1.0, 2.0, size=(2, 12, 10, 8)).astype(np.float32)
    seg = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 12, 10))]
    w = rng.normal(size=(2, 8)).astype(np.float32)

    @jax.jit
    def jfn(v, x, seg, w):
        return JSpadeStyleBlock("batch", 3).apply(v, x, seg, w,
                                                  mutable=["batch_stats"])

    want, mut = jfn(jvars, x, seg, w)

    def nchw(a):
        return torch.tensor(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        got = mod(nchw(x), nchw(seg), torch.tensor(w), update_stats=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pfn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(pfn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-5, rtol=1e-6)
    assert int(pfn.num_batches_tracked) == 1
    # no update without update_stats
    before = pfn.running_mean.clone()
    with torch.no_grad():
        mod(nchw(x), nchw(seg), torch.tensor(w))
    assert torch.equal(before, pfn.running_mean)


@pytest.mark.parametrize("shape", [(2, 32, 32, 5), (1, 17, 9, 3),
                                   (3, 2, 2, 1)])
def test_avg_pool_3x3s2_matches_jax(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jimage.avg_pool_3x3s2)(x))
    got = image.avg_pool_3x3s2(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_avg_pool_3x3s2_gradient_pools_contiguous_nchw(monkeypatch):
    """The pool's input gradient matches JAX's (atol 1e-6), and the pool
    itself runs on a contiguous NCHW tensor: PyTorch's CUDA backward of
    avg_pool2d on channels_last input is wrong, which only the card shows
    (chip_smoke.py checks it there).  The result is NHWC-contiguous."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 17, 12, 5)).astype(np.float32)
    w = rng.normal(size=(2, 9, 6, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jimage.avg_pool_3x3s2(x) * w)))(x))
    seen = []
    pool = torch.nn.functional.avg_pool2d

    def recording_pool(t, *args, **kwargs):
        seen.append(t.is_contiguous())
        return pool(t, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "avg_pool2d", recording_pool)
    xt = torch.tensor(x, requires_grad=True)
    out = image.avg_pool_3x3s2(xt)
    assert seen == [True] and out.is_contiguous()
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def converted():
    """(opt, port model, its weights as JAX variables)."""
    opt = tiny_opt(**STYLE)
    model = port_model(opt)
    return opt, model, to_jax_variables(
        opt, {"G": model.netG, "E": model.netE, "D": model.netD})


def test_discriminator_params_and_intermediates_match_jax(converted):
    """Each scale's stage outputs (feature-matching intermediates and the
    logits) on a training forward, and the updated spectral state."""
    opt, model, variables = converted
    assert sum(p.numel() for p in model.netD.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(
            variables["D"]["params"]))
    jm = JPix2Pix(jax_opt(opt))
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 5)).astype(np.float32)

    @jax.jit
    def jfn(v, x):
        return jm.disc.apply(v, x, update_stats=True,
                             mutable=["spectral", "batch_stats"])

    want, mut = jfn(variables["D"], x)
    net = Pix2Pix(opt, {"G": model.netG, "E": model.netE,
                        "D": _copy_net(model.netD)}, "cpu").netD
    with torch.no_grad():
        got = net(torch.tensor(x).permute(0, 3, 1, 2), update_stats=True)
    assert [len(s) for s in got] == [len(s) for s in want] == [5, 5]
    for scale_got, scale_want in zip(got, want):
        for g, w in zip(scale_got, scale_want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w), atol=1e-5, rtol=0)
    want_sd = weights.export_discriminator(
        {**variables["D"], "spectral": mut["spectral"]})
    for k, t in net.state_dict().items():
        if is_buffer(k):
            np.testing.assert_allclose(t.numpy(), want_sd[k], atol=1e-6,
                                       err_msg=k)


def _copy_net(net):
    import copy
    return copy.deepcopy(net)


def test_discriminator_param_count_at_ndf64():
    from seg2eye_tpu_torch.models.discriminator import MultiscaleDiscriminator
    net = MultiscaleDiscriminator(5, ndf=64)
    assert sum(p.numel() for p in net.parameters()) == 5_531_778


def test_discriminator_export_matches_torch_export(converted):
    """The port's own D export equals the JAX package's, bit for bit, and
    strict-loads into the port's discriminator."""
    opt, model, variables = converted
    want = torch_export.export_discriminator(variables["D"])
    got = weights.export_discriminator(variables["D"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    d = weights.from_jax_variables(variables)["D"]
    _copy_net(model.netD).load_state_dict(d, strict=True)


@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "w"])
def test_losses_match_jax(mode):
    """gan_loss (both targets, for D and for G, multiscale lists and a bare
    tensor), feature matching, L1/L2, Gram, the multi-level style losses
    and mse_for_tensors, float32, rtol 1e-5."""
    rng = np.random.default_rng(5)

    def r(*s):
        return rng.normal(size=s).astype(np.float32)

    preds_f = [[r(2, 9, 9, 4), r(2, 5, 5, 1)], [r(2, 5, 5, 4), r(2, 3, 3, 1)]]
    preds_r = [[r(2, 9, 9, 4), r(2, 5, 5, 1)], [r(2, 5, 5, 4), r(2, 3, 3, 1)]]
    feats_a, feats_b = [r(2, 8, 8, 4), r(2, 4, 4, 8)], [r(2, 8, 8, 4),
                                                       r(2, 4, 4, 8)]
    img_a, img_b = np.tanh(r(2, 16, 16, 1)), np.tanh(r(2, 16, 16, 1))

    @jax.jit
    def jfn(pf, pr, fa, fb, ia, ib):
        out = {}
        for real in (True, False):
            for for_d in (True, False):
                out[f"gan/{real}/{for_d}"] = jlosses.gan_loss(
                    pf, real, for_discriminator=for_d, mode=mode)
        out["gan/bare"] = jlosses.gan_loss(pf[0][-1], True, True, mode=mode)
        out["feat"] = jlosses.feature_matching_loss(pf, pr, 10.0)
        out["l1"] = jlosses.l1_loss(ia, ib)
        out["l2"] = jlosses.l2_loss(ia, ib)
        out["gram"] = jlosses.gram_matrix(fa[0])
        out["style_gram"] = jlosses.style_gram_loss(fa[1], fb[1])
        out["multi_mse"] = jlosses.multi_feature_mse(fa, fb)
        out["multi_gram"] = jlosses.multi_gram_loss(fa, fb)
        out["openeds"] = jmetrics.mse_for_tensors(ia, ib)
        return out

    want = jfn(preds_f, preds_r, feats_a, feats_b, img_a, img_b)

    def t(a):
        return torch.tensor(a)

    def nchw(a):
        return t(a).permute(0, 3, 1, 2)

    tf = [[nchw(a) for a in s] for s in preds_f]
    tr = [[nchw(a) for a in s] for s in preds_r]
    fa, fb = [nchw(a) for a in feats_a], [nchw(a) for a in feats_b]
    got = {}
    for real in (True, False):
        for for_d in (True, False):
            got[f"gan/{real}/{for_d}"] = losses.gan_loss(
                tf, real, for_discriminator=for_d, mode=mode)
    got["gan/bare"] = losses.gan_loss(tf[0][-1], True, True, mode=mode)
    got["feat"] = losses.feature_matching_loss(tf, tr, 10.0)
    got["l1"] = losses.l1_loss(t(img_a), t(img_b))
    got["l2"] = losses.l2_loss(t(img_a), t(img_b))
    got["gram"] = losses.gram_matrix(fa[0])
    got["style_gram"] = losses.style_gram_loss(fa[1], fb[1])
    got["multi_mse"] = losses.multi_feature_mse(fa, fb)
    got["multi_gram"] = losses.multi_gram_loss(fa, fb)
    got["openeds"] = metrics.mse_for_tensors(t(img_a), t(img_b))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError):
        losses.gan_loss(tf, True, True, mode="nope")


# ---------------------------------------------------------- one iteration
def jax_reference(opt, variables, batches):
    """JAX's train_step over ``batches`` from ``variables``, and its step-1
    gradients: G/E from the generator loss, D from the discriminator loss
    after the G update (the fake regenerated), as ``_d_update`` takes
    them."""
    jm = JPix2Pix(jax_opt(opt))
    fns = jsteps.StepFunctions(jm, donate=False)
    state = _jax_state(jm, fns, variables)

    @jax.jit
    def grads(state, batch):
        def g_loss(params_ge):
            v = {"G": {**state.variables["G"], "params": params_ge["G"]},
                 "E": {**state.variables["E"], "params": params_ge["E"]},
                 "D": state.variables["D"]}
            return jm.generator_loss(v, batch)[0]

        g_grads = jax.grad(g_loss)(state.params_ge())
        state1, _, _ = jsteps._g_update(jm, fns.tx_g, state, batch)
        seg, style, _ = jm.preprocess(batch)
        fake, _, _, gen_new = jm.generate_fake(state1.variables, seg, style,
                                               train=True)
        fake = jax.lax.stop_gradient(fake)

        def d_loss(params_d):
            v = {**gen_new, "D": {**state1.variables["D"],
                                  "params": params_d}}
            return jm.discriminator_loss(v, batch, fake=fake)[0]

        return g_grads, jax.grad(d_loss)(state1.params_d())

    g_grads, d_grads = grads(state, batches[0])
    trajectory = []
    for batch in batches:
        state, losses, _ = fns.train_step(state, batch)
        trajectory.append((jax.device_get(losses),
                           jax.device_get(state.variables)))
    return {"G": g_grads["G"], "E": g_grads["E"], "D": d_grads}, trajectory


def _jax_state(jm, fns, variables):
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), variables=variables,
        opt_g=fns.tx_g.init({"G": variables["G"]["params"],
                             "E": variables["E"]["params"]}),
        opt_d=fns.tx_d.init(variables["D"]["params"]))


@pytest.fixture(scope="module")
def f32_reference(converted):
    opt, _, variables = converted
    batches = [make_batch(opt, seed) for seed in range(3)]
    grads, trajectory = jax_reference(opt, variables, batches)
    return batches, grads, trajectory


def test_one_iteration_matches_jax(converted, f32_reference):
    """One G+D iteration, float32: the loss dict, the step-1 gradients of
    every G, E and D parameter, the updated spectral u/v and BN running
    statistics, and the updated parameters."""
    opt, _, variables = converted
    batches, grads, trajectory = f32_reference
    model = port_model(opt)
    state = state_lib.create_state(model)
    got, fake = steps.train_step(state, batches[0])
    assert state.step == 1
    assert fake.shape == (2, 32, 32, 1)
    assert_losses_close(got, trajectory[0][0], LOSS_RTOL)

    want = exported({k: {"params": v, "spectral": variables[k]["spectral"]}
                     for k, v in grads.items()}, opt)
    have = port_grads(model)
    for name in ("G", "E", "D"):
        for k, g in have[name].items():
            if k == "fc_var.weight" or k == "fc_var.bias":
                assert g is None                  # Adam skips it
                assert not np.any(want[name][k])  # JAX: zero gradient
                continue
            assert (np.linalg.norm(g - want[name][k])
                    <= GRAD_RTOL * np.linalg.norm(want[name][k])
                    + GRAD_ATOL), (name, k, rel_err(g, want[name][k]))
    new = exported(trajectory[0][1], opt)
    assert_buffers_close(model, new, STATE_ATOL)
    assert_params_close(model, new, want, PARAM_ATOL, opt.lr * 2)


def test_three_iterations_match_jax(converted, f32_reference):
    opt, _, _ = converted
    batches, _, trajectory = f32_reference
    model = port_model(opt)
    state = state_lib.create_state(model)
    for batch, (want, _) in zip(batches, trajectory):
        got, _ = steps.train_step(state, batch)
        assert_losses_close(got, want, LOSS_RTOL, LOSS_ATOL_3)
    assert_buffers_close(model, exported(trajectory[-1][1], opt), STATE_ATOL)


def test_nets_change_where_training_moves_them(converted):
    """After one iteration every spectral u/v and running statistic moved,
    and every parameter with a nonzero gradient; fc_var did not (it feeds
    no loss, so it has no gradient).  (At this config the two samples'
    1x1 latent can hold one class, making head_0.norm_0's batch variance 0
    and its gamma conv's gradient exactly 0, in JAX too.)"""
    opt, _, _ = converted
    model = port_model(opt)
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    before = numpy_state(nets)
    steps.train_step(state_lib.create_state(model), make_batch(opt))
    moved = 0
    for name, net in nets.items():
        for k, t in net.state_dict().items():
            if is_buffer(k):
                assert not np.array_equal(t.numpy(), before[name][k]), k
        for k, p in net.named_parameters():
            same = np.array_equal(p.detach().numpy(), before[name][k])
            if "fc_var" in k:
                assert p.grad is None and same, k
                continue
            assert same == (not p.grad.any()), k
            moved += not same
    assert moved >= 100


def _gap(a, b, keys):
    return float(np.sqrt(sum(np.sum((np.asarray(a[k], np.float64)
                                     - np.asarray(b[k], np.float64)) ** 2)
                             for k in keys)))


def test_one_iteration_bf16(converted, f32_reference):
    """bfloat16 compute (float32 parameters and statistics), one
    iteration, held to JAX's bf16 within JAX's own bf16-vs-f32 gap: the
    loss dict (as one vector), the step-1 gradients and the updated buffers
    of each net (as one vector per net), all by their Euclidean norms.
    Readings: losses 1.3e-3 against a gap of 7.6e-3; gradients, relative
    to JAX's bf16, G 0.149 (gap 0.290), E 0.133 (0.341), D 0.264 (0.278);
    buffers G 0.0184 (gap 0.0484, max norms) and E level with the gap (both
    sides are one bf16 rounding of E's u apart from f32 at one element).
    So a buffer vector may reach the gap plus one f32 tolerance."""
    opt32, _, variables = converted
    opt = opt32.replace(compute_dtype="bfloat16")
    batches, grads32, trajectory32 = f32_reference
    grads16, trajectory16 = jax_reference(opt, variables, batches[:1])
    model = port_model(opt)
    got, fake = steps.train_step(state_lib.create_state(model), batches[0])
    assert fake.dtype == torch.bfloat16
    mean = {k: {n: float(jnp.mean(v)) for n, v in t[0][0].items()}
            for k, t in (("16", trajectory16), ("32", trajectory32))}
    got = {k: float(v) for k, v in got.items()}
    assert sorted(got) == sorted(mean["16"])
    assert _gap(got, mean["16"], got) <= _gap(mean["16"], mean["32"], got)

    spectral = {k: {"params": grads16[k], "spectral":
                    variables[k]["spectral"]} for k in grads16}
    g16 = exported(spectral, opt)
    g32 = exported({k: {**v, "params": grads32[k]}
                    for k, v in spectral.items()}, opt)
    for name, have in port_grads(model).items():
        keys = [k for k, g in have.items() if g is not None]
        assert all("fc_var" in k for k in set(have) - set(keys))
        assert _gap(have, g16[name], keys) <= _gap(g16[name], g32[name],
                                                   keys), name
    new16 = exported(trajectory16[0][1], opt)
    new32 = exported(trajectory32[0][1], opt)
    for name, net in (("G", model.netG), ("E", model.netE),
                      ("D", model.netD)):
        have = {k: t.numpy() for k, t in net.state_dict().items()
                if is_buffer(k)}
        assert _gap(have, new16[name], have) <= _gap(
            new16[name], new32[name], have) + STATE_ATOL, name


def test_epoch_lr_matches_jax_across_decay():
    """The per-epoch LR with the reference's off-by-one, and TTUR on the
    optimizers' groups, against the JAX package's schedule."""
    opt = tiny_opt(niter=3, niter_decay=4, lr=0.001)
    jo = jax_opt(opt)
    model = port_model(opt)
    state = state_lib.create_state(model)
    for epoch in range(1, opt.niter + opt.niter_decay + 2):
        assert state_lib.epoch_lr(opt, epoch) == jstate.epoch_lr(jo, epoch)
        state_lib.set_learning_rate(state, opt, epoch)
        g, d = jstate.ttur_lrs(jo, jstate.epoch_lr(jo, epoch))
        assert [grp["lr"] for grp in state.opt_g.param_groups] == [g]
        assert [grp["lr"] for grp in state.opt_d.param_groups] == [d]
    assert state_lib.epoch_lr(opt, 4) == 0.001          # niter + 1: full
    assert state_lib.epoch_lr(opt, 5) == pytest.approx(0.00075)
    assert state.opt_g.param_groups[0]["betas"] == (0.0, 0.9)
    no_ttur = state_lib.create_state(port_model(
        opt.replace(no_TTUR=True)))
    assert no_ttur.opt_g.param_groups[0]["betas"] == (opt.beta1, opt.beta2)
    assert no_ttur.opt_d.param_groups[0]["lr"] == opt.lr


def test_fc_var_untouched_under_weight_decay():
    """Under coupled weight decay every parameter with a gradient moves,
    and fc_var, which has none, does not: Adam skips a None grad, and the
    steps never zero-fill one.  JAX masks it out of the G optimizer."""
    opt = tiny_opt(weight_decay=0.1)
    model = port_model(opt)
    fc_var = {k: v.clone() for k, v in model.netE.fc_var.state_dict().items()}
    state = state_lib.create_state(model)
    assert state.opt_g.param_groups[0]["weight_decay"] == 0.1
    for seed in range(2):
        steps.train_step(state, make_batch(opt, seed))
    for k, v in model.netE.fc_var.state_dict().items():
        assert torch.equal(v, fc_var[k]), k
    assert model.netE.fc_var.weight.grad is None
    assert model.netE.fc_var.weight not in state.opt_g.state


@pytest.mark.parametrize("impl", ["for-loop", "foreach", "fused"])
def test_packed_weights_after_adam_step(impl):
    """The kernel's packed-weight cache (``ops.spade_style.packed_weights``,
    behind the op boundary) is keyed on each weight's storage and
    ``_version``.  Adam's for-loop and foreach steps move the key, so
    the next call packs the new weights; the fused step changes the weights
    in place WITHOUT moving ``_version``, so the cache would keep the old
    ones: the port's optimizers are never fused."""
    model = port_model(tiny_opt())
    block = model.netG.up_3.norm_0
    s = block.spade
    ws = (s.mlp_gamma.weight, s.mlp_gamma.bias, s.mlp_beta.weight,
          s.mlp_beta.bias)
    first = K.packed_weights(*ws, torch.float32)
    assert K.packed_weights(*ws, torch.float32)[0] is first[0]     # cached
    kw = {"for-loop": dict(foreach=False), "foreach": dict(foreach=True),
          "fused": dict(fused=True)}[impl]
    adam = torch.optim.Adam(ws, lr=1e-2, betas=(0.0, 0.9), **kw)
    for w in ws:
        w.grad = torch.ones_like(w)
    adam.step()
    stale = K.packed_weights(*ws, torch.float32)[0] is first[0]
    assert stale == (impl == "fused")
    if impl == "fused":
        state = state_lib.create_state(port_model(tiny_opt()))
        assert not any(o.defaults["fused"] for o in (state.opt_g,
                                                     state.opt_d))
        return
    again = K.packed_weights(*ws, torch.float32)
    want = K.pack_weights(*ws, torch.float32)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])
    assert not torch.equal(again[0], first[0])


def test_training_step_drops_packed_weights():
    """After a G step no norm site serves the packed copy it made before:
    the step's Adam moved every weight's key, so each site packs anew."""
    model = port_model(tiny_opt())
    blocks = [m for m in model.netG.modules()
              if isinstance(m, type(model.netG.up_3.norm_0))]
    assert len(blocks) == 18

    def weights(b):
        s = b.spade
        return (s.mlp_gamma.weight, s.mlp_gamma.bias, s.mlp_beta.weight,
                s.mlp_beta.bias)

    before = [K.packed_weights(*weights(b), torch.float32) for b in blocks]
    steps.g_step(state_lib.create_state(model), make_batch(model.opt))
    for b, old in zip(blocks, before):
        new = K.packed_weights(*weights(b), torch.float32)
        want = K.pack_weights(*weights(b), torch.float32)
        assert new[0] is not old[0]
        assert torch.equal(new[0], want[0]) and torch.equal(new[1], want[1])


@pytest.mark.filterwarnings("ignore:Full backward hook is firing")
@pytest.mark.parametrize("dtype,tf32", [("float32", False),
                                        ("bfloat16", True)])
def test_training_step_keeps_float32_out_of_tf32(monkeypatch, dtype, tf32):
    """With PyTorch's default flags (cuDNN may use TF32), a float32
    training step runs every convolution, forward AND backward (read by
    full backward hooks on every conv and linear module), with both TF32
    flags off, and restores them after; bfloat16 leaves them on."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    seen = {"forward": [], "backward": []}
    conv2d = torch.nn.functional.conv2d

    def recording_conv2d(*args, **kwargs):
        seen["forward"].append((cudnn.allow_tf32, matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv2d)
    model = port_model(tiny_opt(compute_dtype=dtype))
    for net in (model.netG, model.netE, model.netD):
        for m in net.modules():
            if isinstance(m, (SpectralConv, torch.nn.Linear)):
                m.register_full_backward_hook(
                    lambda *_: seen["backward"].append(
                        (cudnn.allow_tf32, matmul.allow_tf32)))
    steps.train_step(state_lib.create_state(model), make_batch(model.opt))
    for phase, flags in seen.items():
        assert len(flags) > 40 and set(flags) == {(tf32, tf32)}, phase
    assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
