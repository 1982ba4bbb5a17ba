"""PyTorch port, the model options of the Seg2Eye main path against the
JAX package, at the tiny config of ``test_torch_train.py`` (ngf 4, ndf 4,
crop 32, aspect 1.0, w_dim 8, k = 2), float32:

  * ``norm_E = norm_D = 'spectralbatch'`` (affine batch sub-norms) with
    per-sample encoding (on through 'auto'): three G+D iterations at
    batch 2, one iteration and the G step at batch 3, with that file's
    tolerances (BN_GRAD_RTOL for the gradients);
  * ``--per_sample_encode on`` with instance sub-norms, and eval-mode
    per-sample encoding;
  * ``--remat``: against the same iteration without it (losses and
    gradients 1e-6 relative, u/v and running statistics bit for bit) and
    against the JAX package's remat iteration; the kernel's launches;
  * the VGG loss: VGG19 features (1e-5), the generator loss, the export,
    loading torchvision-layout weights;
  * the init schemes of ``weight_init``: torch.nn.init's laws exactly, and
    moments and orthogonality against JAX's initialisers.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.models import layers as jlayers
from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.models.vgg import VGG19Features as JVGG19Features
from seg2eye_tpu.train import steps as jsteps
from seg2eye_tpu.utils import torch_convert, torch_export
from seg2eye_tpu_torch.models.layers import BatchSubNorm, weight_init
from seg2eye_tpu_torch.models.vgg import VGG19Features
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.train.loop import train
from seg2eye_tpu_torch.utils import weights
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_ATOL_3, LOSS_RTOL,
                              STATE_ATOL, _jax_state, assert_buffers_close,
                              assert_losses_close, exported, jax_opt,
                              jax_reference, make_batch, numpy_state,
                              port_grads, port_model, rel_err, tiny_opt,
                              to_jax_variables)

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

BATCH_NORMS = dict(norm_E="spectralbatch", norm_D="spectralbatch")
# step-1 gradients with batch sub-norms: train-mode BN over a few hundred
# values amplifies float32 round-off, most in D's gradients, taken after
# the G update (Adam's sign steps go the other way where G's gradients
# differ in sign); measured 1.04e-4 of a D tensor's norm at batch 3, the
# largest, against test_torch_train's 1e-4
BN_GRAD_RTOL = 3e-4
# remat against no remat: the same ops, recomputed; on the CPU the two agree
# bit for bit, the tolerance allows for a differently ordered sum
REMAT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_grads_close(have, want, rtol=GRAD_RTOL):
    """Step-1 gradients of every G, E and D parameter; fc_var has none."""
    for name in ("G", "E", "D"):
        for k, g in have[name].items():
            if k.startswith("fc_var."):
                assert g is None and not np.any(want[name][k])
                continue
            assert (np.linalg.norm(g - want[name][k])
                    <= rtol * np.linalg.norm(want[name][k])
                    + GRAD_ATOL), (name, k, rel_err(g, want[name][k]))


def check_against_jax(opt, iterations, grad_rtol=GRAD_RTOL):
    """``iterations`` G+D iterations of the port against JAX's from the
    same weights: every iteration's loss dict, the step-1 gradients and,
    with ``iterations`` > 1, the buffers after the first and the last
    iteration."""
    model = port_model(opt)
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    variables = to_jax_variables(opt, nets)
    batches = [make_batch(opt, seed) for seed in range(iterations)]
    grads, trajectory = jax_reference(opt, variables, batches)
    state = state_lib.create_state(model)
    for i, (batch, (want, new)) in enumerate(zip(batches, trajectory)):
        got, _ = steps.train_step(state, batch)
        assert_losses_close(got, want, LOSS_RTOL, 1e-6 if i == 0
                            else LOSS_ATOL_3)
        if i == 0:
            assert_grads_close(port_grads(model), exported(
                {k: {"params": v, "spectral": variables[k]["spectral"],
                     **({"batch_stats": variables[k]["batch_stats"]}
                        if "batch_stats" in variables[k] else {})}
                 for k, v in grads.items()}, opt), grad_rtol)
            if iterations > 1:
                assert_buffers_close(model, exported(new, opt), STATE_ATOL)
    if iterations > 1:
        assert_buffers_close(model, exported(trajectory[-1][1], opt),
                             STATE_ATOL)
    return model, variables


# ----------------------------------------------- batch sub-norms (E and D)
@pytest.mark.parametrize("batch", [2, 3])
def test_spectralbatch_per_sample_iterations_match_jax(batch):
    """norm_E = norm_D = 'spectralbatch', per-sample encoding on through
    'auto': losses and step-1 gradients, and the spectral u/v and BN
    running statistics (E's advanced once per sample, D's over the
    [fake | real] batch).  Batch 2: three iterations, buffers after the
    first and the third.  Batch 3: one iteration, and the buffers after
    JAX's and the port's G step from the same weights.  At batch 3 the
    gradient of head_0.norm_0's mlp_gamma.bias (the 1x1 latent) is
    round-off (norm 4e-8); Adam at beta1 = 0 steps each of its elements by
    lr * sign, which differs between the two sides for 35 of its 64, and
    the D step's regeneration of the fake carries that into every buffer
    it writes (7e-3 apart after one iteration, 6% in the losses after
    three; measured), as assert_params_close describes for parameters."""
    opt = tiny_opt(batchSize=batch, **BATCH_NORMS)
    assert opt.per_sample_encode_enabled
    before = numpy_state({"E": port_model(opt).netE})["E"]
    iterations = 3 if batch == 2 else 1
    model, variables = check_against_jax(opt, iterations, BN_GRAD_RTOL)
    moved = [k for k, t in model.netE.state_dict().items()
             if k.endswith("running_mean")
             and not np.array_equal(t.numpy(), before[k])]
    assert len(moved) == model.netE.n_layers
    # one count per sample per encode: B in the G step, B in the D step's
    # regeneration, per iteration
    assert int(model.netE.layer0[1].num_batches_tracked) == \
        iterations * 2 * batch
    assert isinstance(model.netD.discriminator_0.model1[0][1], BatchSubNorm)
    if batch == 3:
        jm = JPix2Pix(jax_opt(opt))
        fns = jsteps.StepFunctions(jm, donate=False)
        jstate, want, _ = fns.g_step(_jax_state(jm, fns, variables),
                                     make_batch(opt))
        model = port_model(opt)
        got, _ = steps.g_step(state_lib.create_state(model), make_batch(opt))
        assert_losses_close(got, jax.device_get(want), LOSS_RTOL)
        assert_buffers_close(model, exported(jax.device_get(
            jstate.variables), opt), STATE_ATOL)


def test_batch_subnorm_exports_match_torch_export():
    """The port's E and D exports of batch sub-norms equal the JAX
    package's bit for bit, running statistics included, and strict-load."""
    opt = tiny_opt(**BATCH_NORMS)
    model = port_model(opt)
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    variables = to_jax_variables(opt, nets)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype),
        variables)                  # every statistic and scale off its init
    for name, mine, theirs in (
            ("E", weights.export_encoder, torch_export.export_encoder),
            ("D", weights.export_discriminator,
             torch_export.export_discriminator)):
        want, got = theirs(variables[name]), mine(variables[name])
        assert list(got) == list(want)
        assert any(k.endswith(".1.running_var") for k in got)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    sds = weights.from_jax_variables(variables)
    for name in ("E", "D"):
        nets[name].load_state_dict(sds[name], strict=True)


# ---------------------------------------------------- per-sample encoding
def encode_inputs(opt, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (opt.batchSize, opt.input_ns, 32, 32, 1)
                       ).astype(np.float32)


def test_per_sample_encode_on_matches_jax():
    """--per_sample_encode on with instance sub-norms at batch 3 (training
    forward): w, the aggregated features and the spectral u advanced once
    per sample equal JAX's ``_encode_w_per_sample``."""
    opt = tiny_opt(batchSize=3, per_sample_encode="on")
    model = port_model(opt)
    variables = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                                       "D": model.netD})
    style = encode_inputs(opt)
    jm = JPix2Pix(jax_opt(opt))
    w, feats, new_e = jax.jit(functools.partial(jm.encode_w, train=True))(
        variables, style)
    u0 = model.netE.layer0[0].weight_u.clone()
    with torch.no_grad():
        got_w, got_feats = model.encode_w(torch.tensor(style), True)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), atol=1e-5,
                               rtol=0)
    for g, f in zip(got_feats, feats):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(f), atol=1e-5, rtol=0)
    assert not torch.equal(u0, model.netE.layer0[0].weight_u)
    want = weights.export_encoder(new_e)
    for k, t in model.netE.state_dict().items():
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(t.numpy(), want[k], atol=STATE_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("norm_e", ["spectralinstance", "spectralbatch"])
def test_eval_per_sample_encode_matches_jax_and_keeps_state(norm_e):
    """Outside training, per-sample encoding normalises each sample with
    its own batch statistics (JAX's eval path) and leaves every u/v and
    running statistic as it was."""
    opt = tiny_opt(batchSize=3, per_sample_encode="on", norm_E=norm_e)
    model = port_model(opt)
    variables = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                                       "D": model.netD})
    style = encode_inputs(opt, 1)
    jm = JPix2Pix(jax_opt(opt))
    w, _, _ = jax.jit(functools.partial(jm.encode_w, train=False))(
        variables, style)
    before = {k: t.clone() for k, t in model.netE.state_dict().items()}
    got = model.encode_only({"style_image": style, "label": np.zeros(
        (3, 32, 32), np.int64)})
    np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    for k, t in model.netE.state_dict().items():
        assert torch.equal(t, before[k]), k
    # sample 0's w does not depend on its batch neighbours
    alone = model.encode_only({"style_image": style[:1].repeat(3, 0),
                               "label": np.zeros((3, 32, 32), np.int64)})
    torch.testing.assert_close(alone[0], got[0], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ remat
def count_kernel_forwards(monkeypatch):
    """Counts the norm sites' calls of the ``seg2eye::spade_style`` op (on
    the CPU the plain version; on the card, where each call launches the
    kernel, ``spade_style.launches`` counts the same)."""
    from seg2eye_tpu_torch.models import normalization

    calls = [0]
    forward = normalization.spade_style

    def counting(*args, **kwargs):
        calls[0] += 1
        return forward(*args, **kwargs)

    monkeypatch.setattr(normalization, "spade_style", counting)
    return calls


@pytest.fixture(scope="module")
def remat_reference():
    """JAX's remat iteration from the port's seeded weights: its losses
    and updated variables."""
    opt = tiny_opt(remat=True)
    model = port_model(opt)
    variables = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                                       "D": model.netD})
    batch = make_batch(opt)
    jm = JPix2Pix(jax_opt(opt))
    assert jm.gen.remat
    fns = jsteps.StepFunctions(jm, donate=False)
    state, losses, _ = fns.train_step(_jax_state(jm, fns, variables), batch)
    return opt, batch, jax.device_get(losses), jax.device_get(
        state.variables)


def test_remat_iteration_equals_plain_and_jax(remat_reference, monkeypatch):
    """One G+D iteration with --remat against the same iteration without
    it: losses and gradients to 1e-6 relative, u/v and running statistics
    bit for bit (advanced once, not twice), parameters equal.  The remat
    iteration also equals the JAX package's remat iteration (losses and
    buffers; its gradients are JAX's plain ones, held in
    test_torch_train.py and by tests/test_remat.py).  The norm sites'
    forward runs 36 times in a plain
    iteration and 54 with remat: the backward recomputes the 18 sites of
    the G step (each block's recompute stops after its last saved tensor,
    which is conv_1's input, so no site is skipped)."""
    opt, batch, jax_losses, jax_variables = remat_reference
    calls = count_kernel_forwards(monkeypatch)
    runs = {}
    for remat in (False, True):
        model = port_model(opt.replace(remat=remat))
        calls[0] = 0
        losses, _ = steps.train_step(state_lib.create_state(model), batch)
        runs[remat] = (calls[0], {k: float(v) for k, v in losses.items()},
                       port_grads(model), numpy_state(
                           {"G": model.netG, "E": model.netE,
                            "D": model.netD}))
    (n0, l0, g0, s0), (n1, l1, g1, s1) = runs[False], runs[True]
    assert (n0, n1) == (36, 54)
    for k in l0:
        assert abs(l1[k] - l0[k]) <= REMAT_RTOL * abs(l0[k]), k
    for name in g0:
        for k, g in g0[name].items():
            if g is None:
                assert g1[name][k] is None
                continue
            assert (np.linalg.norm(g1[name][k] - g)
                    <= REMAT_RTOL * np.linalg.norm(g) + 1e-12), (name, k)
    for name in s0:
        for k, t in s0[name].items():
            if k.endswith(("weight_u", "weight_v", "running_mean",
                           "running_var", "num_batches_tracked")):
                assert t.tobytes() == s1[name][k].tobytes(), (name, k)
            else:
                np.testing.assert_allclose(s1[name][k], t, atol=1e-7,
                                           rtol=0, err_msg=f"{name}.{k}")
    assert_losses_close(l1, jax_losses, LOSS_RTOL)
    for name, want in exported(jax_variables, opt).items():
        for k, t in s1[name].items():
            if k.endswith(("weight_u", "weight_v", "running_mean",
                           "running_var")):
                np.testing.assert_allclose(t, want[k], atol=STATE_ATOL,
                                           rtol=0, err_msg=f"{name}.{k}")


def test_remat_recompute_sees_the_forwards_spectral_weights():
    """The recompute uses the u/v of the original forward even when a later
    training forward has advanced them before the backward: the gradient
    equals the one without remat, whose graph kept its own u/v."""
    grads = []
    for remat in (False, True):
        opt = tiny_opt(remat=remat)
        model = port_model(opt)
        seg, style, _ = model.preprocess(make_batch(opt))
        w, _ = model.encode_w(style, update_stats=True)
        loss = model.generate(seg, w, update_stats=True).sum()
        with torch.no_grad():             # u/v advance again in between
            model.generate(seg, w, update_stats=True)
        loss.backward()
        grads.append(model.netG.up_3.conv_0.weight_orig.grad.clone())
    torch.testing.assert_close(grads[1], grads[0], rtol=REMAT_RTOL, atol=0)


# -------------------------------------------------------------------- VGG
def jax_vgg_variables(seed=0, hw=(32, 32)):
    return jax.jit(JVGG19Features().init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3), jnp.float32))


def test_vgg19_features_match_jax():
    """The five relu{1..5}_1 slices of seeded weights on a 2x32x32 input,
    float32, atol 1e-5 relative to each slice's largest value."""
    variables = jax_vgg_variables()
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = jax.jit(JVGG19Features().apply)(variables, x)
    net = VGG19Features()
    net.load_state_dict({k: torch.tensor(v) for k, v in
                         weights.export_vgg19(variables).items()},
                        strict=True)
    assert not any(p.requires_grad for p in net.parameters())
    with torch.no_grad():
        got = net(torch.tensor(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-5 * max(np.abs(w).max(), 1),
                                   rtol=0)


def test_export_vgg19_matches_torch_export():
    variables = jax_vgg_variables(1)
    want = torch_export.export_vgg19(variables)
    got = weights.export_vgg19(variables)
    assert list(got) == list(want) and len(got) == 2 * 13
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def vgg_case(tmp_path_factory):
    """A VGG-on config, the port model with seeded VGG weights from JAX's
    init, their JAX variables, and the weights saved as a torchvision
    ``vgg19`` state_dict (a classifier and the convs past relu5_1
    included)."""
    opt = tiny_opt(no_vgg_loss=False, lambda_vgg=10.0)
    model = port_model(opt)
    variables = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                                       "D": model.netD})
    vgg = jax_vgg_variables(2)
    variables["VGG"] = vgg
    sd = {k: torch.tensor(v) for k, v in weights.export_vgg19(vgg).items()}
    model.netVGG.load_state_dict(sd, strict=True)
    tv = dict(sd)
    for idx in (30, 32, 34):
        tv[f"features.{idx}.weight"] = torch.zeros(512, 512, 3, 3)
        tv[f"features.{idx}.bias"] = torch.zeros(512)
    tv["classifier.0.weight"] = torch.zeros(8, 4)
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    torch.save(tv, path)
    return opt, model, variables, str(path)


def test_generator_loss_with_vgg_matches_jax(vgg_case):
    """The loss dict with the VGG loss on (VGG/weighted, VGG/raw) equals
    JAX's generator loss on the same weights, rtol 1e-4; the torchvision
    state_dict round-trips through JAX's own converter."""
    opt, model, variables, path = vgg_case
    jm = JPix2Pix(jax_opt(opt))
    tpl = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                 variables["VGG"])
    back = torch_convert.convert_vgg19(
        {k: v.numpy() for k, v in torch.load(path).items()}, tpl)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables["VGG"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    batch = make_batch(opt)
    _, (want, _, _) = jax.jit(jm.generator_loss)(variables, batch)
    with torch.no_grad():
        _, got, _ = model.generator_loss(batch)
    assert {"VGG/weighted", "VGG/raw"} <= set(got)
    assert_losses_close({k: float(v) for k, v in got.items()}, want,
                        LOSS_RTOL)
    np.testing.assert_allclose(float(got["VGG/weighted"]),
                               10.0 * float(got["VGG/raw"]), rtol=1e-6)


def test_vgg_weights_load_through_the_loop(vgg_case, tmp_path):
    """--vgg_weights names the torchvision .pth: the loop's networks get
    those VGG weights (frozen, in no optimizer) and the same VGG loss;
    without --vgg_weights the loop refuses to train."""
    opt, model, _, path = vgg_case
    batch = make_batch(opt)

    class Batches:
        def __len__(self):
            return 1

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter([batch])

    with pytest.raises(ValueError, match="--vgg_weights"):
        train(opt.replace(checkpoints_dir=str(tmp_path), name="novgg"),
              max_steps=1, dataloader=Batches(), device="cpu")
    seen = {}

    def hook(n, losses):
        seen.update(losses)

    result = train(opt.replace(checkpoints_dir=str(tmp_path), name="vgg",
                               vgg_weights=path, niter=1, niter_decay=0),
                   max_steps=1, dataloader=Batches(), device="cpu",
                   step_hook=hook)
    state = result["state"]
    loop_vgg = state.model.netVGG
    for k, t in model.netVGG.state_dict().items():
        assert torch.equal(loop_vgg.state_dict()[k], t), k
    optimised = {id(p) for o in (state.opt_g, state.opt_d)
                 for g in o.param_groups for p in g["params"]}
    assert not any(id(p) in optimised or p.requires_grad
                   for p in loop_vgg.parameters())
    # the loop's first G step saw the loss the model gives at its init
    fresh = port_model(opt)
    fresh.netVGG.load_state_dict(loop_vgg.state_dict())
    with torch.no_grad():
        _, want, _ = fresh.generator_loss(batch)
    np.testing.assert_allclose(float(seen["VGG/raw"]),
                               float(want["VGG/raw"]), rtol=1e-6)


# ------------------------------------------------------------ init schemes
SHAPES = [(16, 8, 3, 3), (8, 4, 4, 4), (24, 40)]       # OIHW and (out, in)
TORCH_LAW = {
    "normal": lambda w, g: torch.nn.init.normal_(w, 0.0, 0.02, generator=g),
    "xavier_uniform": lambda w, g: torch.nn.init.xavier_uniform_(
        w, generator=g),
    "kaiming": lambda w, g: torch.nn.init.kaiming_normal_(
        w, nonlinearity="relu", generator=g),
    "orthogonal": lambda w, g: torch.nn.init.orthogonal_(w, 0.02,
                                                         generator=g),
    "none": lambda w, g: torch.nn.init.kaiming_uniform_(
        w, nonlinearity="linear", generator=g),
    "xavier": lambda w, g: torch.nn.init.xavier_normal_(w, 0.02,
                                                        generator=g),
}


@pytest.mark.parametrize("scheme", sorted(TORCH_LAW))
def test_init_scheme_is_torch_law(scheme):
    """Each scheme draws exactly what the torch.nn.init function of the
    same law draws from the same generator."""
    for shape in SHAPES:
        got, want = torch.empty(shape), torch.empty(shape)
        weight_init(scheme, 0.02)(got, torch.Generator().manual_seed(3))
        TORCH_LAW[scheme](want, torch.Generator().manual_seed(3))
        assert torch.equal(got, want), shape


def jax_shape(shape):
    """OIHW (or (out, in)) -> the JAX package's HWIO (or (in, out))."""
    return tuple(shape[2:]) + (shape[1], shape[0]) if len(shape) == 4 \
        else (shape[1], shape[0])


@pytest.mark.parametrize("scheme", ["xavier", "normal", "xavier_uniform",
                                    "kaiming", "orthogonal", "none"])
def test_init_scheme_law_matches_jax(scheme):
    """Against JAX's ``weight_init`` over 40 seeds per shape: the mean
    within 4 standard errors of 0, the standard deviation within 3%, the
    same support (uniform laws) and, for orthogonal, Q Q^T = gain^2 I
    over the (out, in * kh * kw) rows (JAX: the columns of its
    (kh * kw * in, out) matrix; both sides hold at most min(rows, cols))."""
    jinit = jlayers.weight_init(scheme, 0.02)
    for shape in SHAPES:
        jshape = jax_shape(shape)
        ours = torch.stack([weight_init(scheme, 0.02)(
            torch.empty(shape), torch.Generator().manual_seed(s))
            for s in range(40)]).numpy()
        theirs = np.stack([np.asarray(jinit(jax.random.PRNGKey(s), jshape))
                           for s in range(40)])
        sd = theirs.std()
        assert abs(ours.mean()) < 4 * sd / math.sqrt(ours.size), shape
        assert abs(ours.std() / sd - 1) < 0.03, (shape, ours.std(), sd)
        if scheme in ("xavier_uniform", "none"):
            np.testing.assert_allclose(np.abs(ours).max(),
                                       np.abs(theirs).max(), rtol=0.01)
        if scheme == "orthogonal":
            mat = ours.reshape(40, shape[0], -1)
            rows, cols = mat.shape[1:]
            gram = mat @ mat.transpose(0, 2, 1) if rows <= cols else \
                mat.transpose(0, 2, 1) @ mat
            np.testing.assert_allclose(gram, np.broadcast_to(
                0.02 ** 2 * np.eye(min(rows, cols)), gram.shape),
                atol=1e-8)
            jmat = theirs.reshape(40, -1, jshape[-1])
            jgram = jmat.transpose(0, 2, 1) @ jmat if rows <= cols else \
                jmat @ jmat.transpose(0, 2, 1)
            np.testing.assert_allclose(jgram, gram, atol=1e-8)


@pytest.mark.parametrize("scheme", ["normal", "orthogonal", "none"])
def test_init_networks_takes_the_scheme(scheme):
    """init_networks draws every conv and linear from ``opt.init_type``,
    batch sub-norm scales from N(1, init_variance), and trains."""
    opt = tiny_opt(init_type=scheme, **BATCH_NORMS)
    model = port_model(opt)
    conv = model.netD.discriminator_0.model2[0][0].weight_orig
    want = torch.empty_like(conv)
    bn = model.netD.discriminator_0.model2[0][1]
    assert isinstance(bn, BatchSubNorm)
    assert abs(float(bn.weight.mean()) - 1) < 0.05 and bn.weight.std() > 0
    assert not torch.equal(conv, weight_init("xavier", 0.02)(
        want, torch.Generator().manual_seed(0)))
    losses, _ = steps.train_step(state_lib.create_state(model),
                                 make_batch(opt))
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_unknown_init_scheme_raises():
    with pytest.raises(NotImplementedError):
        weight_init("lecun", 0.02)

