"""PyTorch port, checkpoint interop with the JAX package: the port's flax
msgpack codec against flax's own, and the JAX package's files of each
system (Seg2Eye, RefineNet/SegNet, segtrain, serving) read and written by
the port, optimizer states included.

  * codec: bit for bit and dtype for dtype against
    ``flax.serialization.msgpack_restore``, byte for byte against
    ``to_bytes``, chunked arrays (MAX_CHUNK_SIZE patched small) included;
  * a checkpoint trained on one side resumes on the other: one further
    step agrees within ``test_torch_train.py``'s (Seg2Eye) and
    ``test_torch_refinenet_train.py``'s (DeepLab) tolerances, scoring
    within ``test_torch_slice.py``'s;
  * port -> .ckpt -> port is bit for bit on every parameter, buffer (but
    ``num_batches_tracked``, which the JAX format has no place for) and
    optimizer tensor.
"""
import functools
import importlib.util
import os
import re
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.train import state as jstate
from seg2eye_tpu.train import steps as jsteps
from seg2eye_tpu.utils import checkpoint as jcheckpoint
from seg2eye_tpu.utils import torch_convert
from seg2eye_tpu_torch.eval import tester as port_tester
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.utils import checkpoint, flax_msgpack, weights
from test_torch_slice import ATOL, SCORE_RTOL, jax_scores
from test_torch_train import (LOSS_RTOL, PARAM_ATOL, STATE_ATOL, exported,
                              is_buffer, jax_opt, make_batch, port_model,
                              tiny_opt)

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid",
                                        "ignore:The given NumPy array")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ codec
def assert_same_tree(got, want, path="", ordered=True):
    """Maps with the same keys (in the same order, when ``ordered``);
    arrays with the same dtype, shape and bits (a bfloat16 array: a
    torch.bfloat16 tensor with JAX's bits); other leaves equal and of the
    same type."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        if ordered:
            assert list(got) == list(want), path
        assert set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}", ordered)
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            assert got.view(torch.int16).numpy().tobytes() == \
                want.view(np.int16).tobytes(), path
            assert tuple(got.shape) == want.shape, path
            return
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def tiny_seg2eye_state():
    """A JAX Seg2Eye TrainState at the tiny config, weight decay on (the
    three-member chain under the fc_var mask)."""
    opt = jax_opt(tiny_opt(weight_decay=1e-4))
    return opt, jstate.create_state(JPix2Pix(opt), jax.random.PRNGKey(0))


def codec_trees(rn_state, seg_state):
    rng = np.random.default_rng(0)
    opt, state = tiny_seg2eye_state()
    state = jax.device_get(state)
    aux = {"step": state.step, "opt_g": state.opt_g, "opt_d": state.opt_d}
    leaves = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "i64": np.arange(7, dtype=np.int64) - 3,
              "u8": rng.integers(0, 256, (70000,), dtype=np.uint8),
              "bool": np.asarray([True, False]), "f16": np.ones(3, np.float16),
              "bf16": jnp.arange(4, dtype=jnp.bfloat16),
              "empty": np.zeros((0, 2), np.float32),
              "scalars": (np.float32(2.5), np.asarray(3, np.int32), 1, -1,
                          300, -200, 2 ** 40, -2 ** 40, 1.5, "x" * 40, None,
                          True, b"raw"),
              "masked": {}}
    return {"seg2eye-nets": dict(state.variables),
            "seg2eye-optim": aux,
            "refinenet-state": jax.device_get(rn_state),
            "segtrain-payload": {"epoch": 3, "best_pred": np.float64(0.25),
                                 **seg_state},
            "leaves": leaves}


@pytest.fixture(scope="module")
def trees(rn_jax, seg_jax):
    """Seg2Eye's nets and optimizer aux (weight decay on: the masked
    three-member chain), a RefineNet train state (clip, decay, trace),
    a segtrain payload (decay, trace, masked scale) and loose leaves."""
    return codec_trees(
        rn_jax("refinenet", "resnet")[1].init_state(jax.random.PRNGKey(0)),
        seg_jax[2])


@pytest.mark.parametrize("case", ["seg2eye-nets", "seg2eye-optim",
                                  "refinenet-state", "segtrain-payload",
                                  "leaves"])
def test_codec_restores_flax_bytes(trees, case):
    """The port's restore of flax's bytes equals flax's own restore leaf for
    leaf, and the port writes the same bytes for that tree."""
    data = flax.serialization.to_bytes(trees[case])
    want = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    assert_same_tree(got, want)
    assert flax_msgpack.serialize(got) == data


@pytest.mark.parametrize("case", ["seg2eye-nets", "seg2eye-optim",
                                  "refinenet-state", "segtrain-payload"])
def test_flax_restores_port_bytes(trees, case, tmp_path):
    """flax's ``from_bytes`` into the original tree (optax namedtuples,
    EmptyState, MaskedNode and all) restores what the port wrote."""
    tree = trees[case]
    plain = flax_msgpack.restore(flax.serialization.to_bytes(tree))
    path = str(tmp_path / "x.ckpt")
    n = flax_msgpack.write(path, plain)
    with open(path, "rb") as f:
        data = f.read()
    assert n == len(data)
    back = flax.serialization.from_bytes(tree, data)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_codec_chunked_arrays_both_ways(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE: flax's chunked form read by the port,
    the port's read by flax, the bytes identical."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((10, 7)).astype(np.float32),
            "n": {"i": np.arange(100, dtype=np.int32),
                  "small": np.ones(3, np.float32)}}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_same_tree(flax_msgpack.restore(data),
                     flax.serialization.msgpack_restore(data))
    ours = flax_msgpack.serialize(tree)
    assert ours == data
    assert_same_tree(flax.serialization.msgpack_restore(ours),
                     flax.serialization.msgpack_restore(data))


def test_codec_refuses_unknown_dtype_and_garbage():
    """A dtype name numpy does not know (here: float32's, renamed in the
    bytes) and a truncated file raise."""
    data = flax.serialization.to_bytes({"x": np.zeros(2, np.float32)})
    assert data.count(b"\xa7float32") == 1
    with pytest.raises(ValueError, match="float99"):
        flax_msgpack.restore(data.replace(b"\xa7float32", b"\xa7float99"))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(flax.serialization.to_bytes(
            {"x": np.ones(4, np.float32)})[:-3])


def test_check_like_refuses_other_structure():
    want = {"a": np.zeros((2, 3), np.float32), "b": {"c": np.zeros(2)}}
    flax_msgpack.check_like({"a": np.ones((2, 3), np.float32),
                             "b": {"c": np.ones(2)}}, want, "x")
    with pytest.raises(ValueError, match="keys"):
        flax_msgpack.check_like({"a": np.ones((2, 3), np.float32)}, want, "x")
    with pytest.raises(ValueError, match="shape"):
        flax_msgpack.check_like({"a": np.ones((3, 2), np.float32),
                                 "b": {"c": np.ones(2)}}, want, "x")


# ---------------------------------------------------------------- Seg2Eye
@pytest.fixture(scope="module")
def seg2eye(tmp_path_factory):
    """The tiny config and the JAX package's compiled steps for it."""
    root = tmp_path_factory.mktemp("seg2eye")
    opt = tiny_opt(checkpoints_dir=str(root), name="exp")
    jopt = jax_opt(opt)
    jm = JPix2Pix(jopt)
    fns = jsteps.StepFunctions(jm, donate=False)
    batches = [make_batch(opt, seed) for seed in range(3)]
    return opt, jopt, jm, fns, batches


def port_nets(model):
    return {"G": model.netG, "E": model.netE, "D": model.netD}


def assert_step_agrees(pstate, plosses, jstate_, jlosses, opt):
    """One further step on each side: losses to LOSS_RTOL, buffers to
    STATE_ATOL, parameters to PARAM_ATOL but where the port's gradient is
    round-off, where Adam at beta1 = 0 may step either way (at most 2 lr;
    ``test_torch_train.assert_params_close``)."""
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(plosses[k]), float(jnp.mean(v)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    want = exported(jax.device_get(jstate_.variables), opt)
    for name, net in port_nets(pstate.model).items():
        params = dict(net.named_parameters())
        for k, t in net.state_dict().items():
            got = t.numpy()
            if is_buffer(k):
                np.testing.assert_allclose(got, want[name][k], atol=STATE_ATOL,
                                           rtol=0, err_msg=f"{name}.{k}")
            elif k in params:
                diff = np.abs(got - want[name][k])
                g = params[k].grad
                if g is None:
                    assert not diff.any(), f"{name}.{k}"
                    continue
                g = np.abs(g.numpy())
                noise = g <= 1e-5 * g.max() + 1e-7
                assert np.all(diff[~noise] <= PARAM_ATOL), f"{name}.{k}"
                assert np.all(diff[noise] <= 2 * opt.lr * 2 + PARAM_ATOL), \
                    f"{name}.{k}"


def jax_train(fns, state, batches):
    for batch in batches:
        state, losses, _ = fns.train_step(state, batch)
    return state, losses


def test_jax_checkpoint_resumes_in_port(seg2eye):
    """JAX trains 2 iterations and saves; the port's load_state reads the
    .ckpt files: the scored batch agrees with JAX's inference, and one
    further iteration with JAX's."""
    opt, jopt, jm, fns, batches = seg2eye
    js, _ = jax_train(fns, jstate.create_state(jm, jax.random.PRNGKey(1)),
                      batches[:2])
    jcheckpoint.save_state(js, jopt, "jaxrun")
    assert checkpoint.checkpoint_format(opt, "jaxrun") == "flax"
    pstate = state_lib.create_state(port_model(opt, seed=5))
    checkpoint.load_state(pstate, opt, "jaxrun")
    assert pstate.step == 2
    assert all(int(s["step"]) == 2 for s in pstate.opt_g.state.values())
    fc_var = set(pstate.model.netE.fc_var.parameters())
    assert not fc_var & set(pstate.opt_g.state)

    score = dict(batches[2], target_original=np.random.default_rng(9)
                 .integers(0, 256, (2, 640, 400, 1), dtype=np.uint8))
    errors, fake = port_tester.Tester(opt).score_batch(pstate.model, score)
    jfake, jerrors = jax_scores(jopt, jax.device_get(js.variables), score)
    np.testing.assert_allclose(fake, jfake, atol=ATOL)
    np.testing.assert_allclose(errors, jerrors, rtol=SCORE_RTOL)

    plosses, _ = steps.train_step(pstate, batches[2])
    js, jlosses = jax_train(fns, js, batches[2:])
    assert_step_agrees(pstate, plosses, js, jlosses, opt)


def test_port_checkpoint_resumes_in_jax(seg2eye):
    """The port trains 2 iterations and writes the JAX package's files;
    JAX's load_state(strict=True) restores them, and one further
    iteration agrees."""
    opt, jopt, jm, fns, batches = seg2eye
    pstate = state_lib.create_state(port_model(opt, seed=2))
    for batch in batches[:2]:
        steps.train_step(pstate, batch)
    sizes = checkpoint.save_state_jax(pstate, opt, "portrun")
    assert set(sizes) == {"portrun_net_G.ckpt", "portrun_net_D.ckpt",
                          "portrun_net_E.ckpt", "portrun_optim.ckpt"}
    template = jstate.create_state(jm, jax.random.PRNGKey(3))
    js = jcheckpoint.load_state(template, jopt, "portrun", strict=True)
    assert int(js.step) == 2
    assert int(js.opt_g.inner_state.inner_state[0].count) == 2
    plosses, _ = steps.train_step(pstate, batches[2])
    js, jlosses = jax_train(fns, js, batches[2:])
    assert_step_agrees(pstate, plosses, js, jlosses, opt)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_port_round_trip_is_bitwise(seg2eye, weight_decay):
    """Port -> .ckpt -> a fresh port state: every parameter, buffer and
    Adam tensor bit for bit, the step count too."""
    opt = seg2eye[0].replace(weight_decay=weight_decay)
    a = state_lib.create_state(port_model(opt, seed=2))
    for batch in seg2eye[4][:2]:
        steps.train_step(a, batch)
    checkpoint.save_state_jax(a, opt, f"rt{weight_decay}")
    b = state_lib.create_state(port_model(opt, seed=7))
    checkpoint.load_state(b, opt, f"rt{weight_decay}")
    assert b.step == a.step == 2
    for name, net in port_nets(a.model).items():
        other = port_nets(b.model)[name].state_dict()
        for k, t in net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(t, other[k]), f"{name}.{k}"
    for oa, ob in ((a.opt_g, b.opt_g), (a.opt_d, b.opt_d)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
                assert sa[i][k].dtype == sb[i][k].dtype


def test_seg2eye_refusals(seg2eye):
    """A .pth and a .ckpt of one epoch, a .ckpt of another configuration,
    and learning rates off the port's schedule all raise."""
    opt = seg2eye[0]
    a = state_lib.create_state(port_model(opt, seed=2))
    checkpoint.save_state_jax(a, opt, "both")
    checkpoint.save_state(a, opt, "both")
    with pytest.raises(ValueError, match="both"):
        checkpoint.load_state(a, opt, "both")
    checkpoint.save_state_jax(a, opt, "other")
    wider = opt.replace(ngf=8)
    with pytest.raises(ValueError, match="expected"):
        checkpoint.load_networks(port_nets(port_model(wider)), wider, "other")
    off = opt.replace(lr=opt.lr * 3)
    with pytest.raises(ValueError, match="schedule"):
        checkpoint.load_state(state_lib.create_state(port_model(off)), off,
                              "other")


# -------------------------------------------------------- RefineNet/SegNet
from seg2eye_tpu.refinenet import checkpoint_manager as jckpt  # noqa: E402
from seg2eye_tpu.refinenet import training as jtraining  # noqa: E402
from seg2eye_tpu_torch.refinenet import checkpoint_manager as pckpt  # noqa
from seg2eye_tpu_torch.refinenet import training  # noqa: E402
from test_torch_refinenet import F32_ATOL, jax_cfg, tiny_cfg  # noqa: E402
from test_torch_refinenet_train import (KINDS, STEP_ATOL,  # noqa: E402
                                        STEP_CFG, distances, snapshot,
                                        step_batches)

RN_CASES = [("refinenet", "resnet"), ("segnet", "mobilenet")]
RN_STEPS_PER_EPOCH = 4     # the in-memory loader's 16 images at batch 4


class Batches:
    """main_loop's loader interface over batches in memory."""

    def __init__(self, batches, n_images):
        self.batches = batches
        self.dataset = [None] * n_images

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def rn_jax():
    """Per case: (cfg, the JAX Trainer, its jitted train step without
    dropout), float32."""
    cache = {}

    def get(kind, backbone):
        if (kind, backbone) not in cache:
            _, jm_cls, key, momentum, clip = KINDS[kind]
            cfg = tiny_cfg(backbone=backbone, gradient_norm_clip=clip,
                           **STEP_CFG)
            trainer = jtraining.Trainer(jm_cls(jax_cfg(cfg)), jax_cfg(cfg),
                                        key, momentum=momentum, donate=False)
            step = jax.jit(lambda s, b, lr: trainer._train_step(s, b, lr,
                                                                None))
            cache[kind, backbone] = (cfg, trainer, step)
        return cache[kind, backbone]
    return get


def rn_lr(cfg, i):
    return training.learning_rate_schedule(cfg, RN_STEPS_PER_EPOCH, i)


def rn_jax_steps(step, state, batches, cfg, start=0):
    for i, batch in enumerate(batches):
        state, scalars, _ = step(state, jax.tree_util.tree_map(jnp.asarray,
                                                               batch),
                                 jnp.asarray(rn_lr(cfg, start + i),
                                             jnp.float32))
    return state, scalars


def rn_port_state(kind, cfg, seed=0):
    m_cls, _, key, momentum, _ = KINDS[kind]
    trainer = training.Trainer(m_cls(cfg, "cpu"), cfg, key, momentum)
    return trainer, trainer.init_state(torch.Generator().manual_seed(seed))


def assert_port_state_is(state, jstate_, backbone):
    """The port's weights, running statistics and momentum bit for bit
    the JAX state's."""
    net = state.model.net
    want = weights.deeplab_from_jax_variables(
        jax.device_get(jstate_["variables"]), backbone)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    trace = next(s for s in jstate_["opt"].inner_state if hasattr(s, "trace"))
    trace = weights.export_deeplab(
        {"params": jax.device_get(trace.trace),
         "batch_stats": jax.device_get(jstate_["variables"]["batch_stats"])},
        backbone)
    for n, p in net.named_parameters():
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           torch.from_numpy(np.asarray(trace[n]))), n
    assert state.step == int(jstate_["step"])


def rn_step_agrees(kind, trainer, state, jx_step, jstate_, batch, lr):
    """One further step on each side from the same (loaded) state: losses,
    parameters and running statistics to STEP_ATOL."""
    _, _, _, momentum, _ = KINDS[kind]
    before = snapshot(state)
    jnew, jscal, _ = jx_step(jstate_, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                             jnp.asarray(lr, jnp.float32))
    trace = next(s for s in jnew["opt"].inner_state if hasattr(s, "trace"))
    want = jax.device_get((jscal, jnew["variables"], trace.trace))
    scalars, _ = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, lr)
    net = state.model.net
    got = ({k: float(v) for k, v in scalars.items()},
           {k: v.clone() for k, v in net.state_dict().items()},
           {n: state.optimizer.state[p]["momentum_buffer"].clone()
            for n, p in net.named_parameters()},
           {n: p.grad.clone() for n, p in net.named_parameters()})
    d = distances(got, want, before, trainer.cfg.weight_decay, momentum,
                  trainer.cfg.backbone)
    for k in ("scalars", "params", "stats"):
        assert d[k] <= STEP_ATOL, d


def jax_eval(jtrainer, variables, batch):
    return jax.device_get(jax.jit(jtrainer._eval_step)(
        variables, jax.tree_util.tree_map(jnp.asarray, batch)))


@pytest.mark.parametrize("kind,backbone", RN_CASES)
def test_jax_refinenet_checkpoint_resumes_in_port(rn_jax, kind, backbone,
                                                  tmp_path):
    """JAX trains 2 steps and its CheckpointManager saves; the port's
    manager loads 0000002.ckpt: weights, statistics and momentum bit for
    bit, eval outputs to F32_ATOL, one further step to STEP_ATOL."""
    cfg, jtrainer, jx_step = rn_jax(kind, backbone)
    batches = step_batches(kind, 3)
    js = jtrainer.init_state(jax.random.PRNGKey(0))
    js, _ = rn_jax_steps(jx_step, js, batches[:2], cfg)
    jckpt.CheckpointManager(str(tmp_path)).save_at_step(2, js)
    trainer, state = rn_port_state(kind, cfg, seed=4)
    mgr = pckpt.CheckpointManager(str(tmp_path))
    step, state = mgr.load_last_checkpoint(state, lambda i: rn_lr(cfg, i))
    assert step == 2
    assert_port_state_is(state, js, backbone)
    got = trainer.eval_step(state, {k: torch.from_numpy(v)
                                    for k, v in batches[2].items()})
    want = jax_eval(jtrainer, js["variables"], batches[2])
    for k in ("prediction",):
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=F32_ATOL)
    rn_step_agrees(kind, trainer, state, jx_step, js, batches[2],
                   rn_lr(cfg, 2))


@pytest.mark.parametrize("kind,backbone", RN_CASES)
def test_port_refinenet_checkpoint_resumes_in_jax(rn_jax, kind, backbone,
                                                  tmp_path):
    """The port trains 2 steps and writes a JAX checkpoint; the JAX
    manager restores it into its train state (momentum included), bit for
    bit, and one further step agrees; port -> .ckpt -> port is bitwise."""
    cfg, jtrainer, jx_step = rn_jax(kind, backbone)
    batches = step_batches(kind, 3, seed=1)
    trainer, state = rn_port_state(kind, cfg, seed=2)
    for i, batch in enumerate(batches[:2]):
        trainer.train_step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, rn_lr(cfg, i))
    pckpt.CheckpointManager(str(tmp_path)).save_at_step(2, state, fmt="flax")
    template = jtrainer.init_state(jax.random.PRNGKey(1))
    step, js = jckpt.CheckpointManager(str(tmp_path)).load_last_checkpoint(
        template)
    assert step == 2 and int(js["opt"].count) == 2
    assert float(js["opt"].hyperparams["learning_rate"]) == \
        np.float32(rn_lr(cfg, 1))
    assert_port_state_is(state, js, backbone)

    _, again = rn_port_state(kind, cfg, seed=6)
    pckpt.CheckpointManager(str(tmp_path)).load_last_checkpoint(again)
    for k, v in state.model.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, again.model.net.state_dict()[k]), k
    for p, q in zip(state.model.net.parameters(),
                    again.model.net.parameters()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           again.optimizer.state[q]["momentum_buffer"])
    rn_step_agrees(kind, trainer, state, jx_step, js, batches[2],
                   rn_lr(cfg, 2))


def test_main_loop_resumes_a_jax_run(rn_jax, tmp_path):
    """main_loop(resume_from) on a JAX run's directory starts at the
    filename's step, checks the learning rate against its schedule, and
    writes the port's format beside the JAX checkpoint, which the port's
    manager reads back bit for bit; a learning rate off the schedule is
    refused."""
    kind, backbone = RN_CASES[1]
    cfg, jtrainer, jx_step = rn_jax(kind, backbone)
    batches = step_batches(kind, 4, seed=2)
    js = jtrainer.init_state(jax.random.PRNGKey(0))
    js, _ = rn_jax_steps(jx_step, js, batches[:3], cfg)
    run = tmp_path / "run"
    jckpt.CheckpointManager(str(run)).save_at_step(3, js)
    loader = Batches(batches, RN_STEPS_PER_EPOCH * cfg.batch_size)
    m_cls, _, key, momentum, _ = KINDS[kind]
    off = cfg.replace(base_learning_rate=cfg.base_learning_rate * 2,
                      resume_from=str(run), max_steps=1)
    with pytest.raises(ValueError, match="learning rate"):
        training.main_loop(m_cls(off, "cpu"), off, loader, {}, loss_key=key,
                           momentum=momentum)
    result = training.main_loop(
        m_cls(cfg, "cpu"), cfg.replace(resume_from=str(run), max_steps=1),
        loader, {}, loss_key=key, momentum=momentum)
    assert result["steps"] == 4 and result["state"].step == 4
    ckpts = run / "checkpoints"
    assert flax_msgpack.is_flax_msgpack(str(ckpts / "0000003.ckpt"))
    assert not flax_msgpack.is_flax_msgpack(str(ckpts / "0000004.ckpt"))
    _, back = rn_port_state(kind, cfg, seed=9)
    step, back = pckpt.CheckpointManager(str(run)).load_last_checkpoint(back)
    assert step == 4 and back.step == 4
    live = result["state"]
    for k, v in live.model.net.state_dict().items():
        assert torch.equal(v, back.model.net.state_dict()[k]), k
    for p, q in zip(live.model.net.parameters(), back.model.net.parameters()):
        assert torch.equal(live.optimizer.state[p]["momentum_buffer"],
                           back.optimizer.state[q]["momentum_buffer"])


# ---------------------------------------------------------------- segtrain
import flax.linen as nn  # noqa: E402

from seg2eye_tpu.segtrain import saver as jsaver  # noqa: E402
from seg2eye_tpu_torch.segtrain import saver as psaver  # noqa: E402
from test_torch_segtrain import (STEP_LR, JaxSegSteps,  # noqa: E402
                                 no_dropout, port_args, port_trainer)
from test_torch_segtrain import step_batches as seg_batches  # noqa: E402


@pytest.fixture(scope="module")
def seg_jax():
    """JAX's segtrain steps at ResNet-14, crop 33 (``test_torch_segtrain``):
    the float32 trainer and a fresh JAX state."""
    jx = JaxSegSteps(port_args(lr=STEP_LR))
    t = jx.trainer("f32")
    v = jax.device_get(jx.model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 33, 33, 3)), train=False))
    return jx, t, {"params": v["params"], "batch_stats": v["batch_stats"],
                   "opt": t.tx.init(v["params"])}


def seg_jax_step(t, state, image, label, lr):
    with nn.intercept_methods(no_dropout):
        new, loss, _ = t.train_fn(state, image, label,
                                  jnp.asarray(lr, jnp.float32),
                                  jax.random.PRNGKey(0))
    return jax.device_get(new), float(loss)


def assert_seg_state_is(t, state):
    """The port trainer's weights, statistics and momentum bit for bit the
    JAX state's."""
    want = weights.deeplab_from_jax_variables(state, "resnet")
    for k, v in t.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    trace = next(s for s in state["opt"].inner_state if hasattr(s, "trace"))
    trace = weights.export_deeplab({"params": trace.trace,
                                    "batch_stats": state["batch_stats"]},
                                   "resnet")
    for n, p in t.net.named_parameters():
        assert torch.equal(t.optimizer.state[p]["momentum_buffer"],
                           torch.from_numpy(np.asarray(trace[n]))), n


def seg_step_agrees(t, state, jt, image, label, lr):
    """One further step on each side: loss, parameters and running
    statistics to STEP_ATOL."""
    new, jloss = seg_jax_step(jt, state, image, label, lr)
    loss, _ = t.train_step(torch.from_numpy(image), torch.from_numpy(label),
                           lr)
    assert abs(float(loss) - jloss) <= STEP_ATOL * (1 + abs(jloss))
    want = weights.deeplab_from_jax_variables(new, "resnet")
    for k, v in t.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert float((v - want[k]).abs().max()) <= STEP_ATOL, k


def test_jax_segtrain_checkpoint_resumes_in_port(seg_jax, tmp_path,
                                                 monkeypatch):
    """JAX trains one epoch of 3 steps and its Saver writes
    checkpoint.ckpt; ``--resume`` reads it into the port's SegTrainer
    (epoch, best_pred, weights, momentum bit for bit, the learning rate
    checked), one further step agrees; the port writes its own format by
    default and the JAX format on request, which the JAX Saver
    restores."""
    jx, jt, state = seg_jax
    batches = seg_batches(4, seed=3)
    t = port_trainer(tmp_path, monkeypatch)
    for i, (image, label) in enumerate(batches[:3]):
        state, _ = seg_jax_step(jt, state, image, label, t.scheduler(i, 0))
    path = jsaver.Saver(port_args(checkname="jax")).save_checkpoint(
        {"epoch": 1, "best_pred": np.float64(0.375), **state}, False)
    r = port_trainer(tmp_path, monkeypatch, resume=path, checkname="port")
    assert r.args.start_epoch == 1 and r.best_pred == 0.375
    assert_seg_state_is(r, state)
    image, label = batches[3]
    seg_step_agrees(r, state, jt, image, label, r.scheduler(0, 1))
    assert "state_dict" in r.checkpoint_state(1)
    out = r.saver.save_checkpoint(r.checkpoint_state(1, "flax"), False,
                                  fmt="flax")
    back = jsaver.Saver.load_checkpoint(
        {"epoch": 0, "best_pred": 0.0, **seg_jax[2]}, out)
    assert back["epoch"] == 2 and back["best_pred"] == 0.375
    assert int(back["opt"].count) == 6

    with pytest.raises(ValueError, match="learning rate"):
        port_trainer(tmp_path, monkeypatch, resume=path, epochs=5)
    ft = port_trainer(tmp_path, monkeypatch, resume=path, epochs=5, ft=True)
    assert not ft.optimizer.state and ft.args.start_epoch == 0


def test_port_segtrain_checkpoint_resumes_in_jax(seg_jax, tmp_path,
                                                 monkeypatch):
    """The port trains 2 steps and its Saver writes the JAX format; the JAX
    Saver restores it (momentum included) bit for bit, one further step
    agrees, and port -> .ckpt -> port is bitwise."""
    jx, jt, fresh = seg_jax
    batches = seg_batches(3, seed=4)
    t = port_trainer(tmp_path, monkeypatch)
    for i, (image, label) in enumerate(batches[:2]):
        t.train_step(torch.from_numpy(image), torch.from_numpy(label),
                     t.scheduler(i, 0))
    t.best_pred = 0.5
    path = t.saver.save_checkpoint(t.checkpoint_state(0, "flax"), True,
                                   fmt="flax")
    assert os.path.exists(os.path.join(t.saver.directory, "model_best.ckpt"))
    state = jsaver.Saver.load_checkpoint({"epoch": 0, "best_pred": 0.0,
                                          **fresh}, path)
    assert state["epoch"] == 1 and state["best_pred"] == 0.5
    assert_seg_state_is(t, state)

    again = port_trainer(tmp_path, monkeypatch, checkname="again")
    payload = psaver.Saver.load_checkpoint(path)
    from seg2eye_tpu_torch.segtrain.trainer import load_jax_payload
    load_jax_payload(again.net, again.optimizer, again.args, payload, path)
    for k, v in t.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, again.net.state_dict()[k]), k
    for p, q in zip(t.net.parameters(), again.net.parameters()):
        assert torch.equal(t.optimizer.state[p]["momentum_buffer"],
                           again.optimizer.state[q]["momentum_buffer"])
    image, label = batches[2]
    state = {k: state[k] for k in ("params", "batch_stats", "opt")}
    seg_step_agrees(t, state, jt, image, label, t.scheduler(2, 0))


# ---------------------------------------------------------------- serving
from seg2eye_tpu.serving import export_inference as jexport_inference  # noqa
from seg2eye_tpu.serving import load_serving as jload_serving  # noqa: E402
from seg2eye_tpu.options import Options as JOptions  # noqa: E402
from seg2eye_tpu_torch.serving import load_serving  # noqa: E402
from test_torch_serving import ATOL as SERVE_ATOL  # noqa: E402
from test_torch_serving import (NATIVE_HW, batch_of,  # noqa: E402
                                jax_variables, refiner_pair, run_cli,
                                small_opt)


def test_jax_seg2eye_artifact_exports_in_port(tmp_path):
    """A JAX Seg2Eye artifact's variables.msgpack and meta.json through
    ``export_seg2eye --jax_artifact`` (verified against the live model):
    the port's artifact serves what the JAX artifact serves, to the
    serving tests' ATOL."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport_inference(JPix2Pix(small_opt(JOptions)), jax_variables(), jdir,
                      native_hw=NATIVE_HW, platforms=("cpu",))
    proc = run_cli("seg2eye_tpu_torch.serving.export_seg2eye",
                   ["--jax_artifact", jdir, "--out_dir", pdir])
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
    served, jserved = load_serving(pdir), jload_serving(jdir)
    assert served.meta["native_hw"] == list(NATIVE_HW)
    label, style = batch_of(small_opt(), 3, seed=2)
    fake, f255 = served(label, style)
    jfake, jf255 = jserved(label, style)
    np.testing.assert_allclose(fake.numpy(), jfake, atol=SERVE_ATOL, rtol=0)
    assert np.abs(f255.numpy() - jf255).max() <= 1


def test_jax_refiner_artifact_exports_in_port(tmp_path):
    """A JAX RefineNet artifact through ``export_refiner --jax_artifact``:
    its predictions are the JAX artifact's to ATOL."""
    jserved, _, _ = refiner_pair("refinenet", tmp_path, 3)
    pdir = str(tmp_path / "from_jax")
    proc = run_cli("seg2eye_tpu_torch.serving.export_refiner",
                   ["--jax_artifact", str(tmp_path / "jax"), "--out_dir",
                    pdir])
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
    served = load_serving(pdir)
    assert served.meta["model_type"] == "refinenet"
    x = np.random.default_rng(1).integers(0, 256, (2, 64, 40, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(served(x)[0].numpy(), jserved(x)[0],
                               atol=SERVE_ATOL, rtol=0)


# ------------------------------------- the JAX package's own .pth bridges
def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_export_torch_checkpoint_pth_strict_loads_into_port(seg2eye,
                                                            tmp_path,
                                                            monkeypatch):
    """``tools/export_torch_checkpoint.py`` (the JAX package's .pth
    writer) on a JAX Seg2Eye run: its G, E and D .pth strict-load through
    the port's ``load_networks``, equal to what the port reads from the
    .ckpt files themselves."""
    opt, jopt, jm, fns, _ = seg2eye
    js = jstate.create_state(jm, jax.random.PRNGKey(4))
    jcheckpoint.save_state(js, jopt, "tool")
    out = tmp_path / "ref"
    monkeypatch.setattr(sys, "argv", [
        "export_torch_checkpoint.py", "--checkpoints_dir",
        opt.checkpoints_dir, "--name", opt.name, "--which_epoch", "tool",
        "--out_dir", str(out)])
    load_tool("export_torch_checkpoint").main()
    from_pth = port_nets(port_model(opt, seed=1))
    checkpoint.load_networks(from_pth, opt.replace(checkpoints_dir=str(
        tmp_path), name="ref"), "tool")
    from_ckpt = port_nets(port_model(opt, seed=2))
    checkpoint.load_networks(from_ckpt, opt, "tool")
    for name, net in from_pth.items():
        other = from_ckpt[name].state_dict()
        for k, v in net.state_dict().items():
            assert torch.equal(v, other[k]), f"{name}.{k}"


def test_port_pth_loads_through_torch_convert(seg2eye):
    """The port's own .pth files through the JAX package's
    ``torch_convert.convert_{generator,encoder,discriminator}`` give the
    variables the port writes into its .ckpt files, bit for bit."""
    opt, jopt, jm, _, batches = seg2eye
    state = state_lib.create_state(port_model(opt, seed=3))
    steps.train_step(state, batches[0])
    checkpoint.save_state(state, opt, "pth")
    template = jax.device_get(jm.init_variables(jax.random.PRNGKey(0),
                                                with_disc=True))
    ours = weights.to_jax_variables(port_nets(state.model))
    for name, convert in (("G", torch_convert.convert_generator),
                          ("E", functools.partial(
                              torch_convert.convert_encoder,
                              w_dim=opt.w_dim)),
                          ("D", torch_convert.convert_discriminator)):
        sd = {k: v.numpy() for k, v in torch.load(
            checkpoint.network_path(opt, "pth", name),
            weights_only=True).items()}
        got = convert(sd, template[name])
        assert_same_tree(ours[name], dict(got), ordered=False)


# -------------------------------------- tools/convert_checkpoint_torch.py
def _same_torch(a, b, path=""):
    """Nested dicts/lists of tensors and numbers, equal bit for bit; BN
    ``num_batches_tracked`` (no place in the JAX format) skipped."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if not str(k).endswith("num_batches_tracked"):
                _same_torch(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_torch(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("system", ["seg2eye", "refinenet", "segtrain"])
def test_convert_tool_round_trip(system, seg2eye, rn_jax, seg_jax, tmp_path,
                                 monkeypatch):
    """The port's checkpoint of each system through the tool to the JAX
    format, which the JAX package restores (strictly, optimizer state
    included), and back: the port's files again, bit for bit."""
    tool = load_tool("convert_checkpoint_torch")
    if system == "seg2eye":
        opt = seg2eye[0].replace(checkpoints_dir=str(tmp_path), name="run")
        state = state_lib.create_state(port_model(opt, seed=8))
        steps.train_step(state, seg2eye[4][0])
        opt.save()
        checkpoint.save_state(state, opt, "latest")
        assert tool.main(["seg2eye", "--expr_dir", opt.expr_dir,
                          "--out_dir", str(tmp_path / "jax")]) == 0
        jopt = seg2eye[1].replace(checkpoints_dir=str(tmp_path), name="jax")
        js = jcheckpoint.load_state(jstate.create_state(
            seg2eye[2], jax.random.PRNGKey(0)), jopt, "latest", strict=True)
        assert int(js.step) == 1
        assert tool.main(["seg2eye", "--expr_dir", str(tmp_path / "jax"),
                          "--out_dir", str(tmp_path / "back")]) == 0
        for f in ("latest_net_G.pth", "latest_net_D.pth", "latest_net_E.pth",
                  "latest_optim.pth"):
            _same_torch(torch.load(tmp_path / "run" / f, weights_only=True),
                        torch.load(tmp_path / "back" / f, weights_only=True),
                        f)
    elif system == "refinenet":
        kind, backbone = RN_CASES[0]
        cfg, jtrainer, _ = rn_jax(kind, backbone)
        trainer, state = rn_port_state(kind, cfg, seed=3)
        trainer.train_step(state, {k: torch.from_numpy(v) for k, v in
                                   step_batches(kind, 1)[0].items()}, 1e-3)
        run = tmp_path / "run"
        os.makedirs(run)
        (run / "config.json").write_text(cfg.full_json())
        src = pckpt.CheckpointManager(str(run)).save_at_step(1, state)
        assert tool.main(["refinenet", "--run_dir", str(run), "--out_dir",
                          str(tmp_path / "jax")]) == 0
        step, js = jckpt.CheckpointManager(str(tmp_path / "jax")) \
            .load_last_checkpoint(jtrainer.init_state(jax.random.PRNGKey(0)))
        assert step == 1 and int(js["step"]) == 1
        assert tool.main(["refinenet", "--run_dir", str(tmp_path / "jax"),
                          "--out_dir", str(tmp_path / "back")]) == 0
        a, b = (torch.load(p, weights_only=True) for p in (
            src, tmp_path / "back" / "checkpoints" / "0000001.ckpt"))
        _same_torch(a["model"], b["model"])
        _same_torch(a["optimizer"]["state"], b["optimizer"]["state"])
        assert a["step"] == b["step"] == 1
    else:
        t = port_trainer(tmp_path, monkeypatch)
        image, label = seg_batches(1, seed=5)[0]
        t.train_step(torch.from_numpy(image), torch.from_numpy(label), 1e-3)
        t.best_pred = 0.25
        src = t.saver.save_checkpoint(t.checkpoint_state(0), False)
        out, back = str(tmp_path / "jax.ckpt"), str(tmp_path / "back.ckpt")
        assert tool.main(["segtrain", "--checkpoint", src, "--out", out,
                          "--weight-decay", str(t.args.weight_decay),
                          "--momentum", str(t.args.momentum)]) == 0
        state = jsaver.Saver.load_checkpoint(
            {"epoch": 0, "best_pred": 0.0, **seg_jax[2]}, out)
        assert state["epoch"] == 1 and state["best_pred"] == 0.25
        assert_seg_state_is(t, state)
        assert tool.main(["segtrain", "--checkpoint", out, "--out", back,
                          "--weight-decay", str(t.args.weight_decay),
                          "--momentum", str(t.args.momentum),
                          "--no-nesterov"]) == 0
        a, b = (torch.load(p, weights_only=True) for p in (src, back))
        _same_torch(a["state_dict"], b["state_dict"])
        _same_torch(a["optimizer"]["state"], b["optimizer"]["state"])
        assert (a["epoch"], a["best_pred"]) == (b["epoch"], b["best_pred"])


def without_lr(groups):
    return [{k: v for k, v in g.items() if k != "lr"} for g in groups]


def test_convert_tool_keeps_segtrain_sgd_settings(tmp_path, monkeypatch):
    """A Nesterov segtrain run (momentum 0.7, weight decay 1e-3) through the
    tool to the JAX format and back.  The JAX file does not hold the SGD
    settings, so the way back refuses without all three; given them, it
    writes the run's param groups (lr aside: the schedule sets it at every
    step) and its momentum bit for bit, and a resumed trainer takes them.
    A value that disagrees with a torch file is refused."""
    tool = load_tool("convert_checkpoint_torch")
    sgd = {"nesterov": True, "momentum": 0.7, "weight_decay": 1e-3}
    t = port_trainer(tmp_path, monkeypatch, **sgd)
    image, label = seg_batches(1, seed=6)[0]
    t.train_step(torch.from_numpy(image), torch.from_numpy(label), 1e-3)
    src = t.saver.save_checkpoint(t.checkpoint_state(0), False)
    out, back = str(tmp_path / "jax.ckpt"), str(tmp_path / "back.ckpt")
    with pytest.raises(SystemExit, match="momentum 0.7"):
        tool.main(["segtrain", "--checkpoint", src, "--out", out,
                   "--momentum", "0.9"])
    assert tool.main(["segtrain", "--checkpoint", src, "--out", out]) == 0
    given = ["--momentum", "0.7", "--weight-decay", "1e-3"]
    with pytest.raises(SystemExit, match="--nesterov"):
        tool.main(["segtrain", "--checkpoint", out, "--out", back, *given])
    assert tool.main(["segtrain", "--checkpoint", out, "--out", back,
                      *given, "--nesterov"]) == 0
    a, b = (torch.load(p, weights_only=True) for p in (src, back))
    assert without_lr(a["optimizer"]["param_groups"]) == \
        without_lr(b["optimizer"]["param_groups"])
    _same_torch(a["optimizer"]["state"], b["optimizer"]["state"])
    r = port_trainer(tmp_path, monkeypatch, resume=back, checkname="back")
    for group in r.optimizer.param_groups:
        assert {k: group[k] for k in sgd} == sgd


@pytest.mark.parametrize("backbone", ["resnet", "xception", "drn",
                                      "mobilenet"])
def test_convert_tool_reads_the_backbone_off_the_weights(backbone):
    """``backbone_of`` names the backbone from a torch state_dict's keys and
    from the JAX layout's ``params["backbone"]``."""
    from seg2eye_tpu_torch.models.deeplab import DeepLab

    tool = load_tool("convert_checkpoint_torch")
    net = DeepLab(backbone, 16, 4, (1, 1, 1, 1))
    assert tool.backbone_of(net.state_dict(), "torch") == backbone
    params = weights.deeplab_to_jax_variables(net, backbone)["params"]
    assert tool.backbone_of(params["backbone"], "flax") == backbone


# ------------------------------------------ the port's train and test CLIs
def test_loop_and_test_cli_continue_a_jax_run(seg2eye, tmp_path):
    """A JAX run's ``latest`` .ckpt files and iter.txt: the port's training
    loop resumes it (``continue_train``; the batch the run had trained
    skipped), goes on writing the JAX format, which the JAX package's
    load_state(strict=True) restores at the next step; ``python -m
    seg2eye_tpu_torch.test`` scores the run as it stands."""
    from seg2eye_tpu_torch.data.schema import write_synthetic_h5
    from seg2eye_tpu_torch.train.loop import train
    from test_torch_train_loop import _run

    opt0, _, jm, fns, batches = seg2eye
    data = write_synthetic_h5(str(tmp_path / "data.h5"), h=64, w=40)
    opt = opt0.replace(dataroot=data, checkpoints_dir=str(tmp_path),
                       name="tpu", continue_train=True, niter=1,
                       niter_decay=0, print_freq=10 ** 9,
                       save_latest_freq=10 ** 9, display_freq=10 ** 9,
                       full_val_freq=10 ** 9, prefetch=0)
    jopt = jax_opt(opt)
    js, _ = jax_train(fns, jstate.create_state(jm, jax.random.PRNGKey(2)),
                      batches[:1])
    jcheckpoint.save_state(js, jopt, "latest")
    np.savetxt(os.path.join(opt.expr_dir, "iter.txt"), (1, 2),
               delimiter=",", fmt="%d")

    class Batches:
        skipped = 0

        def __len__(self):
            return 3

        def set_epoch(self, epoch):
            pass

        def skip_next_batches(self, n):
            self.skipped = n

        def __iter__(self):
            return iter(batches[self.skipped:])

    loader = Batches()
    result = train(opt, max_steps=1, dataloader=loader, device="cpu")
    assert loader.skipped == 1 and result["steps"] == 1
    assert result["state"].step == 2
    files = sorted(os.listdir(opt.expr_dir))
    assert "latest_net_G.ckpt" in files and "1_optim.ckpt" in files
    assert not [f for f in files if f.endswith(".pth")]
    back = jcheckpoint.load_state(jstate.create_state(
        jm, jax.random.PRNGKey(0)), jopt, "latest", strict=True)
    assert int(back.step) == 2

    out = _run("seg2eye_tpu_torch.test", [
        "--device", "cpu", "--dataroot", data, "--name", "tpu",
        "--checkpoints_dir", str(tmp_path), "--ngf", "4", "--crop_size",
        "32", "--aspect_ratio", "1.0", "--w_dim", "8", "--input_ns", "2",
        "--batchSize", "2", "--compute_dtype", "float32", "--dataset_key",
        "validation"])
    score = float(re.search(r"mse/validation/full/relative, ([0-9.]+)",
                            out).group(1))
    assert np.isfinite(score) and score > 0
