"""PyTorch port, the RefineNet trainer against the JAX package on the CPU:
the learning-rate schedule, the clip and the SGD chain, one and three
train steps of RefineNet and SegNet, the loop (files, visualisations,
SIGTERM, bitwise resume), the checkpoint manager and the four CLIs.

The train steps run at batch 4 and a learning rate of 4e-5.  At batch 2
the ASPP global pool's BN normalises over two values per channel; where
those are close, its gradient is large and carries the float32 rounding
of the pool's mean (which JAX takes in float32 also in float64) into
every gradient upstream: 1e-3 apart in float64, measured.  At the configurations' learning rates a few steps of this tiny
net are chaotic: float64 runs whose only difference is that rounding are
17% apart in momentum by the third step.  At batch 4 and lr 4e-5 float64
runs agree to 1e-5 over three steps, so the step is held there to 1e-4;
float32 is held within JAX's own float32-vs-float64 distance.
"""
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seg2eye_tpu.refinenet import model as jmodel
from seg2eye_tpu.refinenet import training as jtraining
from seg2eye_tpu.utils import torch_convert, torch_export
from seg2eye_tpu_torch.data.openeds import DataLoader
from seg2eye_tpu_torch.refinenet import model, training
from seg2eye_tpu_torch.refinenet.checkpoint_manager import CheckpointManager
from seg2eye_tpu_torch.refinenet.dataset import RefineNetDataset
from test_torch_refinenet import (GAP_RATIO, f64, fixtures,  # noqa: F401
                                  free_disk, jax_cfg, tiny_cfg, to_jax)

STEP_ATOL = 1e-4
NET_FLOOR = 1e-2
# float64 gradients and momentum, relative per tensor (with NET_FLOOR):
# with the global pool's conv zeroed (measured 2e-6), and live (measured
# 7.6e-4, SegNet's first step)
QUIET_RTOL, POOL_RTOL = 1e-5, 2e-3
# two bfloat16 ulps, relative to 1 + |scalar| (test_bf16_train_step_...)
BF16_SCALAR_ATOL = 2.0 ** -7
STEP_CFG = dict(batch_size=4, base_learning_rate=1e-5, weight_decay=1e-3)
KINDS = {"refinenet": (model.RefineNetModel, jmodel.RefineNetModel,
                       "eds_loss", 0.99, 5.0),
         "segnet": (model.SegNetModel, jmodel.SegNetModel, "ce_loss", 0.9,
                    -0.1)}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (see
    test_torch_refinenet.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- schedule, clip, SGD
@pytest.mark.parametrize("strategy,warmup", [
    ("exponential", 2), ("exponential", 0), ("cyclic", 1), ("none", 0)])
def test_learning_rate_schedule_matches_jax(strategy, warmup):
    """Every step of warmup and of three decay intervals."""
    cfg = tiny_cfg(batch_size=8, base_learning_rate=1e-3,
                   num_warmup_epochs=warmup, lr_decay_strategy=strategy,
                   lr_decay_factor=0.5, lr_decay_epoch_interval=2)
    for step in range(10 * (warmup + 6)):
        assert training.learning_rate_schedule(cfg, 10, step) == \
            jtraining.learning_rate_schedule(jax_cfg(cfg), 10, step), step


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0], ids=["below", "at",
                                                        "above"])
def test_clip_matches_optax(scale):
    """clip_by_global_norm_ is optax's: g unchanged when the global norm is
    below the limit, (g / norm) * limit otherwise; torch's clip_grad_norm_
    (max / (norm + 1e-6), only above) is not."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in
             ((3, 4), (5,), (2, 2, 3))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    limit = norm / scale
    want, _ = optax.clip_by_global_norm(limit).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    training.clip_by_global_norm_(got, limit)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                   atol=0)
    if scale > 1:
        assert np.abs(got[0].numpy() - grads[0]).max() > 0


@pytest.mark.parametrize("clip", [5.0, -0.1])
def test_sgd_matches_optax_chain(clip):
    """Three steps of make_optimizer + the clip (at changing learning
    rates, on given gradients) against the JAX package's optax chain:
    Nesterov momentum, weight decay on every parameter after the clip."""
    rng = np.random.default_rng(1)
    cfg = tiny_cfg(gradient_norm_clip=clip, weight_decay=1e-3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (6,))]
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    opt = training.make_optimizer(tparams, cfg, momentum=0.99)
    tx = jtraining.make_optimizer(jax_cfg(cfg), momentum=0.99)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for step, lr in enumerate((0.1, 0.05, 0.2)):
        grads = [(rng.normal(size=p.shape) * 3).astype(np.float32)
                 for p in params]
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        if clip > 0:
            training.clip_by_global_norm_([p.grad for p in tparams], clip)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


# --------------------------------------------------- steps against JAX
def step_batches(kind, n, b=4, h=64, w=40, seed=0):
    """Loader-like uint8 batches (SegNet: (B,H,W) class ids)."""
    rng = np.random.default_rng(seed)
    c = 3 if kind == "refinenet" else 1
    out = []
    for _ in range(n):
        batch = {"input": rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)}
        batch["target"] = (rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8)
                           if kind == "refinenet" else
                           rng.integers(0, 4, (b, h, w), dtype=np.uint8))
        out.append(batch)
    return out


def jax_variables(sd, shapes, backbone, dtype):
    """``sd`` (numpy arrays under the reference's keys) as the JAX
    variables of ``backbone``'s DeepLab, shaped as ``shapes``, in
    ``dtype`` (the JAX package's Xception and DRN converters write float32
    kernels: in float64 a kernel's gradient, and g + wd * p in the trace,
    would round to float32)."""
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, dtype),
                                      shapes)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype),
        torch_convert.convert_deeplab(sd, template, backbone))


class JaxSteps:
    """JAX's Trainer(donate=False)._train_step with rng=None, float32,
    float64 (``jax.enable_x64``, the model's compute dtype float64) and
    bfloat16 compute ("bf16", float32 weights), run from a port state: its
    weights, running statistics and momentum; ``cfg.backbone``'s
    DeepLab."""

    def __init__(self, kind, cfg):
        _, jm_cls, key, momentum, _ = KINDS[kind]
        self.backbone = cfg.backbone
        self.fns = {}
        for x64 in (False, True, "bf16"):
            jm = jm_cls(jax_cfg(cfg))
            if x64 is True:
                jm.dtype = jnp.float64
            elif x64 == "bf16":
                jm.dtype = jnp.bfloat16
            trainer = jtraining.Trainer(jm, jax_cfg(cfg), key,
                                        momentum=momentum, donate=False)
            self.fns[x64] = (trainer.tx, jax.jit(functools.partial(
                trainer._train_step, rng=None)))
        self.shapes = jax.eval_shape(jm.net.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 40, 3)))

    def step(self, state, batch, lr, x64):
        """One JAX step from the port's ``state`` -> (scalars, variables,
        momentum); ``x64``: True, False or "bf16"."""
        dtype = np.float64 if x64 is True else np.float32
        sd = {k: v.detach().cpu().numpy().astype(dtype)
              for k, v in state.model.net.state_dict().items()}
        variables = jax_variables(sd, self.shapes, self.backbone, dtype)
        tx, fn = self.fns[x64]
        buffers = {n: state.optimizer.state[p]["momentum_buffer"]
                   for n, p in state.model.net.named_parameters()
                   if p in state.optimizer.state}
        with jax.enable_x64(x64 is True):
            opt = tx.init(variables["params"])
            if buffers:
                trace = jax_variables(
                    {**sd, **{n: b.cpu().numpy().astype(dtype)
                              for n, b in buffers.items()}},
                    self.shapes, self.backbone, dtype)["params"]
                opt = opt._replace(inner_state=tuple(
                    s._replace(trace=trace) if hasattr(s, "trace") else s
                    for s in opt.inner_state))
            new, scalars, _ = fn(
                {"variables": variables, "opt": opt,
                 "step": jnp.zeros((), jnp.int32)},
                jax.tree_util.tree_map(jnp.asarray, batch),
                jnp.asarray(lr, dtype))
            trace = next(s for s in new["opt"].inner_state
                         if hasattr(s, "trace")).trace
            return jax.device_get((scalars, new["variables"], trace))


def port_state(kind, cfg, net_state, x64):
    m_cls, _, key, momentum, _ = KINDS[kind]
    m = m_cls(cfg, "cpu")
    trainer = training.Trainer(m, cfg, key, momentum)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    m.net.load_state_dict(net_state)
    if x64:
        m.net.double()
        m.dtype = torch.float64
        state.optimizer = training.make_optimizer(m.net.parameters(), cfg,
                                                  momentum)
    return trainer, state


def snapshot(state):
    """(parameters by name, momentum by name) of a port state, float64."""
    net = state.model.net
    params = {n: p.detach().double().numpy().copy()
              for n, p in net.named_parameters()}
    mom = {n: state.optimizer.state[p]["momentum_buffer"].double().numpy()
           .copy() for n, p in net.named_parameters()
           if p in state.optimizer.state}
    return params, mom


def port_step(trainer, state, batch, lr):
    """One port step -> (scalars, state_dict, momentum, clipped gradients),
    the last two by parameter name."""
    scalars, _ = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, lr)
    net = state.model.net
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    mom = {n: state.optimizer.state[p]["momentum_buffer"].clone()
           for n, p in net.named_parameters()}
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return {k: float(v) for k, v in scalars.items()}, sd, mom, grads


def distances(port_out, jax_out, before, wd, momentum, backbone="resnet"):
    """Distances of a port step's results from a JAX step's, both from the
    state ``before`` (parameters, momentum): scalars (relative to
    1 + |value|), parameters and running statistics (max abs), momentum
    and the clipped gradient g = trace - momentum * trace_before - wd * p,
    per tensor relative to its norm plus NET_FLOOR times the net's.  The
    floor: a BN bias's gradient is a sum over the batch that nearly
    cancels (the next train-mode BN projects the mean out of it), so its
    relative error is that of its terms times the cancellation.  Computed
    in float64 torch ops (twice numpy's speed on these nets' 3e7 values)."""
    def tensors(arrays):      # float64, copied where read-only or float32
        return {k: torch.from_numpy(np.require(v, np.float64, "W"))
                for k, v in arrays.items()}

    scalars, sd, mom, grads = port_out
    jscal, jvars, jtrace = jax_out
    want = tensors(torch_export.export_deeplab(jvars, backbone))
    trace = tensors(torch_export.export_deeplab(
        {"params": jtrace, "batch_stats": jvars["batch_stats"]}, backbone))
    params0, mom0 = tensors(before[0]), tensors(before[1])

    def rel(got, ref):
        net = float(torch.sqrt(sum(torch.sum(r * r) for r in ref.values())))
        return max(float(torch.linalg.vector_norm(got[k].double() - r)
                         / (torch.linalg.vector_norm(r) + NET_FLOOR * net))
                   for k, r in ref.items())

    def max_abs(k):
        return float((sd[k].double() - want[k]).abs().max())

    assert sorted(scalars) == sorted(jscal)
    return {"scalars": max(abs(scalars[k] - float(jscal[k])) /
                           (1 + abs(float(jscal[k]))) for k in jscal),
            "params": max(max_abs(k) for k in mom),
            "stats": max(max_abs(k) for k in want if "running" in k),
            "momentum": rel(mom, {k: trace[k] for k in mom}),
            "grads": rel(grads, {k: trace[k] - momentum * mom0.get(k, 0.0)
                                 - wd * params0[k] for k in mom})}


@pytest.mark.parametrize("kind", ["refinenet", "segnet"])
def test_train_steps_match_jax(kind):
    """One and three train steps (no dropout) against JAX's, each step
    from the same state on both sides (the port's): losses, clipped
    gradients, parameters, momentum and running statistics.  Float64 on
    both sides: a first step with the ASPP global pool's conv zeroed to
    QUIET_RTOL, three with it live within POOL_RTOL (scalars, parameters
    and statistics to 1e-4); a float32 step no further from float64 JAX
    than GAP_RATIO times JAX's own float32.  RefineNet clips at 5.0 (its
    gradient norm is above, so the clip acts), SegNet does not clip."""
    m_cls, _, _, momentum, clip = KINDS[kind]
    cfg = tiny_cfg(gradient_norm_clip=clip, **STEP_CFG)
    init = m_cls(cfg, "cpu").init(torch.Generator().manual_seed(0))
    net_state = {k: v.clone() for k, v in init.net.state_dict().items()}
    batches = step_batches(kind, 3)
    lrs = [training.learning_rate_schedule(cfg, 2, s) for s in range(3)]
    wd = cfg.weight_decay
    jx = JaxSteps(kind, cfg)

    pool = "aspp.global_avg_pool.1.weight"
    quiet = {**net_state, pool: torch.zeros_like(net_state[pool])}
    trainer, state = port_state(kind, cfg, quiet, True)
    before, want = snapshot(state), jx.step(state, batches[0], lrs[0], True)
    d = distances(port_step(trainer, state, batches[0], lrs[0]), want,
                  before, wd, momentum)
    assert max(d["grads"], d["momentum"]) <= QUIET_RTOL, d
    assert max(d.values()) <= STEP_ATOL, d

    for x64, n in ((True, 3), (False, 1)):
        trainer, state = port_state(kind, cfg, net_state, x64)
        for step, (batch, lr) in enumerate(zip(batches[:n], lrs)):
            before = snapshot(state)
            want64 = jx.step(state, batch, lr, True)
            want32 = None if x64 else jx.step(state, batch, lr, False)
            got = port_step(trainer, state, batch, lr)
            if clip > 0 and x64 and step == 0:
                norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                            for g in got[3].values())))
                assert abs(norm - clip) < 1e-6 * clip   # clipped to 5.0
            d = distances(got, want64, before, wd, momentum)
            if x64:
                for k, v in d.items():
                    assert v <= (POOL_RTOL if k in ("grads", "momentum")
                                 else STEP_ATOL), (step, d)
                continue
            gap = distances(as_port(want32, before, wd, momentum), want64,
                            before, wd, momentum)
            for k, v in d.items():
                assert v <= max(GAP_RATIO * gap[k],
                                STEP_ATOL if k == "params" else 0.0), \
                    (step, k, d, gap)
        assert state.step == n


def normalised(kind, batch):
    """``batch`` with its uint8 images in [-1, 1] (x * (2/255) - 1 in
    float32, what both packages' models do with uint8): RefineNet's input
    and target, SegNet's input."""
    images = ("input", "target") if kind == "refinenet" else ("input",)
    return {k: (v.astype(np.float32) * np.float32(2.0 / 255.0)
                - np.float32(1.0)) if k in images else v
            for k, v in batch.items()}


@pytest.mark.parametrize("kind,backbone", [("segnet", "drn"),
                                           ("refinenet", "xception")])
def test_train_step_extra_backbones_match_jax(kind, backbone):
    """One SGD step of SegNet-DRN and of RefineNet-Xception (full depth,
    64x40, batch 4) against the JAX Trainer's from the same state, in
    float64: losses, parameters and running statistics to STEP_ATOL, the
    clipped gradients and momentum to QUIET_RTOL (measured 7.8e-7 and
    4.7e-7).  The images are given in [-1, 1] (``normalised``): on a
    uint8 batch that is a runtime argument, XLA's CPU backend fuses JAX's
    x * (2/255) - 1 into one rounding, one float32 ulp from the formula
    rounded twice (the port's), and SegNet-DRN's train-mode BNs amplify
    that to 2.1e-3 in its early gradients (measured)."""
    m_cls, _, _, momentum, clip = KINDS[kind]
    cfg = tiny_cfg(backbone=backbone, gradient_norm_clip=clip, **STEP_CFG)
    init = m_cls(cfg, "cpu").init(torch.Generator().manual_seed(0))
    net_state = {k: v.clone() for k, v in init.net.state_dict().items()}
    batch = normalised(kind, step_batches(kind, 1, seed=5)[0])
    lr = training.learning_rate_schedule(cfg, 2, 0)
    trainer, state = port_state(kind, cfg, net_state, True)
    before = snapshot(state)
    want = JaxSteps(kind, cfg).step(state, batch, lr, True)
    d = distances(port_step(trainer, state, batch, lr), want, before,
                  cfg.weight_decay, momentum, backbone)
    for k, v in d.items():
        assert v <= (QUIET_RTOL if k in ("grads", "momentum")
                     else STEP_ATOL), d


@pytest.mark.parametrize("kind", ["refinenet", "segnet"])
def test_bf16_train_step_within_jax_bf16_gap(kind):
    """A bfloat16 train step (bfloat16 compute, float32 weights, running
    statistics and momentum) is no further from JAX's float32 step than
    JAX's own bfloat16 step is, from the same state: scalars, parameters,
    running statistics, momentum and the clipped gradients, each distance
    within GAP_RATIO times JAX's (as the float32 step is held against
    float64 in test_train_steps_match_jax).  A scalar is one number whose
    bfloat16 rounding either side may hit or miss: it is held to
    BF16_SCALAR_ATOL where JAX's own distance is smaller (measured over
    four batches: the port's distance 0.09-8.4 times JAX's, at most
    1.9e-3; the tensors' ratios 1.0-1.8)."""
    m_cls, _, _, momentum, clip = KINDS[kind]
    cfg = tiny_cfg(gradient_norm_clip=clip, **STEP_CFG)
    init = m_cls(cfg, "cpu").init(torch.Generator().manual_seed(0))
    net_state = {k: v.clone() for k, v in init.net.state_dict().items()}
    batch = step_batches(kind, 1, seed=3)[0]
    lr = training.learning_rate_schedule(cfg, 2, 0)
    jx = JaxSteps(kind, cfg)
    trainer, state = port_state(kind, cfg, net_state, False)
    state.model.dtype = torch.bfloat16
    before = snapshot(state)
    want32 = jx.step(state, batch, lr, False)
    want16 = jx.step(state, batch, lr, "bf16")
    got = port_step(trainer, state, batch, lr)
    d = distances(got, want32, before, cfg.weight_decay, momentum)
    gap = distances(as_port(want16, before, cfg.weight_decay, momentum),
                    want32, before, cfg.weight_decay, momentum)
    assert gap["grads"] > 0 and all(np.isfinite(v) for v in d.values())
    for k, v in d.items():
        assert v <= max(GAP_RATIO * gap[k],
                        BF16_SCALAR_ATOL if k == "scalars" else 0.0), \
            (k, d, gap)


def as_port(jax_out, before, wd, momentum):
    """A JAX step's results in port_step's form, the clipped gradient
    read off its momentum."""
    jscal, jvars, jtrace = jax_out
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          torch_export.export_deeplab(jvars, "resnet").items()}
    trace = torch_export.export_deeplab(
        {"params": jtrace, "batch_stats": jvars["batch_stats"]}, "resnet")
    params0, mom0 = before
    mom = {k: torch.from_numpy(np.asarray(trace[k])) for k in params0}
    grads = {k: m.double() - momentum * torch.from_numpy(
        np.asarray(mom0.get(k, 0.0))) - wd * torch.from_numpy(params0[k])
        for k, m in mom.items()}
    return {k: float(v) for k, v in jscal.items()}, sd, mom, grads


# ------------------------------------------------------------ the loop
def loop_cfg(fixtures, **kw):
    d, cfg = fixtures
    return cfg.replace(**{"test_every_n_steps": 10 ** 6,
                          "tensorboard_images_every_n_steps": 0,
                          "output_dir_base": str(d / "loops"), **kw})


def loaders(cfg):
    train = DataLoader(RefineNetDataset(cfg, "train"), batch_size=2,
                       shuffle=True, drop_last=True, seed=cfg.seed)
    test = {"val/pick1": DataLoader(RefineNetDataset(cfg, "validation",
                                                     pick1=True), 2)}
    return train, test


def test_main_loop_end_to_end(fixtures, monkeypatch):
    """main_loop: steps, visualisations, the periodic and final test, the
    files of the run, and the last checkpoint, which reloads into a new
    state that evaluates bit for bit as the trained one."""
    cfg = loop_cfg(fixtures, max_steps=2, test_every_n_steps=2,
                   tensorboard_images_every_n_steps=1)
    vis = []
    real = training.do_visualizations
    monkeypatch.setattr(training, "do_visualizations",
                        lambda *a, **kw: vis.append(real(*a, **kw)))
    train, test = loaders(cfg)
    result = training.main_loop(model.RefineNetModel(cfg, "cpu"), cfg, train,
                                test, loss_key="eds_loss",
                                model_name="RefineNet")
    assert result["steps"] == 2 and vis == [2, 2]
    assert np.isfinite(result["final"]["val/pick1"]["eds_loss"])
    out_dir = result["output_dir"]
    for name in ("config.json", "gsheet_rows.jsonl"):
        assert os.path.exists(os.path.join(out_dir, name))
    rows = open(os.path.join(out_dir, "gsheet_rows.jsonl")).read()
    assert '"val/pick1/eds_loss"' in rows and '"final/val/pick1/score"' in rows
    assert sorted(os.listdir(os.path.join(out_dir, "checkpoints"))) == [
        "0000002.ckpt"]

    trainer = training.Trainer(model.RefineNetModel(cfg, "cpu"), cfg,
                               "eds_loss")
    fresh = trainer.init_state(torch.Generator().manual_seed(9))
    step, fresh = CheckpointManager(out_dir).load_last_checkpoint(fresh)
    assert step == 2 and fresh.step == 2
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(test["val/pick1"])).items() if k in ("input",
                                                            "target")}
    a = result["trainer"].eval_step(result["state"], batch)
    b = trainer.eval_step(fresh, batch)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_main_loop_sigterm_saves_current_step(fixtures):
    """SIGTERM during the second step's callback: the checkpoint of step 2
    is written, the final test skipped, the handler restored."""
    cfg = loop_cfg(fixtures, max_steps=5)
    train, test = loaders(cfg)
    before = signal.getsignal(signal.SIGTERM)

    def cb(step, scalars, out, batch):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    result = training.main_loop(model.RefineNetModel(cfg, "cpu"), cfg, train,
                                test, loss_key="eds_loss", step_callback=cb)
    assert result["interrupted"] is True and result["steps"] == 2
    assert result["final"] == {}
    assert os.listdir(os.path.join(result["output_dir"], "checkpoints")) == [
        "0000002.ckpt"]
    assert signal.getsignal(signal.SIGTERM) == before


def test_resume_is_bitwise(fixtures):
    """Four steps straight (dropout on, an epoch restart after three)
    equal one step, then a resumed run of three: weights, running
    statistics, momentum and step, bit for bit."""
    cfg = loop_cfg(fixtures, max_steps=4, num_epochs=2, checkpoints_keep_n=1)
    train, test = loaders(cfg)
    straight = training.main_loop(model.SegNetModel(cfg, "cpu"), cfg, train,
                                  {}, loss_key="ce_loss", momentum=0.9)
    first = training.main_loop(model.SegNetModel(cfg, "cpu"),
                               cfg.replace(max_steps=1), *loaders(cfg)[:1],
                               {}, loss_key="ce_loss", momentum=0.9)
    resumed = training.main_loop(
        model.SegNetModel(cfg, "cpu"),
        cfg.replace(max_steps=3, resume_from=first["output_dir"]),
        *loaders(cfg)[:1], {}, loss_key="ce_loss", momentum=0.9)
    assert straight["steps"] == resumed["steps"] == 4
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 4
    for k, v in a.model.net.state_dict().items():
        assert torch.equal(v, b.model.net.state_dict()[k]), k
    for pa, pb in zip(a.optimizer.param_groups[0]["params"],
                      b.optimizer.param_groups[0]["params"]):
        assert torch.equal(a.optimizer.state[pa]["momentum_buffer"],
                           b.optimizer.state[pb]["momentum_buffer"])


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    cfg = tiny_cfg()
    trainer = training.Trainer(model.SegNetModel(cfg, "cpu"), cfg, "ce_loss")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    assert mgr.load_last_checkpoint(state) == (None, state)
    for step in (1, 5, 12):
        mgr.save_at_step(step, state)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "0000005.ckpt", "0000012.ckpt"]
    assert mgr.load_last_checkpoint(state)[0] == 12


class _Recorder:
    def __init__(self):
        self.images, self.step = [], 0

    def update_current_step(self, step):
        self.step = step

    def add_image(self, tag, img):
        self.images.append((tag, self.step, np.asarray(img).shape))


def test_do_visualizations_strip():
    """Input channels | prediction | groundtruth over a 60-pixel footer,
    as the JAX package's."""
    b, h, w = 2, 16, 12
    rng = np.random.default_rng(0)
    out = {"input": torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3))),
           "prediction": torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 1))),
           "groundtruth": torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 1))),
           "per_image_score": torch.tensor([0.5, 0.7])}
    rec = _Recorder()
    assert training.do_visualizations(out, rec, step=7) == 2
    assert rec.images[0] == ("train/prediction_0", 7, (1, h + 60, 5 * w))


# ----------------------------------------------------------------- CLIs
def test_cli_chain_on_the_cpu(fixtures, tmp_path):
    """train_segnet -> evaluate_segnet -> train_refinenet ->
    evaluate_refinenet with --device cpu: the mask H5 has uint8 masks per
    split and user, the predictions one uint8 .npy per test image and the
    manifest; without a checkpoint the evaluators refuse, and without
    --device cpu every CLI refuses on a machine without a card."""
    import h5py

    from seg2eye_tpu_torch.refinenet import (evaluate_refinenet,
                                             evaluate_segnet,
                                             train_refinenet, train_segnet)

    _, cfg = fixtures
    paths = ["--dataroot", cfg.dataroot, "--distances_and_indices",
             cfg.distances_and_indices, "--segmentations_train",
             cfg.segmentations_train, "--segmentations_generative",
             cfg.segmentations_generative, "--segmentations_sequence",
             cfg.segmentations_sequence]
    tiny = ["--resnet_depth", "14", "--input_width", "40", "--input_height",
            "64", "--batch_size", "2", "--test_batch_size", "3",
            "--compute_dtype", "float32", "--prefetch", "0"]
    train_args = ["--device", "cpu", *paths, *tiny, "--max_steps", "1",
                  "--num_warmup_epochs", "0", "--output_dir_base",
                  str(tmp_path)]
    seg = train_segnet.main(train_args)
    masks = str(tmp_path / "masks.h5")
    evaluate_segnet.main(["--device", "cpu", *paths, *tiny, "--resume_from",
                          seg["output_dir"], "--output", masks])
    with h5py.File(masks, "r") as f:
        assert sorted(f) == ["test", "train", "validation"]
        ds = f["train"]["U001"]
        assert ds.dtype == np.uint8 and ds.shape == (4, 64, 40)
        assert ds[()].max() <= 3
    ref = train_refinenet.main(train_args)
    manifest = evaluate_refinenet.main(["--device", "cpu", *paths, *tiny,
                                        "--resume_from",
                                        ref["output_dir"]])
    files = open(manifest).read().split()
    with h5py.File(cfg.dataroot, "r") as f:
        assert len(files) == sum(f["test"][u]["labels_gen"].shape[0]
                                 for u in f["test"])
    pred = np.load(files[0])
    assert pred.dtype == np.uint8 and pred.shape == (64, 40)

    for cli in (evaluate_segnet, evaluate_refinenet):
        with pytest.raises(SystemExit, match="no checkpoint"):
            cli.main(["--device", "cpu", *paths, *tiny, "--resume_from",
                      str(tmp_path / "empty")])
    if not torch.cuda.is_available():
        for cli in (train_segnet, train_refinenet, evaluate_segnet,
                    evaluate_refinenet):
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main([*paths, *tiny, "--resume_from", ref["output_dir"]])


def test_cli_drn_backbone_on_the_cpu(fixtures, tmp_path):
    """train_segnet and evaluate_segnet with ``--backbone drn`` and
    --device cpu: one step, a checkpoint, masks in 0..3 for every split."""
    import h5py

    from seg2eye_tpu_torch.refinenet import evaluate_segnet, train_segnet

    _, cfg = fixtures
    args = ["--device", "cpu", "--dataroot", cfg.dataroot,
            "--segmentations_train", cfg.segmentations_train,
            "--backbone", "drn", "--input_width", "40", "--input_height",
            "64", "--batch_size", "2", "--test_batch_size", "3",
            "--compute_dtype", "float32", "--prefetch", "0"]
    seg = train_segnet.main([*args, "--max_steps", "1",
                             "--num_warmup_epochs", "0",
                             "--output_dir_base", str(tmp_path)])
    assert seg["steps"] == 1
    masks = str(tmp_path / "masks.h5")
    evaluate_segnet.main([*args, "--resume_from", seg["output_dir"],
                          "--output", masks])
    with h5py.File(masks, "r") as f:
        assert sorted(f) == ["test", "train", "validation"]
        assert f["train"]["U001"][()].max() <= 3
