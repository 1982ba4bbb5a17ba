"""PyTorch port, data-parallel training (``parallel.data_parallel``)
against the JAX package's data mesh, on the CPU.

In process: the training loader's shards against the JAX loader's, byte
for byte; the refusals (a batch or a tail that the world size does not
divide, an explicit ``--data_axis`` that is not it, a failed process-group
start); and, with the rank set to 1, that the Seg2Eye loop, segtrain and
the RefineNet loop write nothing.  Three tests start two gloo processes
each (``torch_parallel_child.py``, FileStore rendezvous, two threads,
every child and join bounded by ``CHILD_TIMEOUT``) and hold them to the
JAX package's ``data=2`` mesh run of the same global batches, computed
here while the children run:

  * Seg2Eye (ngf 4, ndf 4, crop 32, w_dim 8, k 2, float32, global batch
    4), two iterations through ``train.loop.train``, with the default
    norms and with batch sub-norms in E and D (per-sample encoding):
    losses rtol 2e-4 / atol 2e-5, the bound of the JAX package's own
    data-parallel test (``tests/test_sharding.py``), at the second
    iteration atol LOSS_ATOL_3, the port's own bound against JAX after
    the first (D's last bias has a round-off gradient that Adam turns
    into steps of a fraction of lr on one side, ``tests/test_torch_train.
    py``); the networks against the port's one-process run at atol 1e-5
    (spectral u/v, running statistics, parameters: the port's
    training-test limits widened for the order of the cross-rank sums)
    but where Adam may step an element with a round-off gradient either
    way, and against the JAX mesh run no further than the one-process
    run is, plus that tolerance;
  * segtrain (ResNet-14, crop 32, global batch 4), one epoch of training
    and validation, dropout off on both sides: the epoch loss rtol 2e-4,
    the mIoU exactly;
  * RefineNet (ResNet-14, 64x40, global batch 4), one float64 train step
    with dropout on (the JAX model given the port's masks): the limits of
    the port's own float64 step test (``tests/test_torch_refinenet_train.
    py``).
"""
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from seg2eye_tpu.parallel.sharding import make_mesh, replicate_state, \
    shard_batch
from seg2eye_tpu_torch.data import openeds
from seg2eye_tpu_torch.parallel import data_parallel as dp
from test_torch_train import (LOSS_ATOL_3, _jax_state, exported, is_buffer,
                              jax_opt, make_batch, to_jax_variables,
                              tiny_opt)
from torch_parallel_child import ArrayDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_parallel_child.py")
CHILD_TIMEOUT = 120
WORLD = 2
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
STATE_ATOL = 1e-5          # spectral u/v, running statistics
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (see
    test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def free_disk(request):
    """A test's files go when it ends (the children's run directories and
    outputs), not when the whole run does."""
    path = request.getfixturevalue("tmp_path") \
        if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


class Children:
    """``world`` ranks of one task of ``torch_parallel_child.py``, started
    on ``inputs`` in ``where``; ``outputs()`` waits for them (each within
    CHILD_TIMEOUT) and returns each rank's results.  A rank that fails or
    times out fails the test, and every child is killed on the way out."""

    def __init__(self, task, inputs, where, world=WORLD):
        self.task, self.where = task, str(where)
        torch.save(inputs, os.path.join(self.where, f"{task}_in.pt"))
        env = {**{k: v for k, v in os.environ.items()
                  if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK")},
               "OMP_NUM_THREADS": "2"}
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, task, str(r), str(world), self.where],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]

    def outputs(self):
        try:
            for r, p in enumerate(self.procs):
                log, _ = p.communicate(timeout=CHILD_TIMEOUT)
                assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
            return [torch.load(os.path.join(self.where,
                                            f"{self.task}_out{r}.pt"),
                               weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            self.kill()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=CHILD_TIMEOUT)


# ----------------------------------------------------------------- loader
@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    from seg2eye_tpu.data import schema

    d = tmp_path_factory.mktemp("parallel")
    return d, schema.write_synthetic_h5(str(d / "data.h5"), n_ss=5, n_gen=5,
                                        n_seq=2, h=64, w=40)


def assert_same_batch(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, k


def loader_opt(h5, **kw):
    from seg2eye_tpu_torch.options import Options

    return Options(dataroot=h5[1], crop_size=32, aspect_ratio=0.8,
                   input_ns=2, batchSize=4, isTrain=True, seed=5,
                   prefetch=2, **kw).finalize()


def test_loader_shards_match_jax_loader(h5, monkeypatch):
    """Two epochs of the training loader (shuffle, flips, prefetch) at
    ranks 0 and 1 of 2 (``create_dataloader`` at a world of 2): each
    shard byte for byte the JAX loader's shard, and the two together the
    JAX loader's global batch, its one-process run."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.data import openeds as jopeneds

    opt = loader_opt(h5)
    jds = jopeneds.OpenEDSDataset(opt, dataset_key="train")
    monkeypatch.setattr(dp, "world_size", lambda: WORLD)
    shards = []
    for r in range(WORLD):
        monkeypatch.setattr(dp, "rank", lambda r=r: r)
        shards.append((openeds.create_dataloader(opt), jloader.DataLoader(
            jds, batch_size=4, shuffle=True, drop_last=True, seed=opt.seed,
            prefetch=2, process_index=r, process_count=WORLD)))
    whole = jloader.DataLoader(jds, batch_size=4, shuffle=True,
                               drop_last=True, seed=opt.seed, prefetch=0)
    assert all(got.process_index == r and got.process_count == WORLD
               for r, (got, _) in enumerate(shards))
    for epoch in (1, 2):
        for loader in [whole, *(x for pair in shards for x in pair)]:
            loader.set_epoch(epoch)
        rows = [list(zip(got, want, strict=True)) for got, want in shards]
        assert len(rows[0]) == len(whole) == 2
        for i, want in enumerate(whole):
            for r in range(WORLD):
                got_r, want_r = rows[r][i]
                assert_same_batch(got_r, want_r)
                assert len(got_r["label"]) == 4 // WORLD
            arrays = {k: v for k, v in want.items()
                      if isinstance(v, np.ndarray)}
            assert_same_batch({k: np.concatenate([rows[r][i][0][k]
                                                  for r in range(WORLD)])
                               for k in arrays}, arrays)


def test_tail_batch_the_world_does_not_divide_raises(h5):
    """A kept tail of 3 samples over 2 processes (11 samples, the 10 of
    the file and one again, in batches of 4) raises in both loaders; a
    global batch that the world size does not divide is refused at once."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.data import openeds as jopeneds

    opt = loader_opt(h5)
    ds = openeds.Subset(openeds.OpenEDSDataset(opt, dataset_key="train"),
                        list(range(10)) + [9])
    jds = jloader.Subset(jopeneds.OpenEDSDataset(opt, dataset_key="train"),
                         list(range(10)) + [9])
    for cls, d in ((openeds.DataLoader, ds), (jloader.DataLoader, jds)):
        loader = cls(d, batch_size=4, shuffle=False, drop_last=False,
                     seed=0, prefetch=0, process_index=0, process_count=2)
        batches = iter(loader)
        next(batches), next(batches)
        with pytest.raises(ValueError, match="tail batch of 3"):
            next(batches)
    with pytest.raises(ValueError, match="not divisible"):
        openeds.DataLoader(ds, batch_size=3, process_count=2)
    assert dp.check_batch(4, 2) == 2
    with pytest.raises(ValueError, match="not divisible"):
        dp.check_batch(5, 2)


def test_segtrain_eval_tail_drop_at_world_2(tmp_path, monkeypatch, capsys):
    """``make_data_loader`` at a world of 2 drops the 1-sample eval tail of
    a 3-image val set and keeps drop_last on the train loader, as the JAX
    package's over 2 processes; at a world of 1 it keeps the tail."""
    from seg2eye_tpu_torch.segtrain.datasets import make_data_loader
    from test_segtrain import Args, make_voc

    root = str(tmp_path)
    make_voc(root, ["a", "b", "c"], ["v", "w", "x"])
    args = Args(data_root=root, base_size=32, crop_size=24, use_sbd=False,
                batch_size=2)
    _, val_single, _, _ = make_data_loader(args)
    assert val_single.drop_last is False and len(val_single) == 2
    monkeypatch.setattr(dp, "world_size", lambda: WORLD)
    monkeypatch.setattr(dp, "rank", lambda: 1)
    train, val, _, _ = make_data_loader(args)
    assert val.drop_last is True and len(val) == 1
    assert train.drop_last is True
    assert (val.process_index, val.process_count) == (1, WORLD)
    assert "dropping the 1-sample eval tail" in capsys.readouterr().out
    assert next(iter(val))["image"].shape[0] == 1


# --------------------------------------------------------------- refusals
def test_refusals(h5, monkeypatch):
    """An explicit --data_axis that is not the world size, a global batch
    that the world does not divide, and the tensor-parallel and H-band
    options raise in the loop; a process-group start that cannot happen
    (two processes asked for on a card that is absent) raises and leaves
    no group."""
    from seg2eye_tpu_torch.train import loop

    opt = loader_opt(h5)
    cpu = torch.device("cpu")
    loop._check_ported(opt.replace(data_axis=1), cpu)
    with pytest.raises(ValueError, match="--data_axis 2"):
        loop._check_ported(opt.replace(data_axis=2), cpu)
    for flag in ({"spatial_shard": True}, {"model_axis": 2}):
        with pytest.raises(NotImplementedError):
            loop._check_ported(opt.replace(**flag), cpu)
    monkeypatch.setattr(dp, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="not divisible"):
        loop._check_ported(opt, cpu)
    loop._check_ported(opt.replace(batchSize=6, data_axis=3), cpu)
    monkeypatch.undo()

    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.init_from_env("cuda")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dp.init_from_env("cpu") == cpu
    assert not torch.distributed.is_initialized() and not dp.active()


# -------------------------------------------------------- rank 1 writes
def test_seg2eye_loop_at_rank_1_writes_nothing(h5, tmp_path, monkeypatch):
    """The Seg2Eye loop as rank 1: it trains, and creates no run
    directory, checkpoint, loss log or event file."""
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.train.loop import train

    monkeypatch.setattr(dp, "rank", lambda: 1)
    opt = Options(dataroot=h5[1], name="rank1",
                  checkpoints_dir=str(tmp_path / "ckpt"), ngf=4, ndf=4,
                  crop_size=32, aspect_ratio=1.0, w_dim=8, input_ns=2,
                  batchSize=2, compute_dtype="float32", isTrain=True,
                  print_freq=2, save_latest_freq=2, display_freq=10 ** 9,
                  full_val_freq=10 ** 9, niter=1, niter_decay=0, prefetch=0,
                  tf_log=True).finalize()
    result = train(opt, max_steps=2, device="cpu")
    assert result["steps"] == 2
    assert all(np.isfinite(v) for v in result["losses"].values())
    assert not os.path.exists(tmp_path / "ckpt")


def test_segtrain_at_rank_1_writes_nothing(tmp_path, monkeypatch):
    """segtrain as rank 1 (tests/test_segtrain.py's non-primary test): no
    run directory, parameters.txt, checkpoint or event file; it trains,
    validates and still tracks best_pred."""
    from seg2eye_tpu_torch.segtrain import trainer
    from test_segtrain import Args, make_voc

    root = str(tmp_path / "data")
    make_voc(root, ["a", "b", "c", "d"], ["v1", "v2"], h=40, w=40)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dp, "rank", lambda: 1)
    t = trainer.SegTrainer(Args(data_root=root, base_size=40, crop_size=32,
                                batch_size=2, no_cuda=True,
                                precision="float32"))
    assert t.saver is None and t.writer.writer is None
    t.training(0)
    miou = t.validation(0)
    assert t.best_pred == miou > 0
    assert not os.path.exists("run")


def test_refinenet_loop_at_rank_1_writes_nothing(tmp_path, monkeypatch):
    """RefineNet's main_loop as rank 1: two steps, no output directory,
    config, checkpoint, sheet row or event file, no final test."""
    from seg2eye_tpu_torch.refinenet import model, training
    from test_torch_refinenet import tiny_cfg

    monkeypatch.setattr(dp, "rank", lambda: 1)
    rng = np.random.default_rng(0)
    arrays = {"input": rng.integers(0, 256, (4, 64, 40, 3), dtype=np.uint8),
              "target": rng.integers(0, 256, (4, 64, 40, 1),
                                     dtype=np.uint8)}
    cfg = tiny_cfg(output_dir_base=str(tmp_path / "out"), max_steps=2,
                   test_every_n_steps=1)
    loader = openeds.DataLoader(ArrayDataset(arrays), batch_size=2,
                                shuffle=True, drop_last=True)
    result = training.main_loop(model.RefineNetModel(cfg, "cpu"), cfg,
                                loader, {"val": loader}, "eds_loss")
    assert result["steps"] == 2 and result["final"] == {}
    assert not os.path.exists(tmp_path / "out")


# ------------------------------------------------- two ranks against JAX
SEG2EYE_CASES = {"default": dict(lambda_style_w=1.0, lambda_style_feat=1.0,
                                 lambda_gram=1.0),
                 "batch sub-norms": dict(norm_E="spectralbatch",
                                         norm_D="spectralbatch")}
SEG2EYE_STEPS, SEG2EYE_SAMPLES = 2, 8


def jax_mesh_run(opt, nets, batches):
    """JAX's train_step on a data=2 mesh over ``batches`` from the port's
    ``nets`` -> (mean losses per iteration, variables after)."""
    from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
    from seg2eye_tpu.train import steps as jsteps

    jopt = jax_opt(opt)
    jm = JPix2Pix(jopt)
    fns = jsteps.StepFunctions(jm, donate=False)
    mesh = make_mesh(jopt, data=WORLD, model=1)
    state = replicate_state(_jax_state(jm, fns, to_jax_variables(opt, nets)),
                            mesh)
    losses = []
    for batch in batches:
        db = shard_batch({k: batch[k] for k in ("label", "style_image",
                                                "target")}, mesh)
        state, out, _ = fns.train_step(state, db)
        losses.append({k: float(jnp.mean(v)) for k, v in out.items()})
    return losses, jax.device_get(state.variables)


def one_process_run(opt, nets, batches):
    """The port's one-process run of the global ``batches`` from ``nets``
    (``train.steps``) -> (its networks as numpy, per net the elements
    whose gradient was round-off at some iteration: below 1e-5 of its
    tensor's largest, or 1e-7)."""
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.train import state as state_lib
    from seg2eye_tpu_torch.train import steps

    state = state_lib.create_state(Pix2Pix(opt, nets, "cpu"))
    noise = {k: {} for k in nets}
    for batch in batches:
        steps.train_step(state, batch)
        for name, net in nets.items():
            for k, p in net.named_parameters():
                if p.grad is None:
                    continue
                g = p.grad.abs().numpy()
                here = g <= 1e-5 * g.max() + 1e-7
                noise[name][k] = noise[name].get(k, False) | here
    return {k: {n: t.detach().numpy().copy()
                for n, t in net.state_dict().items()}
            for k, net in nets.items()}, noise


def test_seg2eye_two_ranks_match_jax_mesh(tmp_path):
    """Two iterations of ``train.loop.train`` over 2 gloo ranks (global
    batch 4, each rank loading its 2): the losses of each iteration against
    JAX's data=2 mesh run of the same global batches.  The networks after
    (every parameter, spectral u/v and running statistic of G, E and D, on
    each rank) against the port's one-process run of those batches, to
    STATE_ATOL and PARAM_ATOL, but where Adam at beta1 = 0 may step an
    element with a round-off gradient either way (up to 2 lr per
    iteration; ``test_torch_train.assert_params_close``); and against the
    JAX mesh run, each tensor no further than the one-process run is plus
    that tolerance: at batch 4 the port and JAX one-process runs already
    differ by such Adam steps (1.9e-4 in G's spectral v after one
    iteration, measured), which the power iteration carries on.  The
    children check that the two ranks' networks are bit for bit equal."""
    from seg2eye_tpu_torch.utils import weights

    inputs, want = {}, {}
    for name, extra in SEG2EYE_CASES.items():
        opt = tiny_opt(batchSize=4, name=name.replace(" ", "_"),
                       checkpoints_dir=str(tmp_path / "ckpt"),
                       print_freq=4, save_latest_freq=10 ** 9,
                       display_freq=10 ** 9, full_val_freq=10 ** 9, niter=1,
                       niter_decay=0, prefetch=0, **extra)
        arrays = {k: np.concatenate([make_batch(opt.replace(batchSize=1),
                                                seed)[k]
                                     for seed in range(SEG2EYE_SAMPLES)])
                  for k in ("label", "style_image", "target")}
        inputs[name] = (opt, arrays, SEG2EYE_STEPS)
    children = Children("seg2eye", inputs, tmp_path)
    try:
        for name, (opt, arrays, steps) in inputs.items():
            loader = openeds.DataLoader(
                ArrayDataset(arrays), batch_size=opt.batchSize, shuffle=True,
                drop_last=True, seed=opt.seed)
            loader.set_epoch(1)
            batches = list(loader)[:steps]
            nets = weights.init_networks(
                opt, torch.Generator().manual_seed(opt.seed), "cpu")
            nets.pop("VGG", None)
            losses, variables = jax_mesh_run(opt, nets, batches)
            want[name] = (losses, exported(variables, opt),
                          *one_process_run(opt, nets, batches))
    finally:
        got = children.outputs()
    for name, (opt, _, steps) in inputs.items():
        losses, mesh, single, noise = want[name]
        lr_max = 2 * opt.lr            # D's, under TTUR
        for rank_out in got:
            run = rank_out[name]
            assert len(run["losses"]) == len(losses)
            for it, (g, w) in enumerate(zip(run["losses"], losses)):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_allclose(
                        g[k], w[k], rtol=LOSS_RTOL,
                        atol=LOSS_ATOL if it == 0 else LOSS_ATOL_3,
                        err_msg=f"{name}, iteration {it + 1}: {k}")
            assert run["result"] == run["losses"][-1]
        for net, sd in got[0][name]["nets"].items():
            for k, v in sd.items():
                if k.endswith("num_batches_tracked"):
                    assert v == single[net][k], (name, net, k)
                    continue
                where = f"{name}: {net}.{k}"
                tol = STATE_ATOL if is_buffer(k) else PARAM_ATOL
                diff = np.abs(v - single[net][k])
                flip = noise[net].get(k, np.zeros(v.shape, bool))
                assert np.all(diff[~flip] <= tol), (where, diff.max())
                assert np.all(diff[flip] <= steps * 2 * lr_max + tol), where
                assert (np.abs(v - mesh[net][k]).max()
                        <= np.abs(single[net][k] - mesh[net][k]).max()
                        + tol), where


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every nn.Dropout returns its input."""
    if isinstance(context.module, nn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def test_segtrain_two_ranks_match_jax_mesh(tmp_path, monkeypatch):
    """One epoch of segtrain over 2 gloo ranks (8 training images at
    global batch 4, 4 validation images; each rank loads its 2 of every
    batch) against the JAX SegTrainer on a data=2 mesh from the port's
    seeded weights, dropout off on both sides: the epoch loss (the sum of
    the steps' global losses) and the validation mIoU (over the ranks'
    summed confusion matrices); the children check that the two ranks'
    nets are bit for bit equal; no run directory on rank 1."""
    from seg2eye_tpu.segtrain import trainer as jtrainer
    from seg2eye_tpu_torch.models.deeplab import DeepLab, kaiming_init_
    from seg2eye_tpu_torch.utils import weights
    from test_segtrain import Args, make_voc

    root = str(tmp_path / "data")
    make_voc(root, [f"t{i}" for i in range(8)], [f"v{i}" for i in range(4)],
             h=40, w=40)
    args = Args(data_root=root, base_size=40, crop_size=32, batch_size=4,
                test_batch_size=4, epochs=1, lr=0.01, no_cuda=True,
                precision="float32")
    workdir = [str(tmp_path / f"rank{r}") for r in range(WORLD)]
    for d in workdir + [str(tmp_path / "jax")]:
        os.makedirs(d)
    # the children get a namespace: Args lives in a module that imports JAX
    children = Children("segtrain", {"args": types.SimpleNamespace(
        **vars(args)), "workdir": workdir}, tmp_path)
    try:
        net = DeepLab("resnet", 16, 21, args.resnet_layers)
        kaiming_init_(net, torch.Generator().manual_seed(args.seed))
        variables = weights.deeplab_to_jax_variables(net, "resnet")
        monkeypatch.chdir(tmp_path / "jax")
        monkeypatch.setattr(jtrainer, "default_mesh", lambda bs: make_mesh(
            None, data=WORLD, model=1))
        jt = jtrainer.SegTrainer(args)
        jt.state = jt._place({
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt": jt.tx.init(variables["params"])})
        with nn.intercept_methods(no_dropout):
            want_loss = jt.training(0)
            want_miou = jt.validation(0)
    finally:
        got = children.outputs()
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["loss"], want_loss, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        assert out["miou"] == want_miou, (r, out["miou"], want_miou)
        assert out["run_dir"] == (r == 0)


def dropout_masks(cfg, m_cls, batch):
    """The keep masks (NHWC, bool) and rates that the port's dropout draws
    in one train step on ``batch`` from the step's generator, in the
    order of the calls: the shapes from a forward of the port's model,
    the draws replayed from ``dropout_generator(cfg, 0)``."""
    from seg2eye_tpu_torch.models import deeplab
    from seg2eye_tpu_torch.refinenet import training

    shapes = []

    def record(x, p, generator):
        if generator is not None:
            shapes.append((tuple(x.shape), p))
        return x

    m = m_cls(cfg, "cpu").init(torch.Generator().manual_seed(0))
    orig, deeplab.dropout = deeplab.dropout, record
    try:
        m.forward({k: torch.from_numpy(v) for k, v in batch.items()},
                  train=True, generator=torch.Generator())
    finally:
        deeplab.dropout = orig
    gen = training.dropout_generator(cfg, 0, torch.device("cpu"))
    return [(torch.empty(s).bernoulli_(1.0 - p, generator=gen).bool()
             .permute(0, 2, 3, 1).numpy(), p) for s, p in shapes]


def test_refinenet_two_ranks_match_jax_mesh(tmp_path):
    """One float64 RefineNet train step over 2 gloo ranks (global batch 4,
    dropout on, the gradient clip at 5.0 acting on the global gradient)
    against the JAX Trainer on a data=2 mesh from the same state, its
    dropout given the port's masks: scalars, parameters and running
    statistics within STEP_ATOL, momentum and clipped gradients within
    POOL_RTOL (``tests/test_torch_refinenet_train.py``); the children
    check that the two ranks' nets and momentum are bit for bit equal."""
    from seg2eye_tpu.refinenet import model as jmodel
    from seg2eye_tpu.refinenet import training as jtraining
    from seg2eye_tpu_torch.refinenet import model, training
    from test_torch_refinenet import jax_cfg, tiny_cfg
    from test_torch_refinenet_train import (POOL_RTOL, STEP_ATOL, STEP_CFG,
                                            distances, jax_variables,
                                            normalised, snapshot,
                                            step_batches)

    cfg = tiny_cfg(gradient_norm_clip=5.0, **STEP_CFG)
    batch = normalised("refinenet", step_batches("refinenet", 1)[0])
    lr = training.learning_rate_schedule(cfg, 2, 0)
    children = Children("refinenet", {"cfg": cfg, "batch": batch, "lr": lr},
                        tmp_path)
    try:
        m = model.RefineNetModel(cfg, "cpu")
        trainer = training.Trainer(m, cfg, "eds_loss", 0.99)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        m.net.double()
        before = snapshot(state)
        masks = iter(dropout_masks(cfg, model.RefineNetModel, batch))

        def port_masks(next_fun, args, kwargs, context):
            if isinstance(context.module, nn.Dropout) and \
                    context.method_name == "__call__":
                keep, p = next(masks)
                assert context.module.rate == p
                return jnp.where(keep, args[0] / (1.0 - p), 0.0)
            return next_fun(*args, **kwargs)

        jm = jmodel.RefineNetModel(jax_cfg(cfg))
        jm.dtype = jnp.float64
        mesh = make_mesh(None, data=WORLD, model=1)
        jt = jtraining.Trainer(jm, jax_cfg(cfg), "eds_loss", momentum=0.99,
                               mesh=mesh, donate=False)
        shapes = jax.eval_shape(jm.net.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 40, 3)))
        sd = {k: v.numpy() for k, v in m.net.state_dict().items()}
        with jax.enable_x64(True):
            variables = jax_variables(sd, shapes, "resnet", np.float64)
            jstate = jt.place_state({"variables": variables,
                                     "opt": jt.tx.init(variables["params"]),
                                     "step": jnp.zeros((), jnp.int32)})
            with nn.intercept_methods(port_masks):
                new, scalars, _ = jt.train_step(
                    jstate, jtraining.device_batch(batch, mesh),
                    jnp.asarray(lr, jnp.float64), jax.random.PRNGKey(1))
            trace = next(s for s in new["opt"].inner_state
                         if hasattr(s, "trace")).trace
            want = jax.device_get((scalars, new["variables"], trace))
        assert next(masks, None) is None          # every mask was used
    finally:
        got = children.outputs()
    out = got[0]
    d = distances((out["scalars"], out["net"], out["momentum"],
                   out["grads"]), want, before, cfg.weight_decay, 0.99)
    for k, v in d.items():
        assert v <= (POOL_RTOL if k in ("grads", "momentum")
                     else STEP_ATOL), d
    assert got[1]["scalars"] == out["scalars"]
