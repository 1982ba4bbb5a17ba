"""PyTorch port, training around the step: ``--reuse_fake`` and
``D_steps_per_G = 2`` against the JAX package, the training loader against
the JAX ``DataLoader`` (flips and shuffle on), the loop (files, partial
validation, bitwise resume, no fallback to the CPU) and the train -> test
CLIs.  Tiny config as ``test_torch_train.py``; float32."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.train import steps as jsteps
from seg2eye_tpu_torch.data import openeds
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.train.loop import train
from seg2eye_tpu_torch.utils import checkpoint
from test_torch_train import (LOSS_ATOL_3, LOSS_RTOL, STATE_ATOL_N,
                              _jax_state,
                              assert_buffers_close, assert_losses_close,
                              exported, jax_opt, make_batch, port_model,
                              tiny_opt, to_jax_variables)

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs: the suite runs in
    parallel workers, and each worker's full share of OpenMP threads
    oversubscribes the cores (a loop test took 28 times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_and_port(opt):
    """(JAX model, its StepFunctions, its state, the port's state), both
    from the port's seeded weights."""
    model = port_model(opt)
    variables = to_jax_variables(opt, {"G": model.netG, "E": model.netE,
                                       "D": model.netD})
    jm = JPix2Pix(jax_opt(opt))
    fns = jsteps.StepFunctions(jm, donate=False)
    return fns, _jax_state(jm, fns, variables), state_lib.create_state(model)


def test_reuse_fake_matches_jax():
    """``--reuse_fake``: the D step trains on the G step's fake, with no
    second G forward; two iterations, losses and buffers against JAX."""
    opt = tiny_opt(reuse_fake=True)
    fns, jstate, state = jax_and_port(opt)
    launches = []
    state.model.netG.register_forward_hook(lambda *_: launches.append(1))
    for seed in range(2):
        batch = make_batch(opt, seed)
        jstate, want, _ = fns.train_step(jstate, batch)
        got, _ = steps.train_step(state, batch)
        # after one step, D's last bias (test_torch_train.py) moves the
        # D and GAN losses by the JAX side's round-off steps
        assert_losses_close(got, jax.device_get(want), LOSS_RTOL,
                            LOSS_ATOL_3)
    assert len(launches) == 2                     # one G forward per step
    assert_buffers_close(state.model,
                         exported(jax.device_get(jstate.variables), opt),
                         STATE_ATOL_N)


def test_d_steps_per_g_2_matches_jax():
    """``D_steps_per_G = 2``: G+D, D alone, G+D, as the loop schedules
    them; the losses of every step and the buffers after, against JAX's
    separate g_step and d_step."""
    opt = tiny_opt(D_steps_per_G=2)
    fns, jstate, state = jax_and_port(opt)
    for i in range(3):
        batch = make_batch(opt, i)
        if i % 2 == 0:
            jstate, want, _ = fns.g_step(jstate, batch)
            got, _ = steps.g_step(state, batch)
            assert_losses_close(got, jax.device_get(want), LOSS_RTOL,
                                LOSS_ATOL_3)
        jstate, want = fns.d_step(jstate, batch)
        got = steps.d_step(state, batch)
        # D's last bias takes round-off steps in JAX (test_torch_train.py)
        assert_losses_close(got, jax.device_get(want), LOSS_RTOL,
                            LOSS_ATOL_3)
    assert state.step == int(jstate.step) == 2
    assert_buffers_close(state.model,
                         exported(jax.device_get(jstate.variables), opt),
                         STATE_ATOL_N)


# ----------------------------------------------------------------- loader
def assert_same_batch(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("method", ["random", "ref_random3"])
def test_training_loader_matches_jax_loader(tmp_path, method):
    """Training batches (shuffle, drop_last, flips) byte for byte as the
    JAX DataLoader gives them, over two epochs pinned by set_epoch, one
    with its first batch skipped; some samples are flipped and some not."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.data import openeds as jopeneds
    from seg2eye_tpu.data import schema

    data = schema.write_synthetic_h5(str(tmp_path / "d.h5"), n_ss=5,
                                     n_gen=5, n_seq=2, h=64, w=40)
    ref = schema.write_synthetic_style_ref(str(tmp_path / "r.h5"), data,
                                           use_subsets=True)
    opt = Options(dataroot=data, style_ref=ref, style_sample_method=method,
                  crop_size=32, aspect_ratio=0.8, input_ns=2, batchSize=3,
                  isTrain=True, seed=5, prefetch=2).finalize()
    want_loader = jloader.DataLoader(
        jopeneds.OpenEDSDataset(opt, dataset_key="train"), batch_size=3,
        shuffle=True, drop_last=True, seed=opt.seed, prefetch=0)
    got_loader = openeds.create_dataloader(opt)
    assert len(got_loader) == len(want_loader) == 3        # 10 samples
    for epoch, skip in ((2, 0), (3, 1)):
        for loader in (got_loader, want_loader):
            loader.set_epoch(epoch)
            loader.skip_next_batches(skip)
        batches = list(zip(got_loader, want_loader, strict=True))
        assert len(batches) == 3 - skip
        for got, want in batches:
            assert_same_batch(got, want)
            assert got["label"].shape == (3, 40, 32)
    # the samples' coins (after the two crop draws) fall both ways
    coins = set()
    for epoch in (2, 3):
        for i in range(10):
            rng = np.random.default_rng((opt.seed, epoch, i))
            rng.integers(0, 1), rng.integers(0, 1)
            coins.add(bool(rng.random() > 0.5))
    assert coins == {True, False}
    assert_same_batch(got_loader.get_particular(4),
                      want_loader.get_particular(4))


def test_threaded_iter_order_errors_and_early_stop():
    """The loader's read-ahead thread: items come in order; a worker's
    exception is raised after the items made before it; a consumer that
    stops early releases the worker (bounded wait)."""
    import threading
    import time

    assert list(openeds.threaded_iter(range(500), lambda i: 2 * i, 3)) == \
        [2 * i for i in range(500)]

    def bad(i):
        if i == 5:
            raise ValueError("boom")
        return i

    got = []
    with pytest.raises(ValueError, match="boom"):
        for x in openeds.threaded_iter(range(10), bad, 2):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    before = threading.active_count()
    it = openeds.threaded_iter(range(10 ** 6), lambda i: i, 2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_device_prefetch_runs_one_batch_ahead():
    """Each batch's copy is made before the previous batch is handed out;
    the model's keys arrive as tensors, the rest stays on the host."""
    read = []

    def source():
        for i in range(3):
            read.append(i)
            yield {"label": np.full((1, 2, 2), i, np.int32), "user": [i]}

    seen = []
    for host, dev in openeds.device_prefetch(source(), "cpu"):
        seen.append((list(read), host["user"][0]))
        assert list(dev) == ["label"] and int(dev["label"][0, 0, 0]) == \
            host["user"][0]
    assert seen == [([0, 1], 0), ([0, 1, 2], 1), ([0, 1, 2], 2)]


# ------------------------------------------------------------------- loop
@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    from seg2eye_tpu.data import schema

    d = tmp_path_factory.mktemp("loop")
    return d, schema.write_synthetic_h5(str(d / "data.h5"), h=64, w=40)


def loop_opt(h5, name, **kw):
    d, data = h5
    base = dict(dataroot=data, name=name, checkpoints_dir=str(d / "ckpt"),
                ngf=4, ndf=4, crop_size=32, aspect_ratio=1.0, w_dim=8,
                input_ns=2, batchSize=2, compute_dtype="float32",
                isTrain=True, seed=0, print_freq=2, save_latest_freq=10**9,
                display_freq=10**9, full_val_freq=10**9, niter=1,
                niter_decay=0, prefetch=0)
    return Options(**{**base, **kw}).finalize()


def test_loop_writes_the_reference_layout(h5, capsys):
    """Three steps from the H5 file: losses printed and logged, partial
    validation on the train and validation splits, the latest checkpoints
    (G/D/E and optimizers) and iter.txt; G and E strict-load for scoring."""
    opt = loop_opt(h5, "layout", display_freq=4)
    result = train(opt, max_steps=3, device="cpu")
    assert result["steps"] == 3
    assert all(np.isfinite(v) for v in result["losses"].values())
    for fn in ("iter.txt", "loss_log.txt", "latest_net_G.pth",
               "latest_net_D.pth", "latest_net_E.pth", "latest_optim.pth"):
        assert os.path.exists(os.path.join(opt.expr_dir, fn)), fn
    out = capsys.readouterr().out
    assert out.count("Running validation for mode 'rand'") == 2
    assert "(epoch: 1, iters: 2," in out
    log = open(os.path.join(opt.expr_dir, "loss_log.txt")).read()
    assert "GAN_Feat:" in log and "D/Fake:" in log
    from seg2eye_tpu_torch.models.pix2pix import build_networks
    checkpoint.load_networks(build_networks(opt.replace(isTrain=False)),
                             opt, "latest")


def test_loop_in_memory_batches_and_step_hook(h5):
    """The loop over a caller's batches (no H5 read for training); the
    step hook sees every iteration."""
    opt = loop_opt(h5, "memory", print_freq=10**9)

    class Batches:
        def __init__(self):
            self.epochs = []

        def __len__(self):
            return 2

        def set_epoch(self, epoch):
            self.epochs.append(epoch)

        def skip_next_batches(self, n):
            raise AssertionError("not resuming")

        def __iter__(self):
            return iter([make_batch(opt, s) for s in range(2)])

    hooked = []
    batches = Batches()
    result = train(opt, max_steps=3, dataloader=batches, device="cpu",
                   step_hook=lambda n, losses: hooked.append(
                       (n, sorted(losses))))
    assert result["steps"] == 2 and batches.epochs == [1]   # one epoch
    assert [n for n, _ in hooked] == [1, 2]
    assert "D/real" in hooked[0][1] and "L2/raw" not in hooked[0][1]


@pytest.mark.parametrize("flag", [{"spatial_shard": True},
                                  {"model_axis": 2}],
                         ids=["spatial_shard", "model_axis"])
def test_loop_refuses_what_is_not_ported(h5, flag):
    """The multi-device options at one process: a model axis of 2 needs
    two processes and raises, as ``make_mesh`` does; ``--spatial_shard``
    bands nothing at one process (JAX's ``device_count() > 1``), and the
    run is bit for bit the run without it."""
    if "model_axis" in flag:
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            train(loop_opt(h5, "refused", **flag), device="cpu")
        return
    runs = [train(loop_opt(h5, f"spatial{i}", **extra), max_steps=2,
                  device="cpu") for i, extra in enumerate((flag, {}))]
    assert [r["steps"] for r in runs] == [2, 2]
    assert runs[0]["losses"] == runs[1]["losses"]
    for a, b in zip(*(r["state"].model.netG.state_dict().values()
                      for r in runs)):
        assert torch.equal(a, b)


def test_no_fallback_without_a_card(h5, monkeypatch, tmp_path):
    """With no card, training on 'cuda' raises, by the loop and the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(loop_opt(h5, "nocard"), device="cuda")
    from seg2eye_tpu_torch.train.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda", "--name", "nocard", "--dataroot", h5[1],
              "--checkpoints_dir", str(tmp_path)])


def test_resume_trajectory_bitwise(h5):
    """N iterations straight against 3 + save/restore + the rest (a
    mid-epoch cut), shuffle and flips on: bitwise-equal networks (buffers
    included), optimizer states and step count."""
    def run(name, phases):
        opt = loop_opt(h5, name, niter=2, save_epoch_freq=1)
        opt.save()
        result = None
        for i, max_steps in enumerate(phases):
            result = train(opt.replace(continue_train=i > 0),
                           max_steps=max_steps, device="cpu")
        return result

    straight = run("straight", [None])
    n = straight["steps"]
    assert n >= 4, f"need >=2 epochs of >=2 batches, got {n} steps"
    split = run("split", [3, None])
    assert split["steps"] == n - 3
    a, b = straight["state"], split["state"]
    assert a.step == b.step == n
    for name in ("netG", "netE", "netD"):
        sa = getattr(a.model, name).state_dict()
        sb = getattr(b.model, name).state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    for opt_name in ("opt_g", "opt_d"):
        oa = getattr(a, opt_name).state_dict()["state"]
        ob = getattr(b, opt_name).state_dict()["state"]
        assert oa.keys() == ob.keys()
        for i in oa:
            for k in oa[i]:
                assert torch.equal(oa[i][k], ob[i][k]), (opt_name, i, k)


def _run(module, args):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_cli_then_test_cli(h5):
    """``python -m seg2eye_tpu_torch.train --device cpu`` trains two steps
    and saves; ``python -m seg2eye_tpu_torch.test --device cpu`` scores
    its checkpoint."""
    d, data = h5
    flags = ["--device", "cpu", "--dataroot", data, "--name", "cli",
             "--checkpoints_dir", str(d / "ckpt"), "--ngf", "4", "--ndf", "4",
             "--crop_size", "32", "--aspect_ratio", "1.0", "--w_dim", "8",
             "--input_ns", "2", "--batchSize", "2", "--compute_dtype",
             "float32"]
    out = _run("seg2eye_tpu_torch.train",
               flags + ["--niter", "1", "--niter_decay", "0", "--max_steps",
                        "2", "--print_freq", "2"])
    assert "Training was successfully finished." in out
    assert re.search(r"\(epoch: 1, iters: 2, .*GAN: ", out)
    out = _run("seg2eye_tpu_torch.test", flags + ["--dataset_key",
                                                  "validation"])
    score = float(re.search(r"mse/validation/full/relative, ([0-9.]+)",
                            out).group(1))
    assert np.isfinite(score) and score > 0
    opt_pkl = dataclasses.asdict(Options.load(str(d / "ckpt" / "cli")))
    assert opt_pkl["max_steps"] == 2 and opt_pkl["isTrain"] is True


def test_train_profile_groups(monkeypatch):
    """tools/profile_cell.py --ops names the op behind each kernel: on a CPU
    profile of a tiny autograd graph (with input shapes), each aten op is
    filed under its outermost aten op, the autograd node it ran under in
    the backward or "forward", and that op's first input shape; the op
    table charges each launched kernel to its op."""
    import importlib.util
    from types import SimpleNamespace

    monkeypatch.syspath_prepend(REPO)
    spec = importlib.util.spec_from_file_location(
        "profile_cell", os.path.join(REPO, "tools", "profile_cell.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)

    a = torch.randn(2, 3, requires_grad=True)
    b = torch.randn(3, 5, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as p:
        (a.mm(b).relu() * 2.0).sum().backward()
    named = {(prof.node_of(e), *prof.op_of(e))
             for e in p.events() if e.name.startswith("aten::")}
    assert ("forward", "aten::mm", "[2, 3]") in named
    assert ("forward", "aten::relu", "[2, 5]") in named
    assert ("MmBackward0", "aten::mm", "[2, 5]") in named
    assert any(node == "ReluBackward0" for node, _, _ in named)
    assert not any(node.startswith("autograd::") for node, _, _ in named)

    # kernels charged per step to the op that launched them
    forward_mm = next(e for e in p.events() if e.name == "aten::mm"
                      and prof.node_of(e) == "forward")
    monkeypatch.setattr(forward_mm, "kernels",
                        [SimpleNamespace(duration=30.0)] * 4, raising=False)
    table = prof.op_table([forward_mm], 2)
    assert dict(table) == {("forward", "aten::mm", "[2, 3]"): [60.0, 4]}
