"""PyTorch port, tensor parallelism (``--model_axis``,
``parallel.tensor_parallel``) and H-band scoring (``--spatial_shard``,
``parallel.spatial``) against the JAX package's mesh, on the CPU.

In process: the set of parameters that the port's rule shards against
the leaves that JAX's ``param_shardings`` shards, and the kernel's packing
cache on the views that a model rank passes.  Two spawns of four gloo
processes (``torch_parallel_child.py``, as in ``test_torch_parallel.py``)
while this process computes the JAX side:

  * a data 2 x model 2 grid runs ``train.loop.train`` (ngf 4, ndf 4, crop
    32, global batch 4, float32, ``tp_min_channels`` 16): one iteration,
    then one more resumed from its checkpoint, each against JAX's
    ``train_step`` on ``make_mesh(data=2, model=2)`` with
    ``param_shardings`` from the same state (the second from the files the
    first wrote); the networks after, inference, the slices and the
    replicated tensors on each rank, a sharded spectral norm against the
    whole one, and the checkpoints both ways; then one iteration with
    per-sample encoding (``spectralbatch`` E, 'auto') from the seeded
    state, against JAX's mesh ``train_step`` (losses at LOSS_RTOL /
    LOSS_ATOL, networks at STATE_ATOL / PARAM_ATOL through the port's
    one-process run) with every buffer bit for bit on all four ranks;
  * H-band inference over 2 and 4 ranks against JAX's inference under
    ``spatial_constraint`` on 2- and 4-device data meshes, and the Tester
    in mode 'fix' against JAX's Tester under ``--spatial_shard`` (TESTER_RTOL
    / TESTER_ATOL), over 4 bands and, with per-sample encoding, over 2.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.parallel.sharding import (make_mesh, param_shardings,
                                           place_state, replicate_state,
                                           shard_batch,
                                           shard_batch_spatial,
                                           spatial_constraint)
from seg2eye_tpu_torch.data import openeds
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
from seg2eye_tpu_torch.parallel import tensor_parallel as tp
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.utils import checkpoint, weights
from test_torch_parallel import (LOSS_ATOL, LOSS_RTOL, PARAM_ATOL,
                                 STATE_ATOL, Children)
from test_torch_train import (STYLE, _jax_state, exported, is_buffer,
                              jax_opt, make_batch, to_jax_variables,
                              tiny_opt)
from torch_parallel_child import ArrayDataset

GRID = {"data_axis": 2, "model_axis": 2, "tp_min_channels": 16}
WORLD = 4
SAMPLES = 8
INFER_RTOL, INFER_ATOL = 2e-3, 2e-4      # test_tp_param_sharding_executes
SPECTRAL_TOL = 1e-6
WHOLE_TOL = 1e-5          # a whole copy against the slices: f32 order
CP_RTOL, CP_ATOL = 2e-4, 2e-5            # test_spatial_sharded_inference
TESTER_RTOL, TESTER_ATOL = 2e-3, 1e-6    # test_tester_spatial_shard_matches


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_nets(opt):
    nets = weights.init_networks(opt, torch.Generator().manual_seed(opt.seed),
                                 "cpu")
    nets.pop("VGG", None)
    return nets


def sharded_names(nets, model, min_channels):
    """'{net}.{parameter}' of every parameter that the port's rule
    shards."""
    return {f"{key}.{name}" for key, net in nets.items()
            for name, p in net.named_parameters()
            if tp.rule(p, model, min_channels)}


def grid_opt(tmp, **kw):
    return tiny_opt(batchSize=4, checkpoints_dir=str(tmp / "ckpt"),
                    name="grid", print_freq=4, save_latest_freq=10 ** 9,
                    display_freq=10 ** 9, full_val_freq=10 ** 9, niter=1,
                    niter_decay=0, prefetch=0, **STYLE, **GRID, **kw)


# ------------------------------------------------------------- in process
def test_rule_shards_what_param_shardings_shards():
    """The port's rule (``tensor_parallel.rule``) at model 2 and 16
    channels against ``param_shardings`` on a data 2 x model 2 mesh: the
    parameters it shards, marked through ``utils.weights``' names, are
    the JAX leaves that come out sharded, in G, E and D."""
    opt = tiny_opt(**GRID)
    nets = seeded_nets(opt)
    names = sharded_names(nets, 2, opt.tp_min_channels)
    assert names and any(n.startswith("D.") for n in names)
    marked = {}
    for key, net in nets.items():
        sd = {k: np.full(v.shape, 1.0 if f"{key}.{k}" in names else 0.0,
                         np.float32)
              for k, v in net.state_dict().items()}
        marked[key] = weights.IMPORTERS[key](sd)
    mesh = make_mesh(jax_opt(opt), data=2, model=2)
    specs = param_shardings(to_jax_variables(opt, nets), mesh,
                            min_channels=opt.tp_min_channels)
    for key in nets:
        got = {jax.tree_util.keystr(p) for p, v in
               jax.tree_util.tree_leaves_with_path(marked[key])
               if np.all(v == 1.0)}
        want = {jax.tree_util.keystr(p) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    specs[key], is_leaf=lambda x: hasattr(x, "spec"))
                if any(a is not None for a in s.spec)}
        assert got == want, (key, got ^ want)


def test_packed_weights_key_views_by_base():
    """A model rank hands the kernel its block of the whole gamma/beta
    biases as a view made anew at every call; the cache finds it by its
    base tensor, offset and shape, packs it once, again after an in-place
    change, and keeps the two blocks of one bias apart."""
    from seg2eye_tpu_torch.ops import spade_style as K

    g = torch.Generator().manual_seed(0)
    wg, wb = (torch.randn(4, K.NHIDDEN, 3, 3, generator=g) for _ in "gb")
    bg, bb = (torch.nn.Parameter(torch.randn(8, generator=g))
              for _ in "gb")
    packed = K.PackedWeights()

    def call(lo):
        return packed(wg, bg[lo:lo + 4], wb, bb[lo:lo + 4], torch.float32)

    first = call(0)
    assert call(0)[1] is first[1] and packed.packings == 1
    assert torch.equal(call(4)[1][:, 0], bg[4:].detach())
    assert packed.packings == 2
    with torch.no_grad():
        bg.add_(1.0)
    again = call(0)
    assert packed.packings == 3
    assert torch.equal(again[1][:, 0], bg[:4].detach())


# ------------------------------------------------- the data x model grid
def jax_state_from(opt, path_opt, which):
    """The JAX train state that the port's ``which`` checkpoint holds:
    read into a one-process port state, written in the JAX package's
    format, restored by its ``load_state``."""
    from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
    from seg2eye_tpu.train import steps as jsteps
    from seg2eye_tpu.utils import checkpoint as jcheckpoint

    state = port_state(opt, path_opt, which)
    out = path_opt.replace(name=path_opt.name + "_jax")
    checkpoint.save_state_jax(state, out, which)
    jm = JPix2Pix(jax_opt(opt))
    fns = jsteps.StepFunctions(jm, donate=False)
    template = _jax_state(jm, fns, to_jax_variables(opt, {
        "G": state.model.netG, "E": state.model.netE,
        "D": state.model.netD}))
    return jcheckpoint.load_state(template, jax_opt(out), which), fns


def port_state(opt, path_opt, which):
    """A one-process port state read from ``which`` in ``path_opt``'s
    run directory."""
    state = state_lib.create_state(Pix2Pix(opt, seeded_nets(opt), "cpu"))
    checkpoint.load_state(state, path_opt, which)
    return state


def jax_grid_step(state, fns, opt, batch):
    """One JAX train_step on the data 2 x model 2 mesh with
    ``param_shardings`` -> (mean losses, the state after)."""
    mesh = make_mesh(jax_opt(opt), data=2, model=2)
    state = place_state(state, param_shardings(
        state, mesh, min_channels=opt.tp_min_channels))
    db = shard_batch({k: batch[k] for k in ("label", "style_image",
                                            "target")}, mesh)
    state, out, _ = fns.train_step(state, db)
    return {k: float(jnp.mean(v)) for k, v in out.items()}, state


def port_step(state, batch, update=steps.train_step):
    """One one-process port iteration (or the G or D step alone:
    ``update``) -> (its networks as numpy, per net the elements whose
    gradient was round-off: below 1e-5 of its tensor's largest, or 1e-7;
    G's and E's from the G step, D's from the D step, as ``train_step``
    leaves them)."""
    model = state.model
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    update(state, batch)
    noise = {}
    for name, net in nets.items():
        noise[name] = {}
        for k, p in net.named_parameters():
            if p.grad is not None:
                g = p.grad.abs().numpy()
                noise[name][k] = g <= 1e-5 * g.max() + 1e-7
    return {k: {n: t.detach().numpy().copy()
                for n, t in net.state_dict().items()}
            for k, net in nets.items()}, noise


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """The four ranks' results, the global batches, the JAX side's losses
    and states, and the port's one-process step from the same files."""
    tmp = tmp_path_factory.mktemp("grid")
    opt = grid_opt(tmp)
    arrays = {k: np.concatenate([make_batch(opt.replace(batchSize=1),
                                            seed)[k]
                                 for seed in range(SAMPLES)])
              for k in ("label", "style_image", "target")}
    infer = make_batch(opt.replace(batchSize=2), 99)
    # a one-process run's checkpoint, for the grid to resume
    single = opt.replace(name="single")
    one = state_lib.create_state(Pix2Pix(single, seeded_nets(single),
                                         "cpu"))
    steps.train_step(one, make_batch(opt, 7))
    checkpoint.save_state(one, single, "latest")
    ps_opt = opt.replace(name="grid_ps", norm_E="spectralbatch")
    assert ps_opt.per_sample_encode_enabled
    children = Children("model_parallel", {
        "opt": opt, "arrays": arrays, "single": "single",
        "per_sample": ps_opt,
        "infer": {k: infer[k] for k in ("label", "style_image")}},
        tmp, world=WORLD)
    try:
        loader = openeds.DataLoader(ArrayDataset(arrays), batch_size=4,
                                    shuffle=True, drop_last=True,
                                    seed=opt.seed)
        loader.set_epoch(1)
        batches = list(loader)
        from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
        from seg2eye_tpu.train import steps as jsteps

        jm = JPix2Pix(jax_opt(opt))
        fns = jsteps.StepFunctions(jm, donate=False)
        nets = seeded_nets(opt)
        first, _ = jax_grid_step(_jax_state(jm, fns, to_jax_variables(
            opt, nets)), fns, opt, batches[0])
        jm = JPix2Pix(jax_opt(ps_opt))
        ps_fns = jsteps.StepFunctions(jm, donate=False)
        ps_losses, ps_jstate = jax_grid_step(_jax_state(
            jm, ps_fns, to_jax_variables(ps_opt, seeded_nets(ps_opt))),
            ps_fns, ps_opt, batches[0])
    finally:
        got = children.outputs()
    state1, fns = jax_state_from(opt, opt, "step1")
    second, jstate = jax_grid_step(state1, fns, opt, batches[1])
    single_nets, noise = port_step(port_state(opt, opt, "step1"),
                                   batches[1])
    # the one-process G step from the seeded state, and D step from the
    # grid's state after its G step
    after_g, g_noise = port_step(state_lib.create_state(Pix2Pix(
        ps_opt, seeded_nets(ps_opt), "cpu")), batches[0], steps.g_step)
    nets = seeded_nets(ps_opt)
    for k, net in nets.items():
        net.load_state_dict({n: torch.from_numpy(v) for n, v in
                             got[0]["per_sample"]["after_g"][k].items()})
    ps_single, ps_noise = port_step(state_lib.create_state(Pix2Pix(
        ps_opt, nets, "cpu")), batches[0], steps.d_step)
    yield {"opt": opt, "got": got, "jax_losses": [first, second],
           "jax_nets": exported(jax.device_get(jstate.variables), opt),
           "single": single_nets, "noise": noise, "infer": infer,
           "tmp": tmp, "per_sample": {
               "opt": ps_opt, "jax_losses": ps_losses,
               "jax_nets": exported(jax.device_get(ps_jstate.variables),
                                    ps_opt),
               "after_g": after_g, "g_noise": g_noise,
               "single": ps_single, "noise": ps_noise}}
    shutil.rmtree(tmp, ignore_errors=True)


def test_grid_training_matches_jax_mesh(grid_run):
    """Each iteration's losses (means over the data ranks) against JAX's
    step from the same state at the data-parallel test's bound (the first
    from the seeded state, the second from the files the first wrote and
    the grid resumed from).  The networks after (gathered) against the
    port's one-process iteration from those files to STATE_ATOL and
    PARAM_ATOL but where Adam at beta1 = 0 may step an element with a
    round-off gradient either way (up to 2 lr), and against JAX's no
    further than the one-process run is, plus that tolerance
    (``test_torch_parallel.test_seg2eye_two_ranks_match_jax_mesh``)."""
    opt, got = grid_run["opt"], grid_run["got"]
    lr_max = 2 * opt.lr
    for r, out in enumerate(got):
        assert len(out["losses"]) == 2
        for it, (g, w) in enumerate(zip(out["losses"],
                                        grid_run["jax_losses"])):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(
                    g[k], w[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                    err_msg=f"rank {r}, iteration {it + 1}: {k}")
    assert_nets_close(got[0]["nets"], grid_run["single"],
                      grid_run["jax_nets"], grid_run["noise"], lr_max,
                      "iteration 2")


def assert_nets_close(got, single, mesh, noise, lr_max, where):
    """Each tensor of the gathered networks ``got`` against the port's
    one-process run ``single`` to STATE_ATOL (buffers) and PARAM_ATOL, up
    to 2 ``lr_max`` where Adam at beta1 = 0 may step an element with a
    round-off gradient (``noise``) either way, and against JAX's ``mesh``
    (where given) no further than the one-process run is, plus that
    tolerance; ``num_batches_tracked`` exactly the one-process run's."""
    for net, sd in got.items():
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                assert v == single[net][k], (where, net, k)
                continue
            tol = STATE_ATOL if is_buffer(k) else PARAM_ATOL
            diff = np.abs(v - single[net][k])
            flip = noise[net].get(k, np.zeros(v.shape, bool))
            assert np.all(diff[~flip] <= tol), (where, net, k, diff.max())
            assert np.all(diff[flip] <= 2 * lr_max + tol), (where, net, k)
            if mesh is not None:
                assert (np.abs(v - mesh[net][k]).max()
                        <= np.abs(single[net][k] - mesh[net][k]).max()
                        + tol), (where, net, k)


def test_grid_per_sample_encoding_matches_jax_mesh(grid_run):
    """Per-sample encoding (``spectralbatch`` E, 'auto') on the data 2 x
    model 2 grid, one ``train.loop.train`` iteration from the seeded
    state: each data rank encodes its 2 samples with u iterated from their
    global index, through E's convs sharded over its model group, and
    replays every sample's running update in global order, in the G
    step's two encodes and the D step's regeneration.  The losses (means
    over the data ranks) against JAX's ``train_step`` on
    ``make_mesh(data=2, model=2)`` with ``param_shardings`` (its
    ``lax.scan`` over the global batch) at LOSS_RTOL / LOSS_ATOL.  Each
    step from identical states, as ``assert_nets_close`` says (STATE_ATOL,
    PARAM_ATOL): the networks after the G step against the port's
    one-process G step, and at the end against its D step from the grid's
    state after the G step, and against JAX's iteration.  (A whole
    iteration is not comparable: the grid's Adam stepped one element of
    G's up_0.conv_0 with a round-off gradient the other way, 1.9e-4, and
    the D step's regeneration carried it into G's u/v and running
    statistics, 1.2e-4 to 1.9e-4, measured.)  Every buffer (spectral u/v,
    E's and D's running statistics, ``num_batches_tracked``) bit for bit
    equal on all four ranks (and, in the children, buffers that the
    second model rank was made to change are the first's again after
    ``data_parallel.broadcast_buffers``); rank 0's whole scoring copy, run
    with every collective refused, gives the grid's fake to WHOLE_TOL."""
    ps, got = grid_run["per_sample"], [o["per_sample"] for o in
                                       grid_run["got"]]
    for r, out in enumerate(got):
        assert len(out["losses"]) == 1
        g, w = out["losses"][0], ps["jax_losses"]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f"rank {r}: {k}")
        assert sorted(out["buffers"]) == sorted(got[0]["buffers"])
        for k, t in out["buffers"].items():
            assert torch.equal(t, got[0]["buffers"][k]), (r, k)
    assert any(k.startswith("E.") and k.endswith("running_mean")
               for k in got[0]["buffers"])
    lr_max = 2 * ps["opt"].lr
    assert_nets_close(got[0]["after_g"], ps["after_g"], None, ps["g_noise"],
                      lr_max, "G step")
    assert_nets_close(got[0]["nets"], ps["single"], ps["jax_nets"],
                      ps["noise"], lr_max, "D step")
    torch.testing.assert_close(got[0]["scored"], got[0]["fake"],
                               rtol=WHOLE_TOL, atol=WHOLE_TOL)


def test_grid_slices_and_inference(grid_run):
    """Every rank: the slices of the two model ranks differ and each
    equals its data twin's; every whole tensor is bit for bit equal on
    all four ranks.  Inference of the trained grid against JAX's
    inference with ``param_shardings`` on the mesh from the same
    (gathered) networks, and the whole copy that rank 0's Testers score
    with (``train.loop._scoring_model``) against the grid's."""
    from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix

    opt, got = grid_run["opt"], grid_run["got"]
    local = [out["local"] for out in got]
    n_sharded = 0
    for k, (t, sharded) in local[0].items():
        if not sharded:
            assert all(torch.equal(t, other[k][0]) for other in local), k
            continue
        n_sharded += 1
        assert all(other[k][1] for other in local), k
        assert torch.equal(t, local[2][k][0]), k          # d=1, m=0
        assert torch.equal(local[1][k][0], local[3][k][0]), k
        assert not torch.equal(t, local[1][k][0]), k
        assert t.shape[0] * 2 == got[0]["nets"][k[0]][k[2:]].shape[0], k
    assert n_sharded == len(sharded_names(seeded_nets(opt), 2,
                                          opt.tp_min_channels))
    nets = seeded_nets(opt)
    for k, net in nets.items():
        net.load_state_dict({n: torch.from_numpy(v) for n, v in
                             got[0]["nets"][k].items()})
    jm = JPix2Pix(jax_opt(opt))
    mesh = make_mesh(jax_opt(opt), data=2, model=2)
    variables = {k: v for k, v in to_jax_variables(opt, nets).items()
                 if k in ("G", "E")}
    variables = jax.device_put(variables, param_shardings(
        variables, mesh, min_channels=opt.tp_min_channels))
    infer = grid_run["infer"]
    db = shard_batch({k: infer[k] for k in ("label", "style_image")}, mesh)
    want = np.asarray(jax.jit(lambda v, l, s: jm.inference(
        v, {"label": l, "style_image": s}))(variables, db["label"],
                                            db["style_image"]))
    np.testing.assert_allclose(got[0]["fake"].numpy(), want,
                               rtol=INFER_RTOL, atol=INFER_ATOL)
    torch.testing.assert_close(got[0]["scored"], got[0]["fake"],
                               rtol=WHOLE_TOL, atol=WHOLE_TOL)


def test_grid_spectral_norm_matches_whole(grid_run):
    """A spectral conv sharded over the two model ranks against the whole
    one, one training forward and a backward on each rank: sigma, u, v
    and the normalised rows within SPECTRAL_TOL; the weight's gradient
    rows (about 1 / sigma = 65 times the loss's) within SPECTRAL_TOL of
    their norm."""
    for r, out in enumerate(grid_run["got"]):
        whole, part = out["spectral"]["whole"], out["spectral"]["slice"]
        for k in ("sigma", "u", "v", "kernel"):
            torch.testing.assert_close(part[k], whole[k], rtol=SPECTRAL_TOL,
                                       atol=SPECTRAL_TOL,
                                       msg=f"rank {r}: {k}")
        assert (torch.linalg.vector_norm(part["grad"] - whole["grad"])
                <= SPECTRAL_TOL * torch.linalg.vector_norm(whole["grad"])), r


def test_grid_checkpoints_round_trip(grid_run):
    """The grid's files have the names and every tensor the shape of a
    one-process run's; a one-process checkpoint read by the grid and
    written again is bit for bit the same, and the grid's last files read
    in one process are bit for bit the gathered networks."""
    opt, tmp = grid_run["opt"], grid_run["tmp"]
    ckpt = tmp / "ckpt"

    def files(name):
        return {f: torch.load(ckpt / name / f, weights_only=True)
                for f in os.listdir(ckpt / name)
                if f.startswith("latest_") and f.endswith(".pth")}

    grid, single, again = files("grid"), files("single"), files("single_tp")
    assert sorted(grid) == sorted(single) == sorted(again) == [
        "latest_net_D.pth", "latest_net_E.pth", "latest_net_G.pth",
        "latest_optim.pth"]
    shapes = [jax.tree_util.tree_map(
        lambda t: tuple(t.shape) if torch.is_tensor(t) else None, f)
        for f in (grid, single)]
    assert shapes[0] == shapes[1]
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), again, single)
    state = port_state(opt, opt, "latest")
    for key, net in (("G", state.model.netG), ("E", state.model.netE),
                     ("D", state.model.netD)):
        for k, v in net.state_dict().items():
            assert np.array_equal(v.numpy(),
                                  grid_run["got"][0]["nets"][key][k]), k


# ---------------------------------------------------------------- H bands
@pytest.fixture(scope="module")
def band_run(tmp_path_factory):
    """The four ranks' H-band results and the JAX side's."""
    from seg2eye_tpu.data import schema
    from seg2eye_tpu.eval.tester import Tester as JTester
    from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix

    tmp = tmp_path_factory.mktemp("bands")
    data = schema.write_synthetic_h5(str(tmp / "data.h5"), h=64, w=40)
    opt = tiny_opt(isTrain=False, dataroot=data, name="bands",
                   checkpoints_dir=str(tmp / "ckpt"))
    nets = seeded_nets(opt)
    infer = make_batch(opt.replace(batchSize=2), 5)
    infer = {k: infer[k] for k in ("label", "style_image")}
    ps_opt = opt.replace(name="bands_ps", norm_E="spectralbatch")
    assert ps_opt.per_sample_encode_enabled and ps_opt.batchSize > 1
    ps_nets = seeded_nets(ps_opt)
    children = Children("spatial", {
        "opt": opt, "nets": nets, "infer": infer,
        "per_sample": {"opt": ps_opt, "nets": ps_nets}}, tmp, world=WORLD)
    try:
        jm = JPix2Pix(jax_opt(opt))
        variables = weights.to_jax_variables(nets)
        want = {}
        for n in (2, 4):
            mesh = make_mesh(None, data=n, model=1)
            cs = spatial_constraint(mesh)
            want[n] = np.asarray(jax.jit(lambda v, b: jm.inference(
                v, b, constrain=cs))(replicate_state(variables, mesh),
                                     shard_batch_spatial(infer, mesh)))
        for key, o, n in (("tester", opt, nets),
                          ("per_sample_tester", ps_opt, ps_nets)):
            tester = JTester(jax_opt(o).replace(spatial_shard=True),
                             dataset_key="validation")
            want[key] = tester.run(JPix2Pix(jax_opt(o)),
                                   weights.to_jax_variables(n), mode="fix",
                                   limit=2)
    finally:
        got = children.outputs()
    yield got, want
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("n", [2, 4])
def test_band_inference_matches_jax(band_run, n):
    """Inference in n H bands (the tiny generator's 1- and 2-row maps
    whole where n does not divide them, 1-row bands that gather for the
    kernel's 2-row halo) against JAX's under ``spatial_constraint`` on an
    n-device data mesh; every rank holds the same whole fake."""
    got, want = band_run
    ranks = range(WORLD) if n == 4 else (0, 2)
    for r in ranks:
        np.testing.assert_allclose(got[r][n].numpy(), want[n], rtol=CP_RTOL,
                                   atol=CP_ATOL, err_msg=f"rank {r}")


def assert_tester_matches(got, want, key):
    for r in range(WORLD):
        assert sorted(got[r][key]) == sorted(want[key])
        for k, v in want[key].items():
            np.testing.assert_allclose(got[r][key][k], v,
                                       rtol=TESTER_RTOL, atol=TESTER_ATOL,
                                       err_msg=f"rank {r}: {k}")


def test_band_tester_matches_jax(band_run):
    """``Tester.run`` in mode 'fix' (limit 2) over 4 H bands against the
    JAX Tester under ``--spatial_shard`` on its 8-device mesh."""
    assert_tester_matches(*band_run, "tester")


def test_band_per_sample_tester_matches_jax(band_run):
    """The same with ``spectralbatch`` E (per-sample encoding through
    'auto', batch 2) over 2 H bands, the pairs of ranks: both sides encode
    each sample on its own (JAX's ``lax.scan`` under ``constrain``), its
    batch statistics over that sample's references summed over the
    bands; TESTER_RTOL / TESTER_ATOL."""
    assert_tester_matches(*band_run, "per_sample_tester")
