"""One rank of a multi-process run of the port, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_model_parallel.py``:
run as

    python tests/torch_parallel_child.py TASK RANK WORLD DIR

in a process of its own (no JAX).  It joins the gloo process group through
a ``FileStore`` in DIR, reads ``DIR/TASK_in.pt``, runs the task on the CPU
and writes what the test compares to ``DIR/TASK_out{RANK}.pt``.  The ranks
check between themselves that their final networks (and optimizer
buffers) are bit for bit equal; only rank 0 writes its tensors.
"""
import contextlib
import os
import shutil
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from seg2eye_tpu_torch.parallel import data_parallel as dp  # noqa: E402


class ArrayDataset:
    """A dataset over arrays in memory: sample i is row i of each."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, idx, rng=None):
        return {k: v[idx] for k, v in self.arrays.items()}


def numpy_of(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def seg2eye(inputs, rank, world):
    """Each configuration: ``train.loop.train`` over the global batches of
    a shuffled loader of the arrays, this rank loading its share; the
    losses of every iteration as means over the ranks, then G, E and D."""
    from seg2eye_tpu_torch.data.openeds import DataLoader
    from seg2eye_tpu_torch.train.loop import _scoring_model, train

    out = {}
    for name, (opt, arrays, steps) in inputs.items():
        loader = DataLoader(ArrayDataset(arrays), batch_size=opt.batchSize,
                            shuffle=True, drop_last=True, seed=opt.seed,
                            process_index=rank, process_count=world)
        losses = []
        result = train(opt, max_steps=steps, dataloader=loader,
                       device="cpu", step_hook=lambda n, l: losses.append(
                           {k: float(v)
                            for k, v in dp.mean_over_ranks(l).items()}))
        model = result["state"].model
        nets = {"G": model.netG, "E": model.netE, "D": model.netD}
        dp.check_replicated(dp.module_tensors(nets), f"{name}: trained")
        out[name] = {"losses": losses, "result": result["losses"],
                     "nets": {k: numpy_of(v) for k, v in nets.items()}}
    return out


def segtrain(inputs, rank, world):
    """One epoch of ``SegTrainer.training`` and ``validation`` from the
    args' data tree, dropout off (the JAX side's is intercepted off), in
    a working directory of this rank's."""
    from seg2eye_tpu_torch.segtrain import trainer

    os.chdir(inputs["workdir"][rank])
    trainer.dropout_generator = lambda *args: None
    t = trainer.SegTrainer(inputs["args"])
    loss = t.training(0)
    miou = t.validation(0)
    dp.check_replicated(dp.module_tensors({"net": t.net}), "trained")
    return {"loss": loss, "miou": miou, "run_dir": os.path.exists("run")}


def refinenet(inputs, rank, world):
    """One float64 ``Trainer.train_step`` on this rank's rows of a global
    batch, dropout on from the step's generator."""
    from seg2eye_tpu_torch.refinenet import model, training

    cfg = inputs["cfg"]
    m = model.RefineNetModel(cfg, "cpu")
    trainer = training.Trainer(m, cfg, "eds_loss", 0.99)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    m.net.double()
    m.dtype = torch.float64
    state.optimizer = training.make_optimizer(m.net.parameters(), cfg, 0.99)
    dp.check_replicated(dp.module_tensors({"net": m.net}), "net")
    batch = dp.local_rows(inputs["batch"], rank, world)
    scalars, _ = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        inputs["lr"], training.dropout_generator(cfg, 0, torch.device("cpu")))
    net = m.net
    dp.check_replicated({**dp.module_tensors({"net": net}), **{
        f"momentum.{n}": state.optimizer.state[p]["momentum_buffer"]
        for n, p in net.named_parameters()}}, "trained")
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "net": {k: v.clone() for k, v in net.state_dict().items()},
            "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                         .clone() for n, p in net.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in net.named_parameters()}}


def local_tensors(nets):
    """Every parameter and buffer of ``nets`` as this rank holds it, with
    whether it is a model slice."""
    from seg2eye_tpu_torch.parallel import tensor_parallel as tp

    return {f"{k}.{n}": (t.detach().clone(), tp.is_sharded(t))
            for k, net in nets.items()
            for n, t in net.state_dict(keep_vars=True).items()}


def spectral(rank):
    """A spectral conv (8 -> 32, 3x3) whole and as this model rank's
    slice: u, v, the normalised weight's rows and the weight's gradient
    rows after one power iteration and a backward of the same loss."""
    from seg2eye_tpu_torch.models.layers import SpectralConv, weight_init
    from seg2eye_tpu_torch.parallel import tensor_parallel as tp

    g = torch.Generator().manual_seed(3)
    convs = [SpectralConv(8, 32, 3) for _ in range(2)]
    convs[0].reset_parameters(weight_init("xavier", 0.02), g)
    convs[1].load_state_dict(convs[0].state_dict())
    tp.shard_({"c": convs[1]}, (), 16)
    mine = tp.rows(32)
    r = torch.randn(32, 8, 3, 3, generator=g)
    out = {}
    for name, conv in zip(("whole", "slice"), convs):
        k = conv.kernel(update_stats=True)
        (k * (r[mine] if name == "slice" else r)).sum().backward()
        out[name] = {"u": conv.weight_u.clone(), "v": conv.weight_v.clone(),
                     "sigma": (conv.weight_orig / k).detach().mean(),
                     "kernel": k.detach()[mine] if name == "whole"
                     else k.detach(),
                     "grad": conv.weight_orig.grad[mine] if name == "whole"
                     else conv.weight_orig.grad.clone()}
    return out


@contextlib.contextmanager
def no_collectives():
    """Inside, every ``all_reduce`` and ``broadcast`` raises: for work
    that one rank does while the others do not join it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective in one rank's own work")

    saved = dist.all_reduce, dist.broadcast
    dist.all_reduce = dist.broadcast = refuse
    try:
        yield
    finally:
        dist.all_reduce, dist.broadcast = saved


def grid_loader(opt, arrays, rank, world):
    """The shuffled loader of the arrays, this rank loading its data
    index's share."""
    from seg2eye_tpu_torch.data.openeds import DataLoader

    return DataLoader(ArrayDataset(arrays), batch_size=opt.batchSize,
                      shuffle=True, drop_last=True, seed=opt.seed,
                      process_index=rank // opt.model_axis,
                      process_count=world // opt.model_axis)


def per_sample_grid(opt, arrays, infer, rank, world):
    """One ``train.loop.train`` iteration on the grid with per-sample
    encoding, from the seeded state: its losses as means over the data
    ranks, every buffer of G, E and D as this rank holds it, the networks
    gathered after the G step and at the end, and inference of the grid
    against the whole copy's that rank 0 scores with alone (no collective
    allowed).  Between them, ``broadcast_buffers`` restores buffers that
    the second model rank changed."""
    from seg2eye_tpu_torch.parallel import mesh
    from seg2eye_tpu_torch.train import steps
    from seg2eye_tpu_torch.train.loop import _scoring_model, train
    from seg2eye_tpu_torch.utils import checkpoint

    def whole(model):
        nets = {"G": model.netG, "E": model.netE, "D": model.netD}
        return {k: numpy_of(v) for k, v in
                checkpoint.whole_networks(nets, opt).items()}

    after_g = {}
    d_update = steps._d_update

    def d_update_after_snapshot(state, batch, fake=None):
        after_g.update(whole(state.model))
        return d_update(state, batch, fake)

    losses = []
    steps._d_update = d_update_after_snapshot
    try:
        run = train(opt, max_steps=1, dataloader=grid_loader(
            opt, arrays, rank, world), device="cpu",
            step_hook=lambda n, l: losses.append(
                {k: float(v) for k, v in dp.mean_over_ranks(l).items()}))
    finally:
        steps._d_update = d_update
    model = run["state"].model
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    dp.check_replicated(dp.module_tensors(nets), "per-sample: trained")
    buffers = {k: t.clone() for k, t in dp.module_tensors(nets).items()
               if k.endswith(("running_mean", "weight_u"))}
    if mesh.current().model_index:      # as if computed otherwise there
        with torch.no_grad():
            for k, t in dp.module_tensors(nets).items():
                if k in buffers:
                    t.add_(1.0)
    dp.broadcast_buffers(nets.values())
    for k, t in dp.module_tensors(nets).items():
        if k in buffers:
            assert torch.equal(t, buffers[k]), k
    scoring = _scoring_model(model)
    with dp.local():
        fake = model.inference(infer)
    out = {"losses": losses, "fake": fake, "after_g": after_g,
           "buffers": {f"{k}.{n}": t.clone() for k, net in nets.items()
                       for n, t in net.named_buffers()},
           "nets": whole(model)}
    if rank == 0:
        with dp.local(), no_collectives():
            out["scored"] = scoring.inference(infer)
    return out


def model_parallel(inputs, rank, world):
    """``train.loop.train`` on a data x model grid: one iteration, then a
    resumed run of one more from its checkpoint; the losses of each as
    means over the data ranks, the final networks gathered and as this
    rank holds them, inference on a fixed batch (the grid's, and the
    whole copy's that rank 0's Testers score with), the sharded spectral
    norm against the whole one, and a one-process checkpoint resumed
    here and saved again.  Then ``per_sample_grid`` with
    ``spectralbatch`` E."""
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.parallel import tensor_parallel as tp
    from seg2eye_tpu_torch.train import state as state_lib
    from seg2eye_tpu_torch.train.loop import _scoring_model, train
    from seg2eye_tpu_torch.utils import checkpoint
    from seg2eye_tpu_torch.utils.weights import init_networks

    opt, arrays = inputs["opt"], inputs["arrays"]
    losses, runs = [], []
    for cont in (False, True):
        runs.append(train(
            opt.replace(continue_train=cont), max_steps=1,
            dataloader=grid_loader(opt, arrays, rank, world), device="cpu",
            step_hook=lambda n, l: losses.append(
                {k: float(v) for k, v in dp.mean_over_ranks(l).items()})))
        if not cont:        # keep the first iteration's files
            if rank == 0:
                for f in os.listdir(opt.expr_dir):
                    if f.startswith("latest_"):
                        shutil.copy(os.path.join(opt.expr_dir, f),
                                    os.path.join(opt.expr_dir,
                                                 "step1" + f[6:]))
            dist.barrier()
    model = runs[-1]["state"].model
    nets = {"G": model.netG, "E": model.netE, "D": model.netD}
    dp.check_replicated(dp.module_tensors(nets), "trained")
    scoring = _scoring_model(model)          # the Testers' whole copy
    with dp.local():
        fake = model.inference(inputs["infer"])
        scored = scoring.inference(inputs["infer"])
    whole = checkpoint.whole_networks(nets, opt)
    # one-process files -> a grid state -> files again
    single = opt.replace(name=inputs["single"], continue_train=True)
    state = state_lib.create_state(Pix2Pix(single, init_networks(
        single, torch.Generator().manual_seed(1), "cpu"), "cpu"))
    checkpoint.load_state(state, single, "latest")
    tp.shard_({"G": state.model.netG, "E": state.model.netE,
               "D": state.model.netD}, (state.opt_g, state.opt_d),
              opt.tp_min_channels)
    checkpoint.save_state(state, opt.replace(name=inputs["single"] + "_tp"),
                          "latest")
    return {"losses": losses, "fake": fake, "scored": scored,
            "spectral": spectral(rank),
            "local": local_tensors(nets),
            "nets": {k: numpy_of(v) for k, v in whole.items()},
            "per_sample": per_sample_grid(inputs["per_sample"], arrays,
                                          inputs["infer"], rank, world)}


def spatial_scoring(inputs, rank, world):
    """H-band inference of a fixed batch over the 4 ranks and over the
    pairs {0, 1} and {2, 3}, the Tester's 'fix' mode over the 4, and
    with per-sample encoding (``spectralbatch`` E) over the pairs."""
    from seg2eye_tpu_torch.eval.tester import Tester
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
    from seg2eye_tpu_torch.parallel import spatial
    from seg2eye_tpu_torch.test import make_dataloader

    opt = inputs["opt"]
    model = Pix2Pix(opt, inputs["nets"], "cpu")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    with dp.local():
        out = {n: model.inference(inputs["infer"], bands=spatial.Bands(g))
               for n, g in ((4, None), (2, pairs[rank // 2]))}
        for key, o, m, bands in (
                ("tester", opt, model, spatial.Bands()),
                ("per_sample_tester", inputs["per_sample"]["opt"],
                 Pix2Pix(inputs["per_sample"]["opt"],
                         inputs["per_sample"]["nets"], "cpu"),
                 spatial.Bands(pairs[rank // 2]))):
            tester = Tester(o, "validation", make_dataloader(
                o.replace(serial_batches=True, no_flip=True), "validation"),
                            bands=bands)
            out[key] = tester.run(m, mode="fix", limit=2)
    return out


TASKS = {"seg2eye": seg2eye, "segtrain": segtrain, "refinenet": refinenet,
         "model_parallel": model_parallel, "spatial": spatial_scoring}
TENSOR_KEYS = ("nets", "net", "momentum", "grads", "fake", "scored",
               "after_g")


def without_tensors(out):
    """``out`` less its networks and optimizer buffers (the other ranks'
    equal rank 0's: ``check_replicated``)."""
    if not isinstance(out, dict):
        return out
    return {k: without_tensors(v) for k, v in out.items()
            if k not in TENSOR_KEYS}


def main():
    task, rank, world, where = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    store = dist.FileStore(os.path.join(where, f"{task}_store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(where, f"{task}_in.pt"),
                            weights_only=False)
        out = TASKS[task](inputs, rank, world)
        if rank:
            out = without_tensors(out)
        torch.save(out, os.path.join(where, f"{task}_out{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
