"""One rank of a data-parallel run of the port, for
``tests/test_torch_parallel.py``: run as

    python tests/torch_parallel_child.py TASK RANK WORLD DIR

in a process of its own (no JAX).  It joins the gloo process group through
a ``FileStore`` in DIR, reads ``DIR/TASK_in.pt``, runs the task on the CPU
and writes what the test compares to ``DIR/TASK_out{RANK}.pt``.  The ranks
check between themselves that their final networks (and optimizer
buffers) are bit for bit equal; only rank 0 writes its tensors.
"""
import os
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
    from seg2eye_tpu_torch.train.loop import train

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


TASKS = {"seg2eye": seg2eye, "segtrain": segtrain, "refinenet": refinenet}
TENSOR_KEYS = ("nets", "net", "momentum", "grads")


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
