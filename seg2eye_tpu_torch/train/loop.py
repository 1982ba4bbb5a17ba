"""The training loop (counterpart of ``seg2eye_tpu/train/loop.py``, the
reference's train.py).

Per epoch: the learning rate of that epoch, the loader pinned to it (its
shuffle and flips are keyed on the epoch), then one iteration per batch:
the fused G-then-D ``train_step``, or with ``D_steps_per_G`` > 1 a G step
every D_steps_per_G-th iteration and a D step on every one.  Then, on the
reference's cadence: the losses to stdout and ``loss_log.txt``, a partial
('rand') validation of the train and validation splits, the ``latest``
checkpoint with ``iter.txt``, and full validation; at the end of an epoch,
``latest`` and ``{epoch}`` checkpoints.  A resumed run (``continue_train``)
loads networks, optimizers and step, and skips the batches its epoch had
already trained, so it continues the unbroken run bit for bit; resumed
from the JAX package's ``.ckpt`` files, it goes on writing that format.  Ctrl-C and
SIGTERM end in the same final save as a normal finish.

Batches move to the device one step ahead (``data.openeds.
device_prefetch``).  ``dataloader`` replaces the H5 loader with any
iterable of batches with ``set_epoch``/``skip_next_batches`` and a length;
the validation loaders are still built from ``opt.dataroot``, when a
validation comes due.  The run starts with a ``src.zip`` snapshot of the
checkout's ``.py`` files in ``expr_dir``.  ``--profile_steps N`` traces
iterations 3 to N + 2 with ``torch.profiler`` into
``expr_dir/profile/trace.json`` (a chrome trace): operators, kernels and
copies, and the program's phase spans (``utils.spans``: the G and D steps,
each one's forward, backward and optimizer, batch copies to the device,
K1's weight packings, the norm sites' backward), which exist only while a
profiler records.  ``--tf_log`` sends the
losses, validation statistics and panels to TensorBoard, and
``--write_error_log`` writes the full validation's error-log H5.  The VGG
loss (``--no_vgg_loss False``) loads torchvision VGG19 weights from
``--vgg_weights`` and refuses to train without them.

Data and tensor parallelism (``torchrun --nproc_per_node N``,
``parallel``): the N processes form a grid of data x model ranks
(``--model_axis`` M, default 1; ``--data_axis`` 0 or N / M).
``--batchSize`` is the global batch; each data index loads its share and
takes the same synchronised steps.  At M > 1 the wide convs are sharded
over the model ranks (``parallel.tensor_parallel``): every rank builds
(or resumes) the whole state and then keeps its slice.  Only rank 0
writes (``src.zip``, ``iter.txt``, the loss log, TensorBoard, the
profile) and runs the Testers, alone, on whole networks (gathered from
the slices at M > 1); checkpoints gather the slices on every rank and
rank 0 writes the files of a one-process run.  Printed losses are the
means over the data ranks.  ``--spatial_shard`` bands the scoring of
``python -m seg2eye_tpu_torch.test`` (``parallel.spatial``); the
training Testers run on rank 0 alone with or without it, with the same
numbers.  Per-sample encoding runs on a grid as on the data axis alone
(``models.pix2pix.Pix2Pix._encode_samples_replayed``): the model ranks of
one data index encode the same samples, their sharded spectral convs
power-iterating together.
"""
from __future__ import annotations

import contextlib
import os
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from seg2eye_tpu_torch.data.openeds import create_dataloader, device_prefetch
from seg2eye_tpu_torch.eval.tester import Tester
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.parallel import mesh
from seg2eye_tpu_torch.parallel import tensor_parallel as tp
from seg2eye_tpu_torch.train import state as state_lib
from seg2eye_tpu_torch.train import steps
from seg2eye_tpu_torch.utils import checkpoint
from seg2eye_tpu_torch.utils.files import copy_src, project_root
from seg2eye_tpu_torch.utils.iter_counter import IterationCounter
from seg2eye_tpu_torch.utils.signals import is_preemption, sigterm_raises
from seg2eye_tpu_torch.utils.visualizer import Visualizer
from seg2eye_tpu_torch.utils.weights import init_networks


def _check_ported(opt, device: torch.device) -> None:
    """Refuses what ``make_mesh`` refuses (``mesh.grid_shape``) and a
    global batch that the data degree does not divide."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on 'cuda': no CUDA device is available")
    world = dp.world_size() * mesh.current().model
    data, _ = mesh.grid_shape(opt.model_axis, opt.data_axis, world)
    dp.check_batch(opt.batchSize, data)


def _scoring_model(model: Pix2Pix) -> Pix2Pix:
    """The model the Testers score: ``model`` itself, or under tensor
    parallelism a copy with whole networks, gathered on every rank (a
    collective over each model group) and used by rank 0."""
    if not any(tp.is_sharded(p) for p in model.netG.parameters()):
        return model
    nets = checkpoint.whole_networks({"G": model.netG, "E": model.netE},
                                     model.opt, model.device)
    return Pix2Pix(model.opt, nets, model.device)


def _testers(opt, visualizer: Visualizer):
    """Train and validation Testers on the H5 file's splits."""
    out = []
    for key in ("train", "validation"):
        topt = opt.replace(serial_batches=True, no_flip=True, isTrain=False,
                           dataset_key=key)
        out.append(Tester(opt, key, create_dataloader(topt, key),
                          visualizer=visualizer))
    return out


class _ProfileWindow:
    """``--profile_steps``: ``torch.profiler`` from the end of iteration 2
    to the end of iteration 2 + N, as the JAX loop's trace window; the
    chrome trace, with the program's spans (``utils.spans``), goes to
    ``expr_dir/profile/trace.json``."""

    def __init__(self, opt, device: torch.device):
        self.n = opt.profile_steps
        self.path = os.path.join(opt.expr_dir, "profile", "trace.json")
        self.device = device
        self.prof = None

    def after_iteration(self, n_iters: int) -> None:
        if not self.n:
            return
        if n_iters == 2:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.prof is not None and n_iters >= 2 + self.n:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print("profile written to", self.path)


def _host_losses(losses: Dict) -> Dict[str, float]:
    """Each loss's mean over the ranks, as floats."""
    return {k: float(v) for k, v in dp.mean_over_ranks(losses).items()}


def train(opt, max_steps: Optional[int] = None, step_hook=None,
          dataloader=None, device="cuda") -> Dict:
    """-> {"losses": the last iteration's losses as floats (means over
    the ranks), "steps": the iterations run, "state": the TrainState}.

    ``step_hook(step, losses)`` fires after every iteration with its
    1-based index and the loss dict (tensors on the device)."""
    device = torch.device(device)
    _check_ported(opt, device)
    if dist.is_initialized():
        mesh.make_grid(opt.model_axis, opt.data_axis)
    primary = dp.is_primary()
    if primary:
        copy_src(project_root(), opt.expr_dir)
    visualizer = Visualizer(opt) if primary else None
    if dataloader is None:
        dataloader = create_dataloader(opt)
    nets = init_networks(opt, torch.Generator().manual_seed(opt.seed), device)
    if "VGG" in nets:
        checkpoint.load_vgg(nets["VGG"], opt)
    state = state_lib.create_state(Pix2Pix(opt, nets, device))
    model = state.model
    iter_counter = IterationCounter(opt, len(dataloader) * opt.batchSize,
                                    write_records=primary)
    resume_skip = 0
    # a run resumed from the JAX package's files goes on writing them
    fmt = "torch"
    if opt.continue_train and checkpoint.has_checkpoint(opt, opt.which_epoch):
        fmt = checkpoint.checkpoint_format(opt, opt.which_epoch)
        checkpoint.load_state(state, opt, opt.which_epoch)
        print(f"Resumed networks from '{opt.which_epoch}' checkpoint")
        resume_skip = iter_counter.epoch_iter // opt.batchSize
    tp.shard_(nets, (state.opt_g, state.opt_d), opt.tp_min_channels)
    dp.check_replicated(dp.module_tensors(nets), "the initial state:")
    testers = None

    max_steps = max_steps or (opt.max_steps or None)
    last_losses: Dict = {}
    g_losses: Dict = {}
    n_iters = 0
    stop = False
    profile = _ProfileWindow(opt if primary else opt.replace(
        profile_steps=0), device)
    exit_stack = contextlib.ExitStack()
    exit_stack.enter_context(sigterm_raises())
    try:
        for epoch in iter_counter.training_epochs():
            if iter_counter.current_epoch != epoch:
                iter_counter.record_epoch_start(epoch)
            state_lib.set_learning_rate(state, opt, epoch)
            dataloader.set_epoch(epoch)
            if resume_skip and epoch == iter_counter.first_epoch:
                dataloader.skip_next_batches(resume_skip)

            for i, (_, batch) in enumerate(device_prefetch(dataloader, device),
                                           start=iter_counter.epoch_iter):
                iter_counter.record_one_iteration()
                if opt.D_steps_per_G == 1:
                    losses, _ = steps.train_step(state, batch)
                else:
                    if i % opt.D_steps_per_G == 0:
                        g_losses, _ = steps.g_step(state, batch)
                    # D-only iterations report the latest G losses
                    losses = {**g_losses, **steps.d_step(state, batch)}
                last_losses = losses
                n_iters += 1
                if step_hook is not None:
                    step_hook(n_iters, losses)
                profile.after_iteration(n_iters)

                if iter_counter.needs_printing():
                    host_losses = _host_losses(losses)
                    if primary:
                        visualizer.print_current_errors(
                            epoch, iter_counter.total_steps_so_far,
                            host_losses, iter_counter.time_per_iter)
                        visualizer.plot_current_errors(
                            host_losses, iter_counter.total_steps_so_far)
                if iter_counter.needs_displaying():
                    scoring = _scoring_model(model)
                if iter_counter.needs_displaying() and primary:
                    testers = testers or _testers(opt, visualizer)
                    with dp.local():
                        for tester in testers:
                            tester.run_partial_modes(
                                scoring, epoch=epoch,
                                n_steps=iter_counter.total_steps_so_far,
                                limit=min(opt.validation_limit, tester.N),
                                log=True, visualize_images=opt.tf_log)
                if iter_counter.needs_saving():
                    if primary:
                        print("saving the latest model (epoch %d, "
                              "total_steps %d)" % (
                                  epoch, iter_counter.total_steps_so_far))
                    checkpoint.save_state(state, opt, "latest", fmt)
                    if primary:
                        iter_counter.record_current_iter()
                if iter_counter.needs_full_validation():
                    scoring = _scoring_model(model)
                if iter_counter.needs_full_validation() and primary:
                    testers = testers or _testers(opt, visualizer)
                    with dp.local():
                        for tester in testers:
                            tester.run(scoring, mode="full", epoch=epoch,
                                       n_steps=iter_counter.total_steps_so_far,
                                       write_error_log=opt.write_error_log,
                                       log=True)
                if max_steps and n_iters >= max_steps:
                    stop = True
                    break

            iter_counter.record_epoch_end()
            if (epoch % opt.save_epoch_freq == 0
                    or epoch == iter_counter.total_epochs):
                if primary:
                    print("saving the model at the end of epoch %d, iters %d"
                          % (epoch, iter_counter.total_steps_so_far))
                checkpoint.save_state(state, opt, "latest", fmt)
                checkpoint.save_state(state, opt, epoch, fmt)
            if stop:
                break
        print("Training was successfully finished.")
    except (KeyboardInterrupt, SystemExit) as e:
        name = ("SIGTERM (preemption)" if is_preemption(e)
                else "KeyboardInterrupt")
        print(f"{name}. Shutting down.")
    except Exception:
        print(traceback.format_exc())
        raise
    finally:
        exit_stack.close()
        profile.stop()
        if primary:
            visualizer.close()
            print("saving the model before quitting")
        checkpoint.save_state(state, opt, "latest", fmt)
        if primary:
            iter_counter.record_current_iter()
    return {"losses": _host_losses(last_losses), "steps": n_iters,
            "state": state}
