"""The RefineNet/SegNet trainer (counterpart of
``seg2eye_tpu/refinenet/training.py``; reference: refinenet/core/
training.py).

  * ``make_optimizer``: ``torch.optim.SGD`` with Nesterov momentum and
    weight decay on every parameter (BN scale and bias too), the optax
    chain trace(nesterov) + add_decayed_weights + scale(-lr) of the JAX
    package.  Momentum 0.99 for RefineNet (train_refinenet.py:236), 0.9
    for SegNet (train_segnet.py:139).  The learning rate is set in the
    param groups from ``learning_rate_schedule`` at every step.
  * ``clip_by_global_norm_``: optax's clip, applied before the weight
    decay as in the chain: every gradient times max/norm when the global
    norm is not below max (``clip_grad_norm_`` scales by max/(norm+1e-6)
    and only above max).  A clip of 0 or below is off.
  * ``Trainer.train_step``: forward (BN running statistics update), the
    loss's backward, clip, SGD step; a float32 model runs all of it in full
    float32.  ``eval_step``: forward on the running statistics, no grad.
  * ``main_loop``: the step budget (``max_steps``, epochs restarted as
    needed), logging, periodic test and checkpoint, the final checkpoint
    and test; SIGTERM or Ctrl-C saves at step + 1 and skips the final test.
    A resumed run (``resume_from``) continues the unbroken one: the
    loader is set to the epoch and batch where it stopped, and each step's
    dropout generator is seeded from (seed + 1, step).
  * ``test_model_on_all``: the dataset-size-weighted mean of every scalar
    output (training.py:247-300).

The train state lives in the model (weights, running statistics) and the
optimizer, and steps change it in place.  ``resume_from`` also resumes a
JAX package's run from its ``%07d.ckpt`` (``checkpoint_manager``); the run
then writes the port's format beside them.  Training is single-device:
the JAX package's data-parallel mesh is not ported (ROADMAP,
"Multi-GPU").
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from seg2eye_tpu_torch.data.openeds import device_prefetch
from seg2eye_tpu_torch.refinenet.checkpoint_manager import CheckpointManager
from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
from seg2eye_tpu_torch.refinenet.loggers import GoogleSheetLogger, Tensorboard
from seg2eye_tpu_torch.utils.precision import full_float32
from seg2eye_tpu_torch.utils.signals import is_preemption, sigterm_raises

logger = logging.getLogger(__name__)

# the batch arrays the task models read
MODEL_KEYS = ("input", "target")


def learning_rate_schedule(cfg: RefineNetConfig, steps_per_epoch: int,
                           step: int) -> float:
    """training.py:462-496, as a pure function of the step."""
    target = cfg.learning_rate
    base = target / cfg.batch_size
    num_warmup = int(steps_per_epoch * cfg.num_warmup_epochs)
    if step < num_warmup:
        return base + (target - base) * step / float(num_warmup)
    epoch = (step - num_warmup) / float(steps_per_epoch)
    interval = int(epoch / cfg.lr_decay_epoch_interval)
    if cfg.lr_decay_strategy == "none":           # segnet.json uses this
        return target
    if cfg.lr_decay_strategy == "exponential":
        return target * (cfg.lr_decay_factor ** interval)
    if cfg.lr_decay_strategy == "cyclic":
        peak_a = target * (cfg.lr_decay_factor ** interval)
        peak_b = peak_a * cfg.lr_decay_factor
        half = 0.5 * cfg.lr_decay_epoch_interval
        start = interval * cfg.lr_decay_epoch_interval
        mid = start + half
        if epoch < mid:
            slope = -(peak_a - base) / half
        else:
            slope = (peak_b - base) / half
        return slope * (epoch - mid) + base
    raise ValueError(cfg.lr_decay_strategy)


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: RefineNetConfig,
                   momentum: float = 0.99) -> torch.optim.SGD:
    """SGD with Nesterov momentum and weight decay, at lr
    ``cfg.learning_rate`` until the schedule sets it."""
    return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=momentum,
                           nesterov=True, weight_decay=cfg.weight_decay)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: with norm the Euclidean norm of
    all of ``grads``, each becomes (g / norm) * max_norm unless
    norm < max_norm, when it is divided and multiplied by 1.
    Multi-tensor kernels, decided on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


@dataclasses.dataclass
class TrainState:
    """A task model (its DeepLab holds the weights and running
    statistics), its optimizer and the count of steps taken."""
    model: object
    optimizer: torch.optim.SGD
    step: int = 0


class Trainer:
    """The train and eval steps of a task model (RefineNet or SegNet)."""

    def __init__(self, model, cfg: RefineNetConfig, loss_key: str,
                 momentum: float = 0.99):
        self.model = model
        self.cfg = cfg
        self.loss_key = loss_key
        self.momentum = momentum
        # the state the eval helpers read; set by init_state
        self.current_state: Optional[TrainState] = None
        # the live state and step, for main_loop's interrupt path
        self.last_state: Optional[TrainState] = None
        self.last_step: Optional[int] = None

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Seeded weights (``generator``: a CPU generator) and a fresh
        optimizer."""
        self.model.init(generator)
        state = TrainState(self.model, make_optimizer(
            self.model.net.parameters(), self.cfg, self.momentum))
        self.current_state = state
        return state

    def train_step(self, state: TrainState, batch: Dict, lr: float,
                   generator: Optional[torch.Generator] = None):
        """One SGD step on a device batch, dropout drawn from
        ``generator`` (off without one).  -> (scalar outputs, outputs),
        detached."""
        model, opt = state.model, state.optimizer
        with full_float32(model.dtype == torch.float32):
            opt.zero_grad(set_to_none=True)
            out = model.forward(batch, train=True, generator=generator)
            out[self.loss_key].backward()
            params = [p for group in opt.param_groups
                      for p in group["params"] if p.grad is not None]
            if self.cfg.gradient_norm_clip > 0.0:
                clip_by_global_norm_([p.grad for p in params],
                                     self.cfg.gradient_norm_clip)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.step += 1
        out = {k: v.detach() for k, v in out.items()}
        return {k: v for k, v in out.items() if v.dim() == 0}, out

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict) -> Dict:
        return state.model.forward(batch, train=False)


def dropout_generator(cfg: RefineNetConfig, step: int,
                      device: torch.device) -> torch.Generator:
    """The dropout generator of a training step, seeded from
    (cfg.seed + 1, step) alone, so a resumed run draws what the unbroken
    one drew."""
    seed = int(np.random.SeedSequence((cfg.seed + 1, step)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def do_visualizations(out: Dict, tensorboard: Tensorboard, step: int,
                      max_images: int = 2, tag_prefix: str = "train") -> int:
    """Annotated prediction strips (refinenet/core/training.py:306-342):
    one horizontal strip per sample, every input channel, then the
    prediction and the groundtruth, over a per-image-score footer.
    -> the number of images logged."""
    pred = out.get("prediction")
    if pred is None:
        return 0
    from seg2eye_tpu_torch.utils.visualizer import _text_strip, _to_img01
    inp = _np32(out["input"])
    pred = _np32(pred)
    gt = out.get("groundtruth", out.get("target"))
    scores = out.get("per_image_score")
    tensorboard.update_current_step(step)
    logged = 0
    for i in range(min(max_images, inp.shape[0])):
        panels = [_to_img01(inp[i, ..., c]) for c in range(inp.shape[-1])]
        panels.append(_to_img01(pred[i]))
        if gt is not None:
            panels.append(_to_img01(_np32(gt)[i]))
        row = np.concatenate(panels, axis=1)
        txt = f"step {step}"
        if scores is not None:
            txt += f" score={float(_np32(scores)[i]):.4f}"
        strip = np.concatenate([row, _text_strip(txt, row.shape[1])], axis=0)
        tensorboard.add_image(f"{tag_prefix}/prediction_{i}", strip[None])
        logged += 1
    return logged


def test_model_on_all(trainer: Trainer, test_data: Dict, step: int,
                      tensorboard: Optional[Tensorboard] = None,
                      log_key_prefix: str = "test") -> Dict[str, Dict]:
    final: Dict[str, Dict] = {}
    state = trainer.current_state
    for tag, loader in test_data.items():
        n = len(loader.dataset)
        acc: Dict[str, float] = {}
        for batch, db in device_prefetch(loader, state.model.device,
                                         MODEL_KEYS):
            bs = len(batch["input"])
            out = trainer.eval_step(state, db)
            for k, v in out.items():
                if v.dim() == 0:
                    acc[k] = acc.get(k, 0.0) + float(v) * (bs / n)
        final[tag] = acc
        if tensorboard is not None:
            for k, v in acc.items():
                tensorboard.add_scalar(f"{log_key_prefix}/{tag}/{k}", v)
    return final


def main_loop(model, cfg: RefineNetConfig, train_loader, test_data: Dict,
              loss_key: str, step_callback: Optional[Callable] = None,
              model_name: Optional[str] = None,
              momentum: float = 0.99) -> Dict:
    """Train ``model`` (on its device) -> {'state', 'output_dir', 'steps',
    'final', 'trainer'}, and 'interrupted' after SIGTERM or Ctrl-C.

    ``train_loader`` yields host batches and has a ``dataset``; with
    ``set_epoch``/``skip_next_batches`` (the port's ``DataLoader``) a
    resumed run starts where the checkpoint left the data stream."""
    model_name = model_name or type(model).__name__
    if cfg.resume_from:
        identifier = cfg.resume_from.rstrip("/").split("/")[-1]
        output_dir = cfg.resume_from
    else:
        identifier = cfg.identifier(model_name)
        output_dir = os.path.join(cfg.output_dir_base, identifier)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        f.write(cfg.full_json())
    tensorboard = Tensorboard(output_dir)
    gsheet = GoogleSheetLogger(identifier, cfg.full_json(), output_dir)
    ckpt_mgr = CheckpointManager(output_dir, cfg.checkpoints_keep_n)

    trainer = Trainer(model, cfg, loss_key, momentum=momentum)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    steps_per_epoch = max(1, len(train_loader.dataset) // cfg.batch_size)
    start_step = 0
    if cfg.resume_from:
        step0, state = ckpt_mgr.load_last_checkpoint(
            state, lambda i: learning_rate_schedule(cfg, steps_per_epoch, i))
        if step0 is not None:
            start_step = step0
            logger.info("Resumed from step %d", start_step)

    num_steps = int(cfg.num_epochs * steps_per_epoch)
    if cfg.max_steps:
        num_steps = min(num_steps, start_step + cfg.max_steps)
    if start_step and hasattr(train_loader, "set_epoch") and len(train_loader):
        epoch, skip = divmod(start_step, len(train_loader))
        train_loader.set_epoch(epoch + 1)
        train_loader.skip_next_batches(skip)

    def host_batches():
        """exactly the step budget, restarting epochs as needed"""
        it = iter(train_loader)
        for _ in range(start_step, num_steps):
            try:
                yield next(it)
            except StopIteration:
                it = iter(train_loader)
                try:
                    yield next(it)
                except StopIteration:
                    raise RuntimeError(
                        f"train loader yields no batches: dataset has "
                        f"{len(train_loader.dataset)} samples, batch_size "
                        f"{cfg.batch_size} with drop_last — reduce "
                        f"batch_size") from None

    # the copy of the next batch to the device overlaps the running step
    prefetched = device_prefetch(host_batches(), model.device, MODEL_KEYS)
    step = start_step
    try:
        with sigterm_raises():
            step = _run_steps(trainer, cfg, state, prefetched, start_step,
                              num_steps, steps_per_epoch, train_loader,
                              test_data, step_callback, tensorboard, gsheet,
                              ckpt_mgr, time.time())
    except (KeyboardInterrupt, SystemExit) as e:
        # save the current step now and skip the final test
        state = trainer.last_state if trainer.last_state is not None else state
        step = trainer.last_step if trainer.last_step is not None else step
        name = "SIGTERM (preemption)" if is_preemption(e) \
            else type(e).__name__
        logger.warning("%s — saving checkpoint at step %d and stopping",
                       name, step + 1)
        ckpt_mgr.save_at_step(step + 1, state)
        tensorboard.close()
        return {"state": state, "output_dir": output_dir, "steps": step + 1,
                "final": {}, "trainer": trainer, "interrupted": True}

    ckpt_mgr.save_at_step(step + 1, state)
    final = test_model_on_all(trainer, test_data, step + 1, tensorboard,
                              log_key_prefix="final_test")
    gsheet.update_or_append_row(
        {"Step": step + 1,
         **{f"final/{t}/{k}": v for t, d in final.items()
            for k, v in d.items()}})
    tensorboard.close()
    return {"state": state, "output_dir": output_dir, "steps": step + 1,
            "final": final, "trainer": trainer}


def _run_steps(trainer, cfg, state, prefetched, start_step, num_steps,
               steps_per_epoch, train_loader, test_data, step_callback,
               tensorboard, gsheet, ckpt_mgr, t_last):
    """The step loop of main_loop; keeps the live state and step on the
    trainer (``last_state``/``last_step``) for the interrupt path."""
    step = start_step
    trainer.last_state, trainer.last_step = state, step
    device = state.model.device
    for step in range(start_step, num_steps):
        batch, db = next(prefetched)
        lr = learning_rate_schedule(cfg, steps_per_epoch, step)
        scalars, out = trainer.train_step(
            state, db, lr, dropout_generator(cfg, step, device))
        trainer.last_state, trainer.last_step = state, step

        if step_callback is not None:
            step_callback(step, scalars, out, batch)

        if step % cfg.log_every_n_steps == cfg.log_every_n_steps - 1:
            host = {k: float(v) for k, v in scalars.items()}
            dt = (time.time() - t_last) / cfg.log_every_n_steps
            t_last = time.time()
            epoch = step * cfg.batch_size / len(train_loader.dataset)
            logger.info("Step %d, Epoch %.2f> %s (%.3fs/step, lr %.2g)",
                        step + 1, epoch,
                        ", ".join(f"{k}: {v:.4g}"
                                  for k, v in sorted(host.items())),
                        dt, lr)
            tensorboard.update_current_step(step + 1)
            for k, v in host.items():
                tensorboard.add_scalar(f"train/{k}", v)
            tensorboard.add_scalar("lr/optim_0", lr)

        if cfg.tensorboard_images_every_n_steps and \
                step % cfg.tensorboard_images_every_n_steps == \
                cfg.tensorboard_images_every_n_steps - 1:
            do_visualizations(out, tensorboard, step + 1)

        if step % cfg.test_every_n_steps == cfg.test_every_n_steps - 1:
            results = test_model_on_all(trainer, test_data, step + 1,
                                        tensorboard)
            row = {"Step": step + 1}
            for tag, d in results.items():
                for k, v in d.items():
                    row[f"{tag}/{k}"] = v
            gsheet.update_or_append_row(row)
            ckpt_mgr.save_at_step(step + 1, state)

    return step


def split_device_flag(argv=None):
    """The CLIs' ``--device`` (default ``cuda``) -> (torch.device, the
    other arguments).  A card that is asked for and absent is an error:
    there is no switch to the CPU."""
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return device, rest
