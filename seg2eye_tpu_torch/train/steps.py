"""One training iteration (counterpart of ``seg2eye_tpu/train/steps.py``).

  * ``g_step``: the generator loss through E, G and D, backward, then the
    G+E Adam step.  D's parameters are frozen for it, so no gradient of the
    G step reaches the D update.
  * ``d_step``: the fake is regenerated under ``no_grad`` with the current
    (updated) G and E, then the hinge loss of D on it and the real target,
    backward, and the D Adam step.  With a ``fake`` given (``--reuse_fake``)
    there is no regeneration.
  * ``train_step``: ``g_step`` then ``d_step``, the reference's iteration.

Every forward in a step is a training forward: the spectral u/v and BN
running statistics of each net it runs advance.  A float32 model runs the
whole step, backward and update included, under ``full_float32``: cuDNN
reads the TF32 flags when each backward convolution runs.  Steps change
the state in place; the loss dicts and the fake come back detached.

Under data parallelism (``parallel.data_parallel``) the batch is this
rank's share of the global one; the batch statistics inside are global,
and each step averages its gradients over the data ranks before the
update, so every rank takes the same step.  Under tensor parallelism the
gradients of the model ranks' slices and of the whole parameters come
out of the backward complete (``parallel.tensor_parallel``), and after
each update the buffers of G, E and D are the first model rank's
(``broadcast_buffers``).  The loss dicts are this rank's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.utils.precision import full_float32
from seg2eye_tpu_torch.train.state import TrainState


def _params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


def _nets(model):
    return [model.netG, model.netE, model.netD]


def _detached(losses: Dict) -> Dict:
    return {k: v.detach() for k, v in losses.items()}


@contextlib.contextmanager
def _frozen(net: torch.nn.Module):
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _g_update(state: TrainState, batch: Dict) -> Tuple[Dict, torch.Tensor]:
    model = state.model
    state.opt_g.zero_grad(set_to_none=True)
    with _frozen(model.netD):
        total, losses, fake = model.generator_loss(batch)
        total.backward()
    dp.all_reduce_grads(_params(state.opt_g))
    state.opt_g.step()
    dp.broadcast_buffers(_nets(model))
    return _detached(losses), fake.detach()


def _d_update(state: TrainState, batch: Dict,
              fake: Optional[torch.Tensor] = None) -> Dict:
    model = state.model
    if fake is None:
        with torch.no_grad():
            seg, style, _ = model.preprocess(batch)
            w, _ = model.encode_w(style, update_stats=True)
            fake = model.generate(seg, w, update_stats=True)
    state.opt_d.zero_grad(set_to_none=True)
    total, losses = model.discriminator_loss(batch, fake)
    total.backward()
    dp.all_reduce_grads(_params(state.opt_d))
    state.opt_d.step()
    dp.broadcast_buffers(_nets(model))
    return _detached(losses)


def g_step(state: TrainState, batch: Dict) -> Tuple[Dict, torch.Tensor]:
    with full_float32(state.model.dtype == torch.float32):
        losses, fake = _g_update(state, batch)
    state.step += 1
    return losses, fake


def d_step(state: TrainState, batch: Dict) -> Dict:
    with full_float32(state.model.dtype == torch.float32):
        return _d_update(state, batch)


def train_step(state: TrainState, batch: Dict) -> Tuple[Dict, torch.Tensor]:
    """G then D; the D step regenerates the fake with the updated G unless
    ``opt.reuse_fake``."""
    with full_float32(state.model.dtype == torch.float32):
        g_losses, fake = _g_update(state, batch)
        reuse = fake if state.model.opt.reuse_fake else None
        d_losses = _d_update(state, batch, fake=reuse)
    state.step += 1
    return {**g_losses, **d_losses}, fake
