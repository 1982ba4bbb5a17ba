"""Train state: the model and its two TTUR Adam optimizers (counterpart of
``seg2eye_tpu/train/state.py``).

  * TTUR (default): Adam betas (0, 0.9), G at lr/2, D at lr*2.  no_TTUR:
    betas (beta1, beta2) and lr for both.
  * ``weight_decay`` is ``torch.optim.Adam``'s own, coupled L2: wd * param
    is added to the gradient before the moments.
  * The G optimizer covers netG then netE.  netE's ``fc_var`` feeds no
    loss, so its ``.grad`` stays None and Adam skips it (no step, no weight
    decay), as in the reference.  The steps clear gradients with
    ``zero_grad(set_to_none=True)``: a zero-filled grad would be stepped.
  * The learning rate is set per epoch on the host, with the reference's
    schedule (``epoch_lr``).
  * Adam keeps PyTorch's default implementation (foreach on CUDA), never
    the fused one: a fused step changes the weights in place without
    moving their ``_version``, on which the kernel's packed copies of G's
    norm-site weights are keyed (``ops.spade_style.packed_weights``).
  * Under tensor parallelism the optimizers hold each model rank's slices
    (``parallel.tensor_parallel.shard_`` narrows the parameters in place
    after ``create_state``), so the moments of a sharded weight are its
    rows only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from seg2eye_tpu_torch.models.pix2pix import Pix2Pix


@dataclass
class TrainState:
    model: Pix2Pix
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0


def ttur_lrs(opt, base_lr: float):
    if opt.no_TTUR:
        return base_lr, base_lr
    return base_lr / 2.0, base_lr * 2.0


def ttur_betas(opt):
    if opt.no_TTUR:
        return opt.beta1, opt.beta2
    return 0.0, 0.9


def create_state(model: Pix2Pix) -> TrainState:
    opt = model.opt
    if model.netD is None:
        raise ValueError("training needs the discriminator: build the "
                         "networks with opt.isTrain")
    betas = ttur_betas(opt)
    g_lr, d_lr = ttur_lrs(opt, opt.lr)
    ge = list(model.netG.parameters()) + list(model.netE.parameters())
    return TrainState(
        model=model,
        opt_g=torch.optim.Adam(ge, lr=g_lr, betas=betas,
                               weight_decay=opt.weight_decay),
        opt_d=torch.optim.Adam(model.netD.parameters(), lr=d_lr, betas=betas,
                               weight_decay=opt.weight_decay))


def epoch_lr(opt, epoch: int) -> float:
    """Base LR of a (1-indexed) epoch: constant up to epoch niter + 1 (the
    reference decrements at the END of each epoch past niter), then
    lr/niter_decay less per epoch."""
    steps = max(0, epoch - opt.niter - 1)
    if steps == 0 or opt.niter_decay == 0:
        return opt.lr
    return opt.lr - steps * (opt.lr / opt.niter_decay)


def set_learning_rate(state: TrainState, opt, epoch: int) -> None:
    g_lr, d_lr = ttur_lrs(opt, epoch_lr(opt, epoch))
    for optimizer, lr in ((state.opt_g, g_lr), (state.opt_d, d_lr)):
        for group in optimizer.param_groups:
            group["lr"] = lr
