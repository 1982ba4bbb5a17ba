"""The generic DeepLabV3+ trainer over VOC/SBD/COCO/Cityscapes on one card
(counterpart of ``seg2eye_tpu/segtrain/trainer.py``; reference:
refinenet/deeplab/train.py).

  * ``SegTrainer`` wires the Saver, the Tensorboard summary, the loaders,
    the port's ``DeepLab`` (seeded ``kaiming_init_``), SGD with the
    backbone at lr and ASPP + decoder at 10 lr, the optional
    class-balanced CE or focal loss, the Evaluator, the LR scheduler and
    resume / ``--ft``.
  * ``make_optimizer`` is the JAX package's optax chain
    add_decayed_weights -> trace(nesterov) -> masked x10 -> x(-lr) as
    ``torch.optim.SGD`` with two param groups: weight decay on every
    parameter, BN scale and bias included; the momentum buffer is the
    trace.  The LR is set in the groups from ``LRScheduler`` at every
    step.
  * ``train_step``: forward in train mode (BN running statistics
    updated), the loss, backward, the SGD step; a float32 model runs all
    of it in full float32 (``utils.precision``), ``--precision bfloat16``
    casts the input to bfloat16 and keeps the weights, the BN statistics
    and the loss in float32.  ``--freeze-bn`` runs BN on its running
    statistics, which stay untouched, with dropout still on.  Dropout
    draws from a generator seeded from (seed + 1, global step), as the
    RefineNet trainer's; it cannot draw the JAX package's masks.
  * ``eval_step``: forward on the running statistics, the loss, argmax
    and the confusion matrix on the device; ``validation`` pulls each
    batch's loss and matrix to the host in one copy.
  * ``training(epoch)`` logs the loss of every step, dumps images 10
    times an epoch and checkpoints with --no-val; ``validation(epoch)``
    computes the four metrics and promotes a best mIoU.
  * ``--resume`` also takes the JAX package's checkpoint.ckpt /
    model_best.ckpt (``_load_jax_checkpoint``); the run writes the
    port's format.
  * ``build_argparser``/``finalize_args``/``main``: the reference's CLI
    and its per-dataset defaults, counted for one device.

``SegTrainer(args, loaders=(train, val, test, nclass))`` takes loaders in
place of ``make_data_loader(args)``.  The trainer runs on the card unless
``--no-cuda``, and refuses to start without one.  One card: the JAX
package's data-parallel mesh and process-sharded loaders are not ported.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from seg2eye_tpu_torch.data.openeds import DataLoader, device_prefetch, \
    to_device
from seg2eye_tpu_torch.models.deeplab import RESNET_LAYERS, DeepLab, \
    kaiming_init_
from seg2eye_tpu_torch.refinenet.training import dropout_generator
from seg2eye_tpu_torch.segtrain.datasets import db_root_dir, make_data_loader
from seg2eye_tpu_torch.segtrain.losses import SegmentationLosses
from seg2eye_tpu_torch.segtrain.lr_scheduler import LRScheduler
from seg2eye_tpu_torch.segtrain.metrics import Evaluator, confusion_matrix
from seg2eye_tpu_torch.segtrain.saver import Saver
from seg2eye_tpu_torch.segtrain.summaries import TensorboardSummary
from seg2eye_tpu_torch.segtrain.weights import calculate_weights_labels
from seg2eye_tpu_torch.utils import flax_msgpack, optim_state, weights
from seg2eye_tpu_torch.utils.precision import full_float32

BATCH_KEYS = ("image", "label")
HEAD_LR_SCALE = 10.0


def make_optimizer(net: DeepLab, args) -> torch.optim.SGD:
    """torch.optim.SGD(momentum, weight_decay, nesterov) with the backbone
    at lr and ASPP + decoder at 10 lr (train.py:39-44)."""
    head = list(net.aspp.parameters()) + list(net.decoder.parameters())
    return torch.optim.SGD(
        [{"params": list(net.backbone.parameters()), "lr": args.lr},
         {"params": head, "lr": HEAD_LR_SCALE * args.lr}],
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        nesterov=args.nesterov)


def set_lr(optimizer: torch.optim.SGD, lr: float) -> None:
    """The backbone group at ``lr``, the head group at 10 ``lr``."""
    backbone, head = optimizer.param_groups
    backbone["lr"], head["lr"] = lr, HEAD_LR_SCALE * lr


def jax_payload(net: DeepLab, optimizer: torch.optim.SGD, args, epoch: int,
                best_pred: float, count: int) -> dict:
    """The JAX package's checkpoint payload {"epoch", "best_pred",
    "params", "batch_stats", "opt"} (``seg2eye_tpu/segtrain/trainer.py``);
    ``count`` is the optimizer's, which no member of its chain reads."""
    return {"epoch": int(epoch), "best_pred": float(best_pred),
            **weights.deeplab_to_jax_variables(net, args.backbone),
            "opt": optim_state.segtrain_sgd_to_jax(optimizer, net, args,
                                                   count)}


def load_jax_payload(net: DeepLab, optimizer: Optional[torch.optim.SGD],
                     args, ckpt: dict, where: str,
                     lr: Optional[float] = None) -> None:
    """A JAX package's checkpoint payload, its structure checked against
    ``net``'s: the weights strictly and, with ``optimizer``, the momentum;
    with ``lr``, its learning rate must be that."""
    fresh = optimizer or make_optimizer(net, args)
    flax_msgpack.check_like(ckpt, jax_payload(net, fresh, args, 0, 0.0, 0),
                            where)
    net.load_state_dict(weights.deeplab_from_jax_variables(
        ckpt, args.backbone), strict=True)
    if optimizer is not None:
        if lr is not None:
            optim_state.check_lr(ckpt["opt"], lr, where)
        optim_state.sgd_from_jax(optimizer, net, args.backbone, ckpt["opt"])


class SegTrainer:
    def __init__(self, args, loaders=None):
        self.args = args
        self.device = torch.device("cpu" if args.no_cuda else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass --no-cuda "
                               "to train on the CPU)")
        self.saver = Saver(args)
        self.saver.save_experiment_config()
        self.summary = TensorboardSummary(self.saver.experiment_dir)
        self.writer = self.summary.create_summary()

        (self.train_loader, self.val_loader, self.test_loader,
         self.nclass) = loaders or make_data_loader(args, seed=args.seed)

        net = DeepLab(args.backbone, args.out_stride, self.nclass,
                      tuple(getattr(args, "resnet_layers",
                                    RESNET_LAYERS[101])))
        kaiming_init_(net, torch.Generator().manual_seed(args.seed))
        self.net = net.to(self.device)
        self.dtype = (torch.bfloat16 if getattr(args, "precision", "float32")
                      == "bfloat16" else torch.float32)

        # class-balanced weights (train.py:46-57), over the whole train set
        weight = None
        if args.use_balanced_weights:
            root = db_root_dir(args.dataset, getattr(args, "data_root", None))
            path = os.path.join(root, args.dataset + "_classes_weights.npy")
            if os.path.isfile(path):
                weight = np.load(path)
            else:
                full = DataLoader(self.train_loader.dataset,
                                  batch_size=args.batch_size)
                weight = calculate_weights_labels(root, args.dataset, full,
                                                  self.nclass)
            weight = torch.as_tensor(weight, dtype=torch.float32,
                                     device=self.device)
        self.criterion = SegmentationLosses(
            weight=weight).build_loss(mode=args.loss_type)

        self.evaluator = Evaluator(self.nclass)
        self.scheduler = LRScheduler(args.lr_scheduler, args.lr,
                                     args.epochs, len(self.train_loader))
        self.optimizer = make_optimizer(self.net, args)

        # resuming a checkpoint (train.py:72-91), the port's or the JAX
        # package's
        self.best_pred = 0.0
        if args.resume is not None:
            ckpt = Saver.load_checkpoint(args.resume)
            args.start_epoch = int(ckpt["epoch"])
            if "params" in ckpt:
                self._load_jax_checkpoint(ckpt, args.resume)
            else:
                self.net.load_state_dict(ckpt["state_dict"])
                if not args.ft:
                    self.optimizer.load_state_dict(ckpt["optimizer"])
            self.best_pred = float(ckpt["best_pred"])
            print(f"=> loaded checkpoint '{args.resume}' "
                  f"(epoch {ckpt['epoch']})")
        if args.ft:
            args.start_epoch = 0

    # ------------------------------------------------------------------ #
    def _input(self, image: torch.Tensor) -> torch.Tensor:
        """(B,H,W,3) -> (B,3,H,W) in the compute dtype (channels_last
        memory)."""
        return image.permute(0, 3, 1, 2).to(self.dtype)

    def train_step(self, image: torch.Tensor, target: torch.Tensor,
                   lr: float, generator: Optional[torch.Generator] = None):
        """One SGD step on a device batch (image (B,H,W,3), target (B,H,W)),
        dropout drawn from ``generator`` (off without one).  -> (loss,
        logits (B,C,H,W)), detached."""
        set_lr(self.optimizer, lr)
        with full_float32(self.dtype == torch.float32):
            self.optimizer.zero_grad(set_to_none=True)
            logits = self.net(self._input(image),
                              not self.args.freeze_bn, generator)
            loss = self.criterion(logits, target)
            loss.backward()
            self.optimizer.step()
        return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_step(self, image: torch.Tensor, target: torch.Tensor):
        """-> (loss, (nclass, nclass) int64 confusion matrix), on the
        device."""
        with full_float32(self.dtype == torch.float32):
            logits = self.net(self._input(image), False)
            loss = self.criterion(logits, target)
            pred = torch.argmax(logits, dim=1)
        return loss, confusion_matrix(target, pred, self.nclass)

    def checkpoint_state(self, epoch: int, fmt: str = "torch") -> dict:
        """What checkpoint.ckpt holds after ``epoch``: the reference's
        keys, the weights as CPU tensors; with ``fmt="flax"`` the JAX
        package's payload, its optimizer count that of full epochs."""
        if fmt == "flax":
            return jax_payload(self.net, self.optimizer, self.args, epoch + 1,
                               self.best_pred,
                               (epoch + 1) * len(self.train_loader))
        return {"epoch": epoch + 1, "best_pred": self.best_pred,
                "state_dict": {k: v.detach().cpu()
                               for k, v in self.net.state_dict().items()},
                "optimizer": self.optimizer.state_dict()}

    def _load_jax_checkpoint(self, ckpt: dict, where: str) -> None:
        """Unless --ft, the checkpoint's learning rate must be the
        scheduler's at the last step of its epoch."""
        epoch = int(ckpt["epoch"])
        lr = None
        if not self.args.ft and epoch > 0:
            lr = self.scheduler(len(self.train_loader) - 1, epoch - 1)
        load_jax_payload(self.net, None if self.args.ft else self.optimizer,
                         self.args, ckpt, where, lr)

    # ------------------------------------------------------------------ #
    def training(self, epoch: int, step_hook=None) -> float:
        """``step_hook(step_in_epoch, loss_float)``: the reference's
        per-iteration postfix and scalar (train.py:108-110), for tests."""
        train_loss = 0.0
        num_img_tr = len(self.train_loader)
        if num_img_tr == 0:
            raise RuntimeError(
                f"train loader yields no batches: "
                f"{len(self.train_loader.dataset)} samples < batch_size "
                f"{self.args.batch_size} with drop_last — reduce "
                f"--batch-size")
        i, sample = 0, None
        # the copy of the next batch to the card overlaps the running step
        prefetched = device_prefetch(iter(self.train_loader), self.device,
                                     BATCH_KEYS)
        for i, (sample, batch) in enumerate(prefetched):
            step = i + num_img_tr * epoch
            lr = self.scheduler(i, epoch)
            loss, logits = self.train_step(
                batch["image"], batch["label"], lr,
                dropout_generator(self.args, step, self.device))
            loss = float(loss)
            train_loss += loss
            if step_hook is not None:
                step_hook(i, loss)
            self.writer.update_current_step(step)
            self.writer.add_scalar("train/total_loss_iter", loss)

            # 10 x 3 inference results each epoch (train.py:112-115)
            if i % max(1, num_img_tr // 10) == 0:
                self.summary.visualize_image(
                    self.writer, self.args.dataset, sample["image"],
                    sample["label"], logits, step)

        self.writer.update_current_step(epoch)
        self.writer.add_scalar("train/total_loss_epoch", train_loss)
        print("[Epoch: %d, numImages: %5d]"
              % (epoch, i * self.args.batch_size + len(sample["image"])))
        print("Loss: %.3f" % train_loss)

        if self.args.no_val:
            self.saver.save_checkpoint(self.checkpoint_state(epoch),
                                       is_best=False)
        return train_loss

    def validation(self, epoch: int) -> float:
        self.evaluator.reset()
        if len(self.val_loader) == 0:
            raise RuntimeError("val loader yields no batches")
        test_loss = 0.0
        i, sample = 0, None
        n2 = self.nclass * self.nclass
        for i, sample in enumerate(self.val_loader):
            batch = to_device(sample, self.device, BATCH_KEYS)
            loss, conf = self.eval_step(batch["image"], batch["label"])
            # one copy to the host: the counts (exact in float64) and loss
            host = torch.cat([conf.reshape(-1).double(),
                              loss.double().reshape(1)]).cpu().numpy()
            test_loss += float(host[n2])
            self.evaluator.add_matrix(host[:n2].reshape(self.nclass,
                                                        self.nclass))

        acc = self.evaluator.pixel_accuracy()
        acc_class = self.evaluator.pixel_accuracy_class()
        miou = self.evaluator.mean_intersection_over_union()
        fwiou = self.evaluator.frequency_weighted_intersection_over_union()
        self.writer.update_current_step(epoch)
        self.writer.add_scalar("val/total_loss_epoch", test_loss)
        self.writer.add_scalar("val/mIoU", miou)
        self.writer.add_scalar("val/Acc", acc)
        self.writer.add_scalar("val/Acc_class", acc_class)
        self.writer.add_scalar("val/fwIoU", fwiou)
        print("Validation:")
        print("[Epoch: %d, numImages: %5d]"
              % (epoch, i * self.args.batch_size + len(sample["image"])))
        print(f"Acc:{acc}, Acc_class:{acc_class}, mIoU:{miou}, "
              f"fwIoU: {fwiou}")
        print("Loss: %.3f" % test_loss)

        if miou > self.best_pred:
            self.best_pred = miou
            self.saver.save_checkpoint(self.checkpoint_state(epoch),
                                       is_best=True)
        return miou


# --------------------------------------------------------------------- #
EPOCHS = {"coco": 30, "cityscapes": 200, "pascal": 50}
LRS = {"coco": 0.1, "cityscapes": 0.01, "pascal": 0.007}
DEVICES = 1          # the port trains on one card


def build_argparser() -> argparse.ArgumentParser:
    """The reference CLI (train.py:179-248), with the JAX package's
    --data-root and --precision."""
    p = argparse.ArgumentParser(description="PyTorch DeeplabV3Plus Training")
    p.add_argument("--backbone", type=str, default="resnet",
                   choices=["resnet", "xception", "drn", "mobilenet"])
    p.add_argument("--out-stride", type=int, default=16)
    p.add_argument("--dataset", type=str, default="pascal",
                   choices=["pascal", "coco", "cityscapes"])
    p.add_argument("--use-sbd", action="store_true", default=True)
    p.add_argument("--workers", type=int, default=4, metavar="N")
    p.add_argument("--base-size", type=int, default=513)
    p.add_argument("--crop-size", type=int, default=513)
    p.add_argument("--sync-bn", type=bool, default=None,
                   help="accepted and ignored: the port trains on one card")
    p.add_argument("--freeze-bn", type=bool, default=False)
    p.add_argument("--loss-type", type=str, default="ce",
                   choices=["ce", "focal"])
    p.add_argument("--epochs", type=int, default=None, metavar="N")
    p.add_argument("--start_epoch", type=int, default=0, metavar="N")
    p.add_argument("--batch-size", type=int, default=None, metavar="N")
    p.add_argument("--test-batch-size", type=int, default=None, metavar="N")
    p.add_argument("--use-balanced-weights", action="store_true",
                   default=False)
    p.add_argument("--lr", type=float, default=None, metavar="LR")
    p.add_argument("--lr-scheduler", type=str, default="poly",
                   choices=["poly", "step", "cos"])
    p.add_argument("--momentum", type=float, default=0.9, metavar="M")
    p.add_argument("--weight-decay", type=float, default=5e-4, metavar="M")
    p.add_argument("--nesterov", action="store_true", default=False)
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="train on the CPU; otherwise on the card, and "
                        "without one the trainer refuses to start")
    p.add_argument("--gpu-ids", type=str, default="0",
                   help="accepted and ignored: the port trains on one card")
    p.add_argument("--seed", type=int, default=1, metavar="S")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--checkname", type=str, default=None)
    p.add_argument("--ft", action="store_true", default=False)
    p.add_argument("--eval-interval", type=int, default=1)
    p.add_argument("--no-val", action="store_true", default=False)
    p.add_argument("--data-root", type=str, default=None,
                   help="dataset root (replaces the reference's hardcoded "
                        "mypath.py paths); default $SEG2EYE_DATA_ROOT or "
                        "./datasets")
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the DeepLab convs (weights, BN "
                        "statistics and the loss stay float32).  Default "
                        "float32, the reference's semantics")
    return p


def finalize_args(args) -> argparse.Namespace:
    """The per-dataset defaults (train.py:250-290), for one device."""
    if args.sync_bn is None:
        args.sync_bn = DEVICES > 1
    if args.epochs is None:
        args.epochs = EPOCHS[args.dataset.lower()]
    if args.batch_size is None:
        args.batch_size = 4 * DEVICES
    if args.test_batch_size is None:
        args.test_batch_size = args.batch_size
    if args.lr is None:
        args.lr = LRS[args.dataset.lower()] / (4 * DEVICES) * args.batch_size
    if args.checkname is None:
        args.checkname = "deeplab-" + str(args.backbone)
    return args


def main(argv: Optional[list] = None) -> SegTrainer:
    args = finalize_args(build_argparser().parse_args(argv))
    print(args)
    trainer = SegTrainer(args)
    print("Starting Epoch:", trainer.args.start_epoch)
    print("Total Epoches:", trainer.args.epochs)
    for epoch in range(trainer.args.start_epoch, trainer.args.epochs):
        trainer.training(epoch)
        if not trainer.args.no_val and \
                epoch % args.eval_interval == (args.eval_interval - 1):
            trainer.validation(epoch)
    trainer.writer.close()
    return trainer
