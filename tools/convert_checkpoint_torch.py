#!/usr/bin/env python3
"""Convert a checkpoint between the port's format (``torch.save``) and the
JAX package's (flax msgpack), either way, for the three systems; no JAX
needed.  The checkpoint is loaded into the port's own objects (networks
and optimizers on the CPU) by the same code that resumes from it, and
written by the same code that saves one, so a conversion checks it as a
load does.

    # Seg2Eye: {epoch}_net_{G,D,E} and {epoch}_optim, .pth <-> .ckpt; the
    # run's opt.pkl (and opt.txt, iter.txt) are copied along
    python tools/convert_checkpoint_torch.py seg2eye --expr_dir CKPTS/EXP \
        [--which_epoch latest] --out_dir OUT [--to flax|torch]

    # RefineNet/SegNet: the newest %07d.ckpt of a run (config.json beside)
    python tools/convert_checkpoint_torch.py refinenet --run_dir RUN \
        [--model refinenet|segnet] --out_dir OUT [--to flax|torch]

    # segtrain: checkpoint.ckpt or model_best.ckpt; the backbone is read
    # off the weights' names
    python tools/convert_checkpoint_torch.py segtrain --checkpoint FILE \
        --out FILE [--to flax|torch] \
        [--momentum M --weight-decay W --nesterov|--no-nesterov]

``--to`` defaults to the other format.  The output goes to a new place:
the two formats of one checkpoint side by side make the Seg2Eye loader
refuse to choose.  A JAX segtrain checkpoint does not hold the run's SGD
momentum, Nesterov flag or weight decay, and the port's resume takes them
from a torch file, so converting one needs all three given; a torch
file holds them, and a value given beside it must agree.
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch                                               # noqa: E402

from seg2eye_tpu_torch.utils import flax_msgpack           # noqa: E402


def _other(fmt: str) -> str:
    return "torch" if fmt == "flax" else "flax"


def convert_seg2eye(expr_dir, which_epoch, out_dir, to=None) -> str:
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.train.state import create_state
    from seg2eye_tpu_torch.utils import checkpoint

    expr_dir = os.path.abspath(expr_dir)
    if os.path.abspath(out_dir) == expr_dir:
        raise SystemExit("--out_dir must not be the run's own directory")
    opt = Options.load(expr_dir).replace(
        checkpoints_dir=os.path.dirname(expr_dir),
        name=os.path.basename(expr_dir), isTrain=True, no_vgg_loss=True)
    state = create_state(Pix2Pix(opt, build_networks(opt), "cpu"))
    src = checkpoint.checkpoint_format(opt, which_epoch)
    if src is None:
        raise SystemExit(f"no {which_epoch}_net_G checkpoint in {expr_dir}")
    optim = any(os.path.exists(checkpoint.optim_path(opt, which_epoch, ext))
                for ext in (checkpoint.TORCH, checkpoint.JAX))
    if optim:
        checkpoint.load_state(state, opt, which_epoch)
    else:
        checkpoint.load_networks({"G": state.model.netG,
                                  "D": state.model.netD,
                                  "E": state.model.netE}, opt, which_epoch)
    out = opt.replace(checkpoints_dir=os.path.dirname(
        os.path.abspath(out_dir)), name=os.path.basename(
        os.path.abspath(out_dir)))
    to = to or _other(src)
    checkpoint.save_state(state, out, which_epoch, to, optim=optim)
    for name in ("opt.pkl", "opt.txt", "iter.txt"):
        if os.path.exists(os.path.join(expr_dir, name)):
            shutil.copy(os.path.join(expr_dir, name), out.expr_dir)
    return to


def convert_refinenet(run_dir, out_dir, model="refinenet", to=None) -> str:
    from seg2eye_tpu_torch.refinenet import model as models
    from seg2eye_tpu_torch.refinenet.checkpoint_manager import \
        CheckpointManager
    from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
    from seg2eye_tpu_torch.refinenet.training import Trainer

    cfg = RefineNetConfig.from_json(os.path.join(run_dir, "config.json"))
    cls, key, momentum = {"refinenet": (models.RefineNetModel, "eds_loss",
                                        0.99),
                          "segnet": (models.SegNetModel, "ce_loss", 0.9)}[
        model]
    trainer = Trainer(cls(cfg, "cpu"), cfg, key, momentum)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    source = CheckpointManager(run_dir)
    step, state = source.load_last_checkpoint(state)
    if step is None:
        raise SystemExit(f"no %07d.ckpt under {run_dir}/checkpoints")
    newest = os.path.join(run_dir, "checkpoints", "%07d.ckpt" % step)
    src = "flax" if flax_msgpack.is_flax_msgpack(newest) else "torch"
    to = to or _other(src)
    os.makedirs(out_dir, exist_ok=True)
    CheckpointManager(out_dir).save_at_step(step, state, fmt=to)
    shutil.copy(os.path.join(run_dir, "config.json"), out_dir)
    return to


# the first backbone whose marker key is among the checkpoint's
BACKBONE_KEYS = {"flax": (("drn", "layer0_conv"), ("mobilenet", "block0_0"),
                          ("xception", "block1"), ("resnet", "layer1_0")),
                 "torch": (("drn", "backbone.layer0."),
                           ("mobilenet", "backbone.features."),
                           ("xception", "backbone.block1."),
                           ("resnet", "backbone.layer1."))}
HYPER = ("momentum", "weight_decay", "nesterov")


def backbone_of(keys, src: str) -> str:
    """The DeepLab backbone whose weights these are: ``keys`` are a JAX
    ``params["backbone"]``'s names or a torch state_dict's."""
    for backbone, marker in BACKBONE_KEYS[src]:
        if any(k == marker or (src == "torch" and k.startswith(marker))
               for k in keys):
            return backbone
    raise SystemExit("no DeepLab backbone has these weights")


def convert_segtrain(path, out, to=None, **hyper) -> str:
    """``hyper``: momentum, weight_decay, nesterov, each None where not
    given; all three are needed for a JAX checkpoint, and must agree with
    a torch file's."""
    from seg2eye_tpu_torch.models.deeplab import DeepLab
    from seg2eye_tpu_torch.segtrain.saver import Saver
    from seg2eye_tpu_torch.segtrain.trainer import (jax_payload,
                                                    load_jax_payload,
                                                    make_optimizer)

    ckpt = Saver.load_checkpoint(path)
    src = "flax" if "params" in ckpt else "torch"
    if src == "flax":
        nclass = ckpt["params"]["decoder"]["classifier"]["kernel"].shape[-1]
        blocks = ckpt["params"]["backbone"]
        prefix = "layer{}_"
        missing = ["--" + k.replace("_", "-") for k in HYPER
                   if hyper.get(k) is None]
        if missing:
            raise SystemExit(
                f"{path} is a JAX checkpoint, which does not hold the run's "
                f"SGD settings: give {', '.join(missing)} as the run trained "
                "with (--no-nesterov for plain momentum)")
    else:
        sd = ckpt["state_dict"]
        nclass = sd["decoder.last_conv.8.weight"].shape[0]
        blocks = sd
        prefix = "backbone.layer{}."
        group = ckpt["optimizer"]["param_groups"][0]
        for k in HYPER:
            if hyper.get(k) is not None and hyper[k] != group[k]:
                raise SystemExit(f"{path} was trained with {k} {group[k]!r}, "
                                 f"not {hyper[k]!r}")
            hyper[k] = group[k]
    backbone = backbone_of(blocks, src)
    layers = tuple(len({k[len(prefix.format(i)):].split(".")[0].split("_")[0]
                        for k in blocks if k.startswith(prefix.format(i))})
                   for i in (1, 2, 3, 4))
    args = argparse.Namespace(backbone=backbone, lr=0.0,
                              **{k: hyper[k] for k in HYPER})
    # the output stride sets dilations only, no weight
    net = DeepLab(backbone, 16, nclass,
                  layers if backbone == "resnet" else (3, 4, 23, 3))
    optimizer = make_optimizer(net, args)
    if src == "flax":
        load_jax_payload(net, optimizer, args, ckpt, path)
        count = int(ckpt["opt"]["count"])
    else:
        net.load_state_dict(ckpt["state_dict"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer"])
        count = int(ckpt["epoch"])
    to = to or _other(src)
    if to == "flax":
        flax_msgpack.write(out, jax_payload(net, optimizer, args,
                                            ckpt["epoch"], ckpt["best_pred"],
                                            count))
    else:
        torch.save({"epoch": int(ckpt["epoch"]),
                    "best_pred": float(ckpt["best_pred"]),
                    "state_dict": net.state_dict(),
                    "optimizer": optimizer.state_dict()}, out)
    return to


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="system", required=True)
    s = sub.add_parser("seg2eye")
    s.add_argument("--expr_dir", required=True)
    s.add_argument("--which_epoch", default="latest")
    s.add_argument("--out_dir", required=True)
    r = sub.add_parser("refinenet")
    r.add_argument("--run_dir", required=True)
    r.add_argument("--model", choices=("refinenet", "segnet"),
                   default="refinenet")
    r.add_argument("--out_dir", required=True)
    g = sub.add_parser("segtrain")
    g.add_argument("--checkpoint", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--momentum", type=float, default=None)
    g.add_argument("--weight-decay", type=float, default=None)
    g.add_argument("--nesterov", action=argparse.BooleanOptionalAction,
                   default=None)
    for q in (s, r, g):
        q.add_argument("--to", choices=("flax", "torch"), default=None)
    a = p.parse_args(argv)
    if a.system == "seg2eye":
        to = convert_seg2eye(a.expr_dir, a.which_epoch, a.out_dir, a.to)
    elif a.system == "refinenet":
        to = convert_refinenet(a.run_dir, a.out_dir, a.model, a.to)
    else:
        to = convert_segtrain(a.checkpoint, a.out, a.to,
                              momentum=a.momentum,
                              weight_decay=a.weight_decay,
                              nesterov=a.nesterov)
    print(f"converted {a.system} checkpoint to the {to} format")
    return 0


if __name__ == "__main__":
    sys.exit(main())
