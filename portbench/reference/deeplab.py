"""Plain reference of the OpenEDS RefineNet: DeepLabV3+ with a ResNet
backbone at output stride 16 (mcbuehler/Seg2Eye ``refinenet/model.py``,
``refinenet/configs/refinenet.json``), its residual head and loss, and
its training step (SGD with Nesterov momentum 0.99 and coupled weight
decay, the gradient clipped to a global norm).

Functional over a state dict under the port's keys (which are the
reference's torch names).  NCHW float32, products after
``common.Products``; batch norms are ``F.batch_norm`` with momentum 0.1,
eps 1e-5; dropout draws its masks from the generator it is given, one
``bernoulli_`` per site in the order ASPP, decoder 0.5, decoder 0.1, at
the activation's shape, as a generator handed to both sides requires.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import Products, Spec

LAYERS = {101: (3, 4, 23, 3), 50: (3, 4, 6, 3), 26: (2, 2, 2, 2),
          14: (1, 1, 1, 1)}


# ----------------------------------------------------------------- specs
def _conv(name, cout, cin, k, fan_mode, bias=False) -> List[Spec]:
    fan = (cin if fan_mode == "fan_in" else cout) * k * k
    out = [Spec(name + ".weight", (cout, cin, k, k), "normal",
                math.sqrt(2.0 / fan))]
    return out + ([Spec(name + ".bias", (cout,), "zeros")] if bias else [])


def _bn(name, c, scale: float = 1.0) -> List[Spec]:
    return [Spec(name + ".weight", (c,), "const", value=scale),
            Spec(name + ".bias", (c,), "zeros"),
            Spec(name + ".running_mean", (c,), "zeros"),
            Spec(name + ".running_var", (c,), "ones"),
            Spec(name + ".num_batches_tracked", (), "count")]


def _stages(cfg: Dict):
    """(planes, blocks, stride, dilation) per ResNet stage at the output
    stride; layer4 is the multi-grid unit, dilation base x (1, 2, 4)."""
    if cfg["output_stride"] != 16:
        raise ValueError("the reference implements output stride 16")
    layers = LAYERS[cfg["resnet_depth"]]
    return [(64, layers[0], 1, (1,) * layers[0]),
            (128, layers[1], 2, (1,) * layers[1]),
            (256, layers[2], 2, (1,) * layers[2]),
            (512, 3, 1, (2, 4, 8))]


def specs(cfg: Dict) -> List[Spec]:
    if cfg["backbone"] != "resnet":
        raise ValueError("the reference implements the ResNet backbone")
    # the scale of the last BN of each residual branch (1 in the reference's
    # init; a configuration may give a trained-like smaller one)
    residual_scale = cfg.get("residual_bn_scale", 1.0)
    out = (_conv("backbone.conv1", 64, 3, 7, "fan_out")
           + _bn("backbone.bn1", 64))
    cin = 64
    for i, (planes, blocks, _, _) in enumerate(_stages(cfg)):
        for b in range(blocks):
            p = f"backbone.layer{i + 1}.{b}."
            out += (_conv(p + "conv1", planes, cin, 1, "fan_out")
                    + _bn(p + "bn1", planes)
                    + _conv(p + "conv2", planes, planes, 3, "fan_out")
                    + _bn(p + "bn2", planes)
                    + _conv(p + "conv3", 4 * planes, planes, 1, "fan_out")
                    + _bn(p + "bn3", 4 * planes, residual_scale))
            if b == 0:
                out += (_conv(p + "downsample.0", 4 * planes, cin, 1,
                              "fan_out") + _bn(p + "downsample.1", 4 * planes))
            cin = 4 * planes
    for k in range(1, 5):
        out += (_conv(f"aspp.aspp{k}.atrous_conv", 256, 2048,
                      1 if k == 1 else 3, "fan_in")
                + _bn(f"aspp.aspp{k}.bn", 256))
    out += (_conv("aspp.global_avg_pool.1", 256, 2048, 1, "fan_in")
            + _bn("aspp.global_avg_pool.2", 256)
            + _conv("aspp.conv1", 256, 1280, 1, "fan_in")
            + _bn("aspp.bn1", 256)
            + _conv("decoder.conv1", 48, 256, 1, "fan_in")
            + _bn("decoder.bn1", 48)
            + _conv("decoder.last_conv.0", 256, 304, 3, "fan_in")
            + _bn("decoder.last_conv.1", 256)
            + _conv("decoder.last_conv.4", 256, 256, 3, "fan_in")
            + _bn("decoder.last_conv.5", 256)
            + _conv("decoder.last_conv.8", cfg["num_classes"], 256, 1,
                    "fan_in", bias=True))
    return out


# ----------------------------------------------------------------- forward
class DeepLab:
    """``mode``: 'eval' (running statistics), 'train' (batch statistics,
    running ones updated) or 'calibrate' (batch statistics written as the
    running ones: momentum 1)."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 prod: Products = Products()):
        self.cfg, self.sd, self.p = cfg, sd, prod

    def _bn(self, name, x, mode):
        sd = self.sd
        if mode != "eval":
            sd[name + ".num_batches_tracked"] += 1
        return F.batch_norm(x, sd[name + ".running_mean"],
                            sd[name + ".running_var"], sd[name + ".weight"],
                            sd[name + ".bias"], mode != "eval",
                            1.0 if mode == "calibrate" else 0.1, 1e-5)

    def _cbr(self, conv, bn, x, mode, stride=1, dilation=1, relu=True):
        w = self.sd[conv + ".weight"]
        pad = (w.shape[-1] - 1) // 2 * dilation
        y = self._bn(bn, self.p.conv(x, w, None, stride, pad, dilation), mode)
        return torch.relu(y) if relu else y

    def backbone(self, x, mode) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._cbr("backbone.conv1", "backbone.bn1", x, mode, stride=2)
        x = F.max_pool2d(x, 3, 2, padding=1)
        low = None
        for i, (_, blocks, stride, grid) in enumerate(_stages(self.cfg)):
            for b in range(blocks):
                p = f"backbone.layer{i + 1}.{b}."
                s = stride if b == 0 else 1
                out = self._cbr(p + "conv1", p + "bn1", x, mode)
                out = self._cbr(p + "conv2", p + "bn2", out, mode, s, grid[b])
                out = self._cbr(p + "conv3", p + "bn3", out, mode, relu=False)
                res = (self._cbr(p + "downsample.0", p + "downsample.1", x,
                                 mode, s, relu=False) if b == 0 else x)
                x = torch.relu(out + res)
            if i == 0:
                low = x
        return x, low

    def forward(self, x: torch.Tensor, mode: str,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B,3,H,W) in [-1,1] -> logits (B,num_classes,H,W)."""
        feat, low = self.backbone(x, mode)
        branches = [self._cbr(f"aspp.aspp{k}.atrous_conv", f"aspp.aspp{k}.bn",
                              feat, mode, dilation=d)
                    for k, d in ((1, 1), (2, 6), (3, 12), (4, 18))]
        gp = feat.mean(dim=(2, 3), keepdim=True)
        gp = self._cbr("aspp.global_avg_pool.1", "aspp.global_avg_pool.2", gp,
                       mode)
        branches.append(gp.expand_as(branches[-1]))
        out = self._cbr("aspp.conv1", "aspp.bn1", torch.cat(branches, 1), mode)
        out = _dropout(out, 0.5, generator)
        ll = self._cbr("decoder.conv1", "decoder.bn1", low, mode)
        out = F.interpolate(out, size=ll.shape[2:], mode="bilinear",
                            align_corners=True)
        out = torch.cat([out, ll], 1)
        out = _dropout(self._cbr("decoder.last_conv.0", "decoder.last_conv.1",
                                 out, mode), 0.5, generator)
        out = _dropout(self._cbr("decoder.last_conv.4", "decoder.last_conv.5",
                                 out, mode), 0.1, generator)
        out = self.p.conv(out, self.sd["decoder.last_conv.8.weight"],
                          self.sd["decoder.last_conv.8.bias"])
        return F.interpolate(out, size=x.shape[2:], mode="bilinear",
                             align_corners=True)


def _dropout(x, p, generator):
    if generator is None:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


# ----------------------------------------------------------------- RefineNet
def refine(net: DeepLab, batch: Dict, mode: str, device,
           generator: Optional[torch.Generator] = None) -> Dict:
    """The RefineNet outputs of a uint8 batch: input (B,H,W,3) = (target
    mask, neighbour image, neighbour mask) and target (B,H,W,1), both
    mapped to [-1,1] as x * 2/255 - 1.  prediction = clamp(residual +
    neighbour image, -1, 1); eds_loss = mean over images of
    sqrt(sum((255/2 (pred - true))^2)) / (H*W)."""
    x = torch.as_tensor(batch["input"]).to(device).to(torch.float32) \
        * (2.0 / 255.0) - 1.0
    residual = net.forward(x.permute(0, 3, 1, 2), mode, generator)
    residual = residual.permute(0, 2, 3, 1)
    pred = torch.clamp(residual + x[..., 1:2], -1.0, 1.0)
    out = {"residual": residual, "prediction": pred}
    if "target" in batch:
        y = torch.as_tensor(batch["target"]).to(device).to(torch.float32) \
            * (2.0 / 255.0) - 1.0
        h, w = y.shape[1:3]
        sq = (255.0 / 2.0 * (pred - y)) ** 2
        per_image = torch.sqrt(sq.reshape(sq.shape[0], -1).sum(-1)) / (h * w)
        out["eds_loss"] = per_image.mean()
    return out


def trained_keys(sd: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in sd if k.endswith((".weight", ".bias"))]


class SGD:
    """torch.optim.SGD with Nesterov momentum and coupled weight decay,
    after the gradients are clipped to ``clip`` in global norm (optax's
    rule: scaled by clip / norm unless norm < clip)."""

    def __init__(self, names, lr, momentum, weight_decay, clip):
        self.names, self.lr, self.mu = names, lr, momentum
        self.wd, self.clip = weight_decay, clip
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict) -> Dict[str, torch.Tensor]:
        """-> the clipped gradients, as the optimizer got them."""
        names = [n for n in self.names if grads.get(n) is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(grads[n]) for n in names]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        clipped = {n: grads[n] * scale for n in names}
        for n in names:
            d = clipped[n] + self.wd * params[n]
            buf = self.buf[n] = (d.clone() if n not in self.buf
                                 else self.mu * self.buf[n] + d)
            params[n] -= self.lr * (d + self.mu * buf)
        return clipped


class Trainer:
    def __init__(self, cfg: Dict, sd: Dict, prod: Products = Products()):
        self.cfg, self.net = cfg, DeepLab(cfg, sd, prod)
        self.opt = SGD(trained_keys(sd), cfg["batch_size"]
                       * cfg["base_learning_rate"], cfg["momentum"],
                       cfg["weight_decay"], cfg["gradient_norm_clip"])

    def step(self, batch: Dict, device, generator) -> Tuple:
        """-> (eds_loss, clipped gradients)."""
        sd = self.net.sd
        keys = self.opt.names
        for k in keys:
            sd[k].requires_grad_(True)
        out = refine(self.net, batch, "train", device, generator)
        grads = torch.autograd.grad(out["eds_loss"], [sd[k] for k in keys],
                                    allow_unused=True)
        for k in keys:
            sd[k].requires_grad_(False)
        clipped = self.opt.step(sd, dict(zip(keys, grads)))
        return out["eds_loss"].detach(), clipped
