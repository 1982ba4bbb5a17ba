"""Plain reference of DeepLabV3+ with the Aligned Xception-65 backbone at
output stride 16, trained on PASCAL VOC by the generic trainer (Chen et
al., arXiv:1802.02611; mcbuehler/Seg2Eye ``refinenet/deeplab/train.py``
and ``modeling/backbone/xception.py``, the jfzhang95 trainer): its
forward, the cross-entropy loss with label 255 ignored, and the SGD step
with the ASPP and decoder at 10 times the backbone's learning rate.

Functional over a state dict under the port's keys (the reference's torch
names).  NCHW float32, products after ``common.Products`` (the depthwise
convs too, ``_GroupedConv``); batch norms as ``deeplab.DeepLab._bn``.
The ASPP, the decoder, the upsample and the dropout masks are
``deeplab.DeepLab.forward``'s, whose backbone this module replaces.

The backbone as the reference's code has it:

  * stem: 3x3/2 conv to 32, BN, ReLU; 3x3 conv to 64, BN, ReLU;
  * a block is units of (ReLU, separable conv, BN) and a skip (the input,
    or a 1x1 conv at the block's stride and a BN where channels or stride
    change), added; blocks 1 and 2 start without the ReLU; a unit at
    stride 2 ends a strided block, and a unit at stride 1 ends the last
    entry block and the exit block (``is_last``);
  * entry blocks 1-3 (128, 256, 728, stride 2 each), 16 middle blocks at
    728, the exit block 728 -> 1024 (``grow_first`` off: the widening
    unit last), then three separable convs to 1536, 1536, 2048 at
    dilation 2, each followed by a BN and a ReLU;
  * the low-level feature is the ReLU of block 1's output (128 channels);
  * a separable conv is a depthwise 3x3 on the input padded by its
    dilation on every side (TF's fixed 'same' padding), a BN, and a 1x1
    pointwise conv: no ReLU between them, where the paper puts one.

Weights as the reference's init draws them: every conv kaiming-normal
with fan_out (a depthwise kernel's fan is its channels x 9) in the
backbone, fan_in in ASPP and decoder; BN scale 1 and bias 0, or
``residual_bn_scale`` on the last BN of each block's units where the
configuration gives one.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import deeplab
from portbench.reference.common import ROUNDING, Products, Spec
from portbench.reference.deeplab import _bn, _conv, trained_keys

IGNORE = 255
MIDDLE = 16
# the three separable convs after the exit block: (cin, cout), dilation
EXIT = [(1024, 1536), (1536, 1536), (1536, 2048)]
EXIT_DILATION = 2


def blocks() -> List[Tuple[int, int, List[Tuple[int, int, int, int]], bool]]:
    """(cin, cout, units of (cin, cout, stride, dilation), starts with a
    ReLU) of entry blocks 1-3, the middle blocks and the exit block, at
    output stride 16."""
    entry = [(64, 128, False), (128, 256, False), (256, 728, True)]
    out = []
    for cin, cout, relu_first in entry:
        units = [(cin, cout, 1, 1), (cout, cout, 1, 1), (cout, cout, 2, 1)]
        out.append((cin, cout, units, relu_first))
    for _ in range(MIDDLE):
        out.append((728, 728, [(728, 728, 1, 1)] * 3, True))
    out.append((728, 1024, [(728, 728, 1, 1), (728, 1024, 1, 1),
                            (1024, 1024, 1, 1)], True))
    return out


def skip_stride(cin: int, cout: int, units) -> int:
    """The stride of a block's 1x1 skip conv, or 0 where the skip is the
    block's input (same channels, stride 1)."""
    stride = max(u[2] for u in units)
    return stride if cout != cin or stride != 1 else 0


# ----------------------------------------------------------------- specs
def _sep(name, cin, cout) -> List[Spec]:
    return (_conv(name + ".conv1", cin, 1, 3, "fan_out")
            + _bn(name + ".bn", cin)
            + _conv(name + ".pointwise", cout, cin, 1, "fan_out"))


def _head(num_classes: int, low: int) -> List[Spec]:
    out = []
    for k in range(1, 5):
        out += (_conv(f"aspp.aspp{k}.atrous_conv", 256, 2048,
                      1 if k == 1 else 3, "fan_in")
                + _bn(f"aspp.aspp{k}.bn", 256))
    return out + (_conv("aspp.global_avg_pool.1", 256, 2048, 1, "fan_in")
                  + _bn("aspp.global_avg_pool.2", 256)
                  + _conv("aspp.conv1", 256, 1280, 1, "fan_in")
                  + _bn("aspp.bn1", 256)
                  + _conv("decoder.conv1", 48, low, 1, "fan_in")
                  + _bn("decoder.bn1", 48)
                  + _conv("decoder.last_conv.0", 256, 304, 3, "fan_in")
                  + _bn("decoder.last_conv.1", 256)
                  + _conv("decoder.last_conv.4", 256, 256, 3, "fan_in")
                  + _bn("decoder.last_conv.5", 256)
                  + _conv("decoder.last_conv.8", num_classes, 256, 1,
                          "fan_in", bias=True))


def specs(cfg: Dict) -> List[Spec]:
    if cfg["backbone"] != "xception" or cfg["output_stride"] != 16:
        raise ValueError("the reference implements Xception-65 at os16")
    residual_scale = cfg.get("residual_bn_scale", 1.0)
    out = (_conv("backbone.conv1", 32, 3, 3, "fan_out")
           + _bn("backbone.bn1", 32)
           + _conv("backbone.conv2", 64, 32, 3, "fan_out")
           + _bn("backbone.bn2", 64))
    for i, (cin, cout, units, relu_first) in enumerate(blocks(), start=1):
        p = f"backbone.block{i}."
        if skip_stride(cin, cout, units):
            out += (_conv(p + "skip", cout, cin, 1, "fan_out")
                    + _bn(p + "skipbn", cout))
        for u, (a, b, _, _) in enumerate(units):
            at = 3 * u + int(relu_first)
            last = u == len(units) - 1
            out += (_sep(f"{p}rep.{at}", a, b)
                    + _bn(f"{p}rep.{at + 1}", b,
                          residual_scale if last else 1.0))
    for i, (cin, cout) in enumerate(EXIT, start=3):
        out += _sep(f"backbone.conv{i}", cin, cout) + _bn(f"backbone.bn{i}",
                                                          cout)
    return out + _head(cfg["num_classes"], 128)


# ----------------------------------------------------------------- forward
class _GroupedConv(torch.autograd.Function):
    """``common._Conv`` with groups: a depthwise conv of rounded operands,
    its backward products of the rounded gradient."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, precision):
        fwd, _ = ROUNDING[precision]
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, dilation, groups, precision)
        return F.conv2d(xq, wq, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, groups, precision = ctx.conf
        gq = ROUNDING[precision][1](g)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding,
                                            dilation, groups)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride,
                                             padding, dilation, groups)
        return gx, gw, None, None, None, None, None


class XceptionDeepLab(deeplab.DeepLab):
    def _depthwise(self, x, w, stride, dilation):
        if self.p.precision == "f32":
            return F.conv2d(x, w, None, stride, dilation, dilation, w.shape[0])
        return _GroupedConv.apply(x, w, stride, dilation, dilation,
                                  w.shape[0], self.p.precision)

    def _separable(self, name, x, mode, stride=1, dilation=1):
        x = self._depthwise(x, self.sd[name + ".conv1.weight"], stride,
                            dilation)
        x = self._bn(name + ".bn", x, mode)
        return self.p.conv(x, self.sd[name + ".pointwise.weight"])

    def backbone(self, x, mode) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._cbr("backbone.conv1", "backbone.bn1", x, mode, stride=2)
        x = self._cbr("backbone.conv2", "backbone.bn2", x, mode)
        low = None
        for i, (cin, cout, units, relu_first) in enumerate(blocks(), start=1):
            p = f"backbone.block{i}."
            inp = x
            for u, (_, _, s, d) in enumerate(units):
                if u or relu_first:
                    x = torch.relu(x)
                at = 3 * u + int(relu_first)
                x = self._bn(f"{p}rep.{at + 1}",
                             self._separable(f"{p}rep.{at}", x, mode, s, d),
                             mode)
            stride = skip_stride(cin, cout, units)
            skip = inp if not stride else self._cbr(
                p + "skip", p + "skipbn", inp, mode, stride=stride, relu=False)
            x = x + skip
            if i == 1:
                x = torch.relu(x)
                low = x
        x = torch.relu(x)
        for i in range(3, 3 + len(EXIT)):
            x = torch.relu(self._bn(f"backbone.bn{i}", self._separable(
                f"backbone.conv{i}", x, mode, dilation=EXIT_DILATION), mode))
        return x, low


# ----------------------------------------------------------------- training
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 (B,H,W,3) -> float32 (B,H,W,3): /255, - ImageNet mean, / its
    std, as the VOC loader's Normalize."""
    mean = torch.tensor(MEAN, device=image.device)
    std = torch.tensor(STD, device=image.device)
    return (image.to(torch.float32) / 255.0 - mean) / std


def ce_loss(net: XceptionDeepLab, batch: Dict, mode: str, device,
            generator=None) -> torch.Tensor:
    """The reference's CE of a uint8 batch, image (B,H,W,3) and label
    (B,H,W) with 255 ignored: the mean NLL over the valid pixels, divided
    again by the batch (``batch_average``)."""
    x = normalize(torch.as_tensor(batch["image"]).to(device))
    logits = net.forward(x.permute(0, 3, 1, 2), mode, generator)
    target = torch.as_tensor(batch["label"]).to(device).long()
    loss = F.cross_entropy(logits, target, ignore_index=IGNORE)
    return loss / logits.shape[0]


class SGD:
    """torch.optim.SGD without Nesterov or dampening, coupled weight
    decay, one learning rate per key."""

    def __init__(self, lrs: Dict[str, float], momentum, weight_decay):
        self.lrs, self.mu, self.wd = lrs, momentum, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict) -> None:
        for n, lr in self.lrs.items():
            if grads.get(n) is None:
                continue
            d = grads[n] + self.wd * params[n]
            buf = self.buf[n] = (d.clone() if n not in self.buf
                                 else self.mu * self.buf[n] + d)
            params[n] -= lr * buf


class Trainer:
    """The backbone at ``lr``, ASPP and decoder at ``head_lr_scale`` lr."""

    def __init__(self, cfg: Dict, sd: Dict, prod: Products = Products()):
        self.cfg, self.net = cfg, XceptionDeepLab(cfg, sd, prod)
        self.keys = trained_keys(sd)
        head = ("aspp.", "decoder.")
        self.opt = SGD({k: cfg["lr"] * (cfg["head_lr_scale"]
                                        if k.startswith(head) else 1.0)
                        for k in self.keys}, cfg["momentum"],
                       cfg["weight_decay"])

    def step(self, batch: Dict, device, generator) -> Tuple:
        """-> (loss, gradients)."""
        sd = self.net.sd
        for k in self.keys:
            sd[k].requires_grad_(True)
        loss = ce_loss(self.net, batch, "train", device, generator)
        grads = torch.autograd.grad(loss, [sd[k] for k in self.keys],
                                    allow_unused=True)
        for k in self.keys:
            sd[k].requires_grad_(False)
        grads = dict(zip(self.keys, grads))
        self.opt.step(sd, grads)
        return loss.detach(), {k: g for k, g in grads.items()
                               if g is not None}
