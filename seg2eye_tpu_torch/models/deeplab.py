"""DeepLabV3+ (backbone -> ASPP -> decoder), the counterpart of
``seg2eye_tpu/models/deeplab.py``.

Module and parameter names are the reference's torch names, the keys that
``utils.weights.export_deeplab`` writes (``backbone.layer1.0.conv1.weight``,
``aspp.aspp1.atrous_conv.weight``, ``aspp.global_avg_pool.1.weight``,
``decoder.last_conv.8.bias``, ...), so a state_dict of the reference or of
the JAX package loads with ``strict=True``.  Slots of the reference's
``nn.Sequential``s that hold no parameters (ReLU, dropout, pooling) are
``nn.Identity`` placeholders that keep the indices; every forward is
written out, as the JAX package's.

  * ResNet (depths 101/50/26/14) with output-stride dilation: os16 gives
    strides [1,2,2,1] and dilations [1,1,1,2], os8 [1,2,1,1] and
    [1,1,2,4]; layer4 is always the 3-block multi-grid unit, dilations
    base x [1,2,4].  A 7x7/2 stem, then a 3x3/2 max-pool padded with -inf.
    The low-level feature is layer1's output.
  * MobileNetV2 with the reference's ``fixed_padding`` quirk: the block
    input is padded before the 1x1 expand conv and its BN, and the
    depthwise conv has no padding.  Dilation is fixed per stage with a
    pre-multiplied rate; the low-level feature is stage 1's (24 channels).
    ``low_level_features``/``high_level_features`` alias ``features[:4]``
    and ``features[4:]``, as the reference's do, so its state_dict carries
    those keys too (the parameters are shared, counted once).
  * ASPP: rates 6/12/18 (os16) or 12/24/36 (os8), a global pool (a mean in
    at least float32, then a ConvBN, then a broadcast), a 1x1 projection,
    dropout 0.5.  The JAX package takes that mean in float32 also in a
    float64 run.
  * Decoder: the low-level feature to 48 channels, the ASPP output
    upsampled to it (align_corners), 304 channels -> two 3x3 256 ConvBNs
    (dropout 0.5 and 0.1) -> a 1x1 classifier with bias; then an
    align_corners upsample to the input size.

Activations are NCHW (``channels_last`` memory at the entry); convolutions
run in the input's dtype with float32 parameters cast at the call, batch
norms as ``layers.BatchNorm``, each one that a ReLU follows (after the
residual add in a bottleneck) through ``layers.bn_relu``.  ``train``
selects batch statistics (and updates the running ones); dropout runs only
when a ``generator`` is given, drawn from it.  Xception and DRN-D-54 are
in ``backbones_extra`` (DRN forces output stride 8, for the ASPP rates
too).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.models.backbones_extra import (DRNBackbone,
                                                      XceptionBackbone)
from seg2eye_tpu_torch.models.layers import (BatchNorm, Bottleneck, apply_conv,
                                             at_least_f32, bn_relu, make_conv)
from seg2eye_tpu_torch.ops.image import resize_bilinear_ac
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.utils.spans import (DEEPLAB_ASPP, DEEPLAB_BACKBONE,
                                           DEEPLAB_DECODER, span)

RESNET_LAYERS = {101: (3, 4, 23, 3), 50: (3, 4, 6, 3), 26: (2, 2, 2, 2),
                 14: (1, 1, 1, 1)}
# MobileNetV2's stages: expansion t, channels c, blocks n, stride s
MOBILENET_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _cat(tensors) -> torch.Tensor:
    """Channel concat, kept in channels_last memory."""
    return torch.cat(tensors, dim=1).contiguous(
        memory_format=torch.channels_last)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; the identity without one.
    Under data parallelism the mask is drawn at the global batch's shape
    and each rank keeps its own rows, so N ranks drop what one process
    drops on the whole batch."""
    if generator is None:
        return x
    world = dp.world_size()
    b = x.shape[0]
    keep = torch.empty((b * world, *x.shape[1:]), device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    if world > 1:
        keep = keep[dp.rank() * b:(dp.rank() + 1) * b]
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


class ResNetBackbone(nn.Module):
    def __init__(self, layers: Sequence[int] = RESNET_LAYERS[101],
                 output_stride: int = 16):
        super().__init__()
        if output_stride == 16:
            strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
        elif output_stride == 8:
            strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
        else:
            raise NotImplementedError(output_stride)
        self.conv1 = make_conv(3, 64, 7, 2, init_mode="fan_out")
        self.bn1 = BatchNorm(64)
        cin = 64
        stages = []
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 (*layers[:3], 3))):
            grid = (1, 2, 4) if i == 3 else (1,) * blocks   # multi-grid unit
            stage = nn.ModuleList()
            for b in range(blocks):
                stage.append(Bottleneck(cin, planes,
                                        strides[i] if b == 0 else 1,
                                        dilations[i] * grid[b], b == 0))
                cin = planes * 4
            stages.append(stage)
        self.layer1, self.layer2, self.layer3, self.layer4 = stages

    def forward(self, x: torch.Tensor, train: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = bn_relu(apply_conv(x, self.conv1), self.bn1, train)
        x = F.max_pool2d(x, 3, 2, padding=1)      # pads with -inf
        low_level = None
        for i, stage in enumerate((self.layer1, self.layer2, self.layer3,
                                   self.layer4)):
            for block in stage:
                x = block(x, train)
            if i == 0:
                low_level = x
        return x, low_level


class InvertedResidual(nn.Module):
    """MobileNetV2 block; ``conv`` holds the reference's slots: [expand
    conv, bn, ReLU6,] depthwise conv, bn, ReLU6, project conv, bn."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dilation: int):
        super().__init__()
        hidden = cin * expand
        self.stride, self.dilation = stride, dilation
        self.use_res = stride == 1 and cin == cout
        slots = []
        if expand != 1:
            slots += [make_conv(cin, hidden, 1), BatchNorm(hidden),
                      nn.Identity()]
        slots += [make_conv(hidden, hidden, 3, stride, dilation, padding=0,
                            groups=hidden, init_mode="fan_out"),
                  BatchNorm(hidden), nn.Identity(),
                  make_conv(hidden, cout, 1), BatchNorm(cout)]
        self.conv = nn.Sequential(*slots)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        d = self.dilation
        out = F.pad(x, (d, d, d, d))                 # fixed_padding
        slots = list(self.conv)
        if len(slots) == 8:
            out = relu6(slots[1](apply_conv(out, slots[0]), train))
            slots = slots[3:]
        out = relu6(slots[1](apply_conv(out, slots[0]), train))
        out = slots[4](apply_conv(out, slots[3]), train)
        return x + out if self.use_res else out


class MobileNetBackbone(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        features = [nn.Sequential(make_conv(3, 32, 3, 2), BatchNorm(32))]
        current_stride, rate, cin = 2, 1, 32
        for t, c, n, s in MOBILENET_CFG:
            if current_stride == output_stride:
                stride0, dilation = 1, rate
                rate *= s
            else:
                stride0, dilation = s, 1
                current_stride *= s
            for i in range(n):
                features.append(InvertedResidual(
                    cin, c, stride0 if i == 0 else 1, t, dilation))
                cin = c
        self.features = nn.Sequential(*features)
        # the reference's views of the same modules (original indices kept)
        self.low_level_features = self.features[0:4]
        self.high_level_features = self.features[4:]

    def forward(self, x: torch.Tensor, train: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        stem = self.features[0]
        x = relu6(stem[1](apply_conv(x, stem[0]), train))
        low_level = None
        for i, block in enumerate(list(self.features)[1:], start=1):
            x = block(x, train)
            if i == 3:                    # after stage 1 (24 channels)
                low_level = x
        return x, low_level


class _ASPPBranch(nn.Module):
    def __init__(self, cin: int, k: int, dilation: int):
        super().__init__()
        self.atrous_conv = make_conv(cin, 256, k, dilation=dilation)
        self.bn = BatchNorm(256)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return bn_relu(apply_conv(x, self.atrous_conv), self.bn, train)


class ASPP(nn.Module):
    def __init__(self, cin: int, output_stride: int = 16):
        super().__init__()
        d = (1, 6, 12, 18) if output_stride == 16 else (1, 12, 24, 36)
        self.aspp1 = _ASPPBranch(cin, 1, 1)
        self.aspp2 = _ASPPBranch(cin, 3, d[1])
        self.aspp3 = _ASPPBranch(cin, 3, d[2])
        self.aspp4 = _ASPPBranch(cin, 3, d[3])
        self.global_avg_pool = nn.Sequential(
            nn.Identity(), make_conv(cin, 256, 1), BatchNorm(256))
        self.conv1 = make_conv(1280, 256, 1)
        self.bn1 = BatchNorm(256)

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        branches = [b(x, train) for b in (self.aspp1, self.aspp2, self.aspp3,
                                          self.aspp4)]
        # the pool in at least float32, back to the compute dtype; 1x1 -> a
        # broadcast
        gp = torch.mean(at_least_f32(x), dim=(2, 3), keepdim=True).to(x.dtype)
        gp = bn_relu(apply_conv(gp, self.global_avg_pool[1]),
                     self.global_avg_pool[2], train)
        branches.append(gp.expand_as(branches[-1]))
        out = _cat(branches)
        out = bn_relu(apply_conv(out, self.conv1), self.bn1, train)
        return dropout(out, 0.5, generator)


class Decoder(nn.Module):
    def __init__(self, num_classes: int, low_level_ch: int):
        super().__init__()
        self.conv1 = make_conv(low_level_ch, 48, 1)
        self.bn1 = BatchNorm(48)
        self.last_conv = nn.Sequential(
            make_conv(304, 256, 3), BatchNorm(256), nn.Identity(),
            nn.Identity(),
            make_conv(256, 256, 3), BatchNorm(256), nn.Identity(),
            nn.Identity(),
            make_conv(256, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor, low_level: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lc = self.last_conv
        ll = bn_relu(apply_conv(low_level, self.conv1), self.bn1, train)
        x = resize_bilinear_ac(x, ll.shape[2], ll.shape[3])
        x = _cat([x, ll])
        x = dropout(bn_relu(apply_conv(x, lc[0]), lc[1], train), 0.5,
                    generator)
        x = dropout(bn_relu(apply_conv(x, lc[4]), lc[5], train), 0.1,
                    generator)
        return apply_conv(x, lc[8])


class DeepLab(nn.Module):
    """backbone -> ASPP -> decoder -> align-corners upsample to the input;
    under a profiler each stage is a ``utils.spans`` span (the upsample
    inside the decoder's)."""

    def __init__(self, backbone: str = "resnet", output_stride: int = 16,
                 num_classes: int = 21,
                 resnet_layers: Sequence[int] = RESNET_LAYERS[101]):
        super().__init__()
        if backbone == "drn":               # DRN-D is always output stride 8
            output_stride = 8
        if backbone == "resnet":
            self.backbone = ResNetBackbone(tuple(resnet_layers), output_stride)
            high, low = 2048, 256
        elif backbone == "mobilenet":
            self.backbone = MobileNetBackbone(output_stride)
            high, low = 320, 24
        elif backbone == "xception":
            self.backbone = XceptionBackbone(output_stride)
            high, low = 2048, 128
        elif backbone == "drn":
            self.backbone = DRNBackbone()
            high, low = 512, 256
        else:
            raise NotImplementedError(f"backbone '{backbone}'")
        self.aspp = ASPP(high, output_stride)
        self.decoder = Decoder(num_classes, low)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B,3,H,W) in the compute dtype -> (B,num_classes,H,W) logits in
        that dtype."""
        x = x.contiguous(memory_format=torch.channels_last)
        with span(DEEPLAB_BACKBONE):
            feat, low = self.backbone(x, train)
        with span(DEEPLAB_ASPP):
            out = self.aspp(feat, train, generator)
        with span(DEEPLAB_DECODER):
            out = self.decoder(out, low, train, generator)
            out = resize_bilinear_ac(out, x.shape[2], x.shape[3])
        return out


@torch.no_grad()
def kaiming_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init: kaiming-normal convs (gain sqrt 2, each
    conv's fan mode: fan_out in the ResNet blocks, stem and depthwise
    convs, fan_in elsewhere), zero conv biases, BN scale 1, bias 0, running
    mean 0, var 1.  Each parameter is drawn once, in module order."""
    seen = set()
    for m in net.modules():
        if id(m) in seen:
            continue
        seen.add(id(m))
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            fan = (i if m.init_mode == "fan_in" else o) * kh * kw
            m.weight.normal_(0.0, (2.0 / fan) ** 0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return net
