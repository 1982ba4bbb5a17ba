"""Aligned Xception and DRN-D-54, the DeepLab backbones of the counterpart
``seg2eye_tpu/models/backbones_extra.py``.

Module and parameter names are the reference's torch names (the keys that
``utils.weights.export_deeplab`` writes), and parameterless slots of its
``nn.Sequential``s (ReLU) are ``nn.Identity`` placeholders that keep the
indices, as in ``models/deeplab.py``.  Every conv is kaiming fan_out
(``init_mode="fan_out"``; a depthwise kernel's fan is its in_ch * 9); every
batch norm is ``layers.BatchNorm``, statistics in float32 and the result
in the input's dtype.

  * AlignedXception: a 3x3/2 32 and a 3x3 64 stem, blocks 1-3 (128/256/728
    channels; strides 2, 2 and 2 at os16, 1 at os8), 16 middle-flow blocks
    at 728 (dilation 1 at os16, 2 at os8), the exit block 20 (1024,
    grow_first=False, is_last) and three separable convs to 1536/1536/2048
    at dilation 2 (os16) or 4 (os8).  The low-level feature is the ReLU of
    block 1's output (128 channels).  A block's ``rep`` holds three
    (ReLU, SeparableConv, BN) units; blocks 1 and 2 start without the
    ReLU, so their indices are one lower.  The reference's TF-'same' fixed
    padding of a 3x3 depthwise kernel is pad = dilation on every side, so
    the conv pads itself and the graph has no pad node.
  * DRN-D-54: a 7x7 16 stem (``layer0``), conv layers 1-2 (16, 32/2),
    bottleneck layers 3-6 (64/2, 128/2, 256 at dilation 2, 512 at
    dilation 4; the ResNet ``layers.Bottleneck``, whose convs, BNs and
    residual are DRN's), conv layers 7-8 (512 at dilations 2 and 1).  The
    low-level feature is layer 3's output (256 channels); the output
    stride is always 8.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from seg2eye_tpu_torch.models.layers import (BatchNorm, Bottleneck, apply_conv,
                                             make_conv)

# drn_d_54: blocks per layer and channels
DRN_LAYERS = (1, 1, 3, 4, 6, 3, 1, 1)
DRN_CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (padded by its dilation) -> BN -> pointwise 1x1."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = make_conv(cin, cin, 3, stride, dilation, groups=cin,
                               init_mode="fan_out")
        self.bn = BatchNorm(cin)
        self.pointwise = make_conv(cin, cout, 1, init_mode="fan_out")

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.bn(apply_conv(x, self.conv1), train)
        return apply_conv(x, self.pointwise)


class XceptionBlock(nn.Module):
    def __init__(self, cin: int, cout: int, reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True, is_last: bool = False):
        super().__init__()
        units = []                                  # (cin, cout, stride, d)
        if grow_first:
            units.append((cin, cout, 1, dilation))
        filters = cout if grow_first else cin
        units += [(filters, filters, 1, dilation)] * (reps - 1)
        if not grow_first:
            units.append((cin, cout, 1, dilation))
        if stride != 1:
            units.append((cout, cout, 2, 1))
        if stride == 1 and is_last:
            units.append((cout, cout, 1, 1))
        if cout != cin or stride != 1:
            self.skip = make_conv(cin, cout, 1, stride, init_mode="fan_out")
            self.skipbn = BatchNorm(cout)
        else:
            self.skip = self.skipbn = None
        slots = []
        for u in units:
            slots += [nn.Identity(), SeparableConv(*u), BatchNorm(u[1])]
        self.start_with_relu = start_with_relu
        self.rep = nn.Sequential(*(slots if start_with_relu else slots[1:]))

    def forward(self, inp: torch.Tensor, train: bool) -> torch.Tensor:
        x = inp
        off = 0 if self.start_with_relu else -1
        for u in range((len(self.rep) + 1) // 3):
            if u or self.start_with_relu:
                x = torch.relu(x)
            sep, bn = self.rep[3 * u + 1 + off], self.rep[3 * u + 2 + off]
            x = bn(sep(x, train), train)
        skip = inp if self.skip is None else \
            self.skipbn(apply_conv(inp, self.skip), train)
        return x + skip


class XceptionBackbone(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride == 16:
            entry3_stride, mid_d, exit_d = 2, 1, (1, 2)
        elif output_stride == 8:
            entry3_stride, mid_d, exit_d = 1, 2, (2, 4)
        else:
            raise NotImplementedError(output_stride)
        self.conv1 = make_conv(3, 32, 3, 2, init_mode="fan_out")
        self.bn1 = BatchNorm(32)
        self.conv2 = make_conv(32, 64, 3, init_mode="fan_out")
        self.bn2 = BatchNorm(64)
        self.block1 = XceptionBlock(64, 128, 2, 2, start_with_relu=False)
        self.block2 = XceptionBlock(128, 256, 2, 2, start_with_relu=False)
        self.block3 = XceptionBlock(256, 728, 2, entry3_stride, is_last=True)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, 1, mid_d))
        self.block20 = XceptionBlock(728, 1024, 2, 1, exit_d[0],
                                     grow_first=False, is_last=True)
        self.conv3 = SeparableConv(1024, 1536, 1, exit_d[1])
        self.bn3 = BatchNorm(1536)
        self.conv4 = SeparableConv(1536, 1536, 1, exit_d[1])
        self.bn4 = BatchNorm(1536)
        self.conv5 = SeparableConv(1536, 2048, 1, exit_d[1])
        self.bn5 = BatchNorm(2048)

    def forward(self, x: torch.Tensor, train: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.bn1(apply_conv(x, self.conv1), train))
        x = torch.relu(self.bn2(apply_conv(x, self.conv2), train))
        x = torch.relu(self.block1(x, train))
        low_level = x
        for i in range(2, 21):
            x = getattr(self, f"block{i}")(x, train)
        x = torch.relu(x)
        for i in (3, 4, 5):
            sep, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            x = torch.relu(bn(sep(x, train), train))
        return x, low_level


def _conv_layers(cin: int, cout: int, convs: int, stride: int = 1,
                 dilation: int = 1) -> nn.Sequential:
    """DRN's (conv 3x3, BN, ReLU) * convs."""
    slots = []
    for i in range(convs):
        slots += [make_conv(cin if i == 0 else cout, cout, 3,
                            stride if i == 0 else 1, dilation,
                            init_mode="fan_out"),
                  BatchNorm(cout), nn.Identity()]
    return nn.Sequential(*slots)


def _res_layer(cin: int, planes: int, blocks: int, stride: int = 1,
               dilation: int = 1) -> nn.ModuleList:
    """DRN's bottleneck layer.  Its first block's conv2 takes ``dilation``
    (the reference's pair is (dilation // 2 if new_level else dilation,
    dilation) and only the second reaches conv2; layers 5 and 6 have
    new_level=False)."""
    layer = nn.ModuleList()
    for i in range(blocks):
        layer.append(Bottleneck(cin, planes, stride if i == 0 else 1,
                                dilation, i == 0 and (
                                    stride != 1 or cin != planes * 4)))
        cin = planes * 4
    return layer


class DRNBackbone(nn.Module):
    """drn_d_54: bottleneck layers [1,1,3,4,6,3,1,1], arch 'D'."""

    def __init__(self, layers: Sequence[int] = DRN_LAYERS,
                 channels: Sequence[int] = DRN_CHANNELS):
        super().__init__()
        ch = channels
        self.layer0 = nn.Sequential(
            make_conv(3, ch[0], 7, init_mode="fan_out"), BatchNorm(ch[0]),
            nn.Identity())
        self.layer1 = _conv_layers(ch[0], ch[0], layers[0])
        self.layer2 = _conv_layers(ch[0], ch[1], layers[1], 2)
        self.layer3 = _res_layer(ch[1], ch[2], layers[2], 2)
        self.layer4 = _res_layer(ch[2] * 4, ch[3], layers[3], 2)
        self.layer5 = _res_layer(ch[3] * 4, ch[4], layers[4], 1, 2)
        self.layer6 = _res_layer(ch[4] * 4, ch[5], layers[5], 1, 4)
        self.layer7 = _conv_layers(ch[5] * 4, ch[6], layers[6], 1, 2)
        self.layer8 = _conv_layers(ch[6], ch[7], layers[7], 1, 1)

    def forward(self, x: torch.Tensor, train: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        def convs(x, seq):
            for i in range(0, len(seq), 3):
                x = torch.relu(seq[i + 1](apply_conv(x, seq[i]), train))
            return x

        x = convs(convs(convs(x, self.layer0), self.layer1), self.layer2)
        low_level = None
        for i, layer in enumerate((self.layer3, self.layer4, self.layer5,
                                   self.layer6)):
            for block in layer:
                x = block(x, train)
            if i == 0:
                low_level = x                          # 256 channels
        x = convs(convs(x, self.layer7), self.layer8)
        return x, low_level
