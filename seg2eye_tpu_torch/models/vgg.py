"""VGG19 feature slices for the perceptual (VGG) loss (counterpart of
``seg2eye_tpu/models/vgg.py``).

  * ``VGG19Features``: torchvision's ``vgg19.features`` up to relu5_1, under
    torchvision's own names (``features.{idx}.weight``/``.bias``), so that
    the convs of a torchvision ``vgg19`` state_dict load with
    ``strict=True`` (``load_vgg19``).  The forward returns the five
    relu{1..5}_1 activations.  Inputs are generator-range images in
    [-1, 1]: there is no ImageNet re-normalisation, as in SPADE.
  * ``to_rgb``: grayscale repeated to 3 channels, float32.

The net is frozen: its parameters never require a gradient and are in no
optimizer.  Under tensor parallelism its wide convs are sharded by the
rule of G's, E's and D's (``parallel.tensor_parallel.conv2d``).  Convolutions run in the input's dtype (float32 parameters cast
at the call).  Pretrained weights come only from ``--vgg_weights``
(``utils.checkpoint.load_vgg``); ``utils.weights.init_networks`` seeds
torchvision's own init for runs without them.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.parallel import tensor_parallel as tp

# torchvision vgg19.features: (index, in, out) of each conv, "M" a 2x2
# max pool; each slice ends after the ReLU of conv{1..5}_1
BLOCKS = (
    ((0, 3, 64),),
    ((2, 64, 64), "M", (5, 64, 128)),
    ((7, 128, 128), "M", (10, 128, 256)),
    ((12, 256, 256), (14, 256, 256), (16, 256, 256), "M", (19, 256, 512)),
    ((21, 512, 512), (23, 512, 512), (25, 512, 512), "M", (28, 512, 512)),
)


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers = {}
        for block in BLOCKS:
            for step in block:
                if step != "M":
                    idx, fin, fout = step
                    layers[idx] = nn.Conv2d(fin, fout, 3, padding=1)
        # the pools and ReLUs hold no parameters; identities keep
        # torchvision's indices for the convs
        self.features = nn.Sequential(*(layers.get(i, nn.Identity())
                                        for i in range(max(layers) + 1)))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (N,3,H,W) -> [relu1_1 .. relu5_1], NCHW, in x's dtype."""
        outs = []
        for block in BLOCKS:
            for step in block:
                if step == "M":
                    x = F.max_pool2d(x, 2, 2)
                else:
                    conv = self.features[step[0]]
                    x = F.relu(tp.conv2d(x, conv.weight, conv.bias,
                                         padding=1))
            outs.append(x)
        return outs


def to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,{1,3}) or (B,H,W) -> (B,H,W,3) float32."""
    x = x.to(torch.float32)
    if x.dim() == 3:
        x = x[..., None]
    if x.shape[-1] == 3:
        return x
    if x.shape[-1] != 1:
        raise ValueError(f"to_rgb takes 1 or 3 channels, got {x.shape}")
    return x.expand(*x.shape[:-1], 3)


@torch.no_grad()
def init_vgg19_(net: VGG19Features, generator: torch.Generator) -> None:
    """torchvision's VGG init: kaiming normal (fan_out, ReLU), zero bias."""
    for m in net.features:
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            m.bias.zero_()


def load_vgg19(net: VGG19Features, state_dict) -> VGG19Features:
    """Load a torchvision ``vgg19`` state_dict (``features.*``, the
    classifier ignored) or a ``vgg19.features`` one (``{idx}.*``) into
    ``net``, strictly: each of its convs must be there."""
    sd = {(k if k.startswith("features.") else f"features.{k}"): v
          for k, v in state_dict.items() if not k.startswith("classifier.")}
    wanted = net.state_dict()
    net.load_state_dict({k: sd[k] for k in wanted if k in sd}, strict=True)
    return net
