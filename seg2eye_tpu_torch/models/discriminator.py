"""Multiscale PatchGAN discriminator (counterpart of
``seg2eye_tpu/models/discriminator.py``).

  * ``NLayerDiscriminator``: k=4 convs with padding 2, nf from ndf doubling
    to at most 512, stride 2 except on the last middle conv.  The first and
    the final convs are plain; the middle ones are spectral, then the
    sub-norm (param-free instance norm by default, the affine batch norm
    under ``norm_D='spectralbatch'``; the conv bias removed).
    LeakyReLU(0.2) after every conv but the last.  Every stage's output is
    returned, the logits last, for feature matching.
  * ``MultiscaleDiscriminator``: num_D of them, the input downsampled by
    ``avg_pool_3x3s2`` between scales.

Module names are the reference's, so its state_dict (and the JAX package's
``export_discriminator``) loads with ``strict=True``:
``discriminator_{k}.model{n}.0[.0|.1]``.  Activations are NCHW in
channels_last memory.  A batch sub-norm normalises over the whole input
batch: in training that is the [fake | real] 2B batch, one BN batch, as in
the JAX package.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.models.layers import (BatchSubNorm, SpectralConv,
                                             SubNorm, parse_nonspade_norm,
                                             sub_norm)
from seg2eye_tpu_torch.ops.image import avg_pool_3x3s2


class _LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2)


def _run(stage: nn.Sequential, x: torch.Tensor, update_stats: bool,
         use_running_average: bool) -> torch.Tensor:
    for m in stage:
        if isinstance(m, SpectralConv):
            x = m(x, update_stats)
        elif isinstance(m, (SubNorm, BatchSubNorm)):
            x = m(x, use_running_average, update_stats)
        elif isinstance(m, nn.Sequential):
            x = _run(m, x, update_stats, use_running_average)
        else:
            x = m(x)
    return x


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 norm_d: str = "spectralinstance"):
        super().__init__()
        spectral, sub = parse_nonspade_norm(norm_d)
        self.n_layers = n_layers
        self.model0 = nn.Sequential(
            SpectralConv(input_nc, ndf, 4, stride=2, padding=2,
                         spectral=False), _LeakyReLU())
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            conv = SpectralConv(nf_prev, nf, 4, stride=stride, padding=2,
                                bias=sub in ("", "none"), spectral=spectral)
            # without a sub-norm the reference keeps the bare conv
            body = (conv if sub in ("", "none")
                    else nn.Sequential(conv, sub_norm(sub, nf)))
            self.add_module(f"model{n}", nn.Sequential(body, _LeakyReLU()))
        self.add_module(f"model{n_layers}", nn.Sequential(
            SpectralConv(nf, 1, 4, stride=1, padding=2, spectral=False)))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                use_running_average: bool = False) -> List[torch.Tensor]:
        results = []
        for n in range(self.n_layers + 1):
            x = _run(getattr(self, f"model{n}"), x, update_stats,
                     use_running_average)
            results.append(x)
        return results


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 4,
                 num_d: int = 2, norm_d: str = "spectralinstance",
                 get_intermediate_features: bool = True):
        super().__init__()
        self.num_d = num_d
        self.get_intermediate_features = get_intermediate_features
        for i in range(num_d):
            self.add_module(f"discriminator_{i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, norm_d))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                use_running_average: bool = False
                ) -> List[List[torch.Tensor]]:
        """x: (N,C,H,W) -> per scale, the stage outputs (or the logits
        alone without intermediate features)."""
        result = []
        for i in range(self.num_d):
            out = getattr(self, f"discriminator_{i}")(x, update_stats,
                                                     use_running_average)
            result.append(out if self.get_intermediate_features
                          else [out[-1]])
            if i != self.num_d - 1:
                x = avg_pool_3x3s2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return result
