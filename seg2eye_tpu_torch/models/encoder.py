"""Convolutional style encoder (counterpart of ``seg2eye_tpu/models/encoder.py``).

  * Any input is first bilinearly resized to 256x256.
  * 6 stride-2 3x3 spectral convs (5 for crop < 256), each followed by the
    sub-norm (instance, none, or the affine batch norm of
    ``norm_E='spectralbatch'``), with NO activation between layers:
    LeakyReLU(0.2) comes once, at the end.
  * fc_mu / fc_var read the final map flattened in (C, H, W) order, which
    is torch's ``view(B, -1)``.
  * Returns (mu, logvar, [per-layer feature maps]).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.models.layers import (SpectralConv, at_least_f32,
                                             parse_nonspade_norm, sub_norm)
from seg2eye_tpu_torch.ops.image import resize_bilinear
from seg2eye_tpu_torch.parallel import spatial

ENC_SIZE = 256


class ConvEncoder(nn.Module):
    def __init__(self, ngf: int = 64, w_dim: int = 16, crop_size: int = 256,
                 norm_e: str = "spectralinstance", input_nc: int = 1):
        super().__init__()
        spectral, sub = parse_nonspade_norm(norm_e)
        widths = [ngf, ngf * 2, ngf * 4, ngf * 8, ngf * 8]
        if crop_size >= 256:
            widths.append(ngf * 8)
        self.n_layers = len(widths)
        fin = input_nc
        for i, fout in enumerate(widths):
            # the norm wrapper removes the conv bias unless there is no norm
            conv = SpectralConv(fin, fout, 3, stride=2, padding=1,
                                bias=sub in ("", "none"), spectral=spectral)
            self.add_module(f"layer{i}",
                            nn.Sequential(conv, sub_norm(sub, fout)))
            fin = fout
        grid = ENC_SIZE // 2 ** self.n_layers
        self.fc_mu = nn.Linear(fin * grid * grid, w_dim)
        self.fc_var = nn.Linear(fin * grid * grid, w_dim)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                use_running_average: bool = False, bands=None
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """x: (N,1,H,W) in [-1,1], channels_last.  ``update_stats``: a
        training forward, which power-iterates every spectral conv and
        updates a batch sub-norm's running statistics;
        ``use_running_average``: a batch sub-norm normalises with them.
        ``bands`` (``parallel.spatial.Bands``): after the resize, every
        map whose height the ranks divide is computed in H bands (a
        stride-2 conv reads one row above its band), the others whole;
        the features are then this rank's bands, and the final map is
        gathered for fc_mu/fc_var."""
        if x.shape[2:] != (ENC_SIZE, ENC_SIZE):
            x = resize_bilinear(x.permute(0, 2, 3, 1), ENC_SIZE, ENC_SIZE)
            x = x.permute(0, 3, 1, 2)
        h = ENC_SIZE
        band = spatial.at(bands, h)
        x = spatial.place(x, None, band)
        features = []
        for i in range(self.n_layers):
            conv, norm = getattr(self, f"layer{i}")
            h //= 2
            new = spatial.at(bands, h)
            if band is not None and (new is None or band.rows % 2):
                x, band = band.gather(x), None
            x = spatial.place(conv(x, update_stats, band=band), band, new)
            band = new
            x = norm(x, use_running_average, update_stats, band=band)
            features.append(x)
        x = spatial.place(x, band, None)
        out = at_least_f32(F.leaky_relu(x, 0.2)).reshape(x.shape[0], -1)
        return self.fc_mu(out), self.fc_var(out), features
