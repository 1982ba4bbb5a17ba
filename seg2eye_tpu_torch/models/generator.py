"""SPADE+Style generator (counterpart of ``seg2eye_tpu/models/generator.py``),
and GauGAN's SPADE generator on the same skeleton.

  * Start: the one-hot seg map nearest-resized to the latent size
    (sh, sw) = (round(sw / aspect), crop / 2^n), then a 3x3 conv to 16*ngf.
  * Body: head_0, G_middle_0/1, up_0..3 SPADE+Style ResNet blocks between
    exact 2x nearest upsamples; 'more' and 'most' add upsamples, 'most'
    adds up_4.
  * Final: conv_img(leaky_relu(x)), then tanh.

One nearest-resized seg pyramid level per resolution is computed once per
forward and shared by every norm at that resolution.  A forward with
``remat`` (``--remat``) checkpoints each SPADE+Style block, as the JAX
package's ``nn.remat`` does: its activations are recomputed in the
backward, which launches each of its norm sites' kernel a second time.

``SpadeGenerator`` is GauGAN's (NVlabs/SPADE ``generator.py``
SPADEGenerator without the VAE): the same start, blocks, upsamples and
final conv, its blocks ``SpadeResnetBlock``s of plain SPADE norms, and no
style code.  The JAX package has no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.models.layers import SpectralConv
from seg2eye_tpu_torch.models.normalization import (SpadeResnetBlock,
                                                    SpadeStyleResnetBlock,
                                                    parse_norm_g)
from seg2eye_tpu_torch.ops.image import resize_nearest
from seg2eye_tpu_torch.parallel import spatial

_N_UP = {"normal": 5, "more": 6, "most": 7}


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of an NCHW tensor; the result is in
    channels_last memory."""
    b, c, h, w = x.shape
    t = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    t = t.expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    return t.permute(0, 3, 1, 2)


class SpadeStyleGenerator(nn.Module):
    def __init__(self, ngf: int = 64, output_nc: int = 1, semantic_nc: int = 4,
                 crop_size: int = 256, aspect_ratio: float = 0.8,
                 num_upsampling_layers: str = "normal",
                 norm_g: str = "spectralspadebatch3x3", w_dim: int = 16):
        super().__init__()
        if num_upsampling_layers not in _N_UP:
            raise ValueError(num_upsampling_layers)
        self.num_upsampling_layers = num_upsampling_layers
        sw = crop_size // (2 ** _N_UP[num_upsampling_layers])
        self.latent_size = (round(sw / aspect_ratio), sw)
        spectral, param_free, ks = parse_norm_g(norm_g)
        nf = ngf

        def block(fin, fout):
            return self.make_block(fin, fout, semantic_nc, w_dim, spectral,
                                   param_free, ks)

        self.fc = SpectralConv(semantic_nc, 16 * nf, 3, spectral=False)
        self.head_0 = block(16 * nf, 16 * nf)
        self.G_middle_0 = block(16 * nf, 16 * nf)
        self.G_middle_1 = block(16 * nf, 16 * nf)
        self.up_0 = block(16 * nf, 8 * nf)
        self.up_1 = block(8 * nf, 4 * nf)
        self.up_2 = block(4 * nf, 2 * nf)
        self.up_3 = block(2 * nf, 1 * nf)
        if num_upsampling_layers == "most":
            self.up_4 = block(1 * nf, nf // 2)
        final_nc = nf // 2 if num_upsampling_layers == "most" else nf
        self.conv_img = SpectralConv(final_nc, output_nc, 3, spectral=False)

    @staticmethod
    def make_block(fin, fout, semantic_nc, w_dim, spectral, param_free,
                   ks) -> nn.Module:
        return SpadeStyleResnetBlock(fin, fout, semantic_nc, w_dim, spectral,
                                     param_free, ks)

    def forward(self, seg: torch.Tensor, w: torch.Tensor,
                use_running_average: bool = False,
                update_stats: bool = False,
                remat: bool = False, bands=None) -> torch.Tensor:
        """seg: (B,H,W,semantic_nc) one-hot, NHWC; w: (B,w_dim).
        -> (B,output_nc,H,W) in channels_last memory.  ``update_stats``:
        a training forward, which advances every spectral u/v and BN
        running statistic; ``remat``: checkpoint each block.  ``bands``
        (``parallel.spatial.Bands``): every resolution that the ranks
        divide is computed in H bands, the others whole on every rank; the
        result is whole."""
        pyramid = {}
        latent_h, latent_w = self.latent_size
        band = spatial.at(bands, latent_h)

        def seg_at(h, w_):
            if (h, w_) not in pyramid:
                pyramid[(h, w_)] = resize_nearest(seg, h, w_).permute(0, 3, 1, 2)
            return pyramid[(h, w_)]

        def run(blk, x, h):
            return blk(x, seg_at(h, x.shape[3]), w, use_running_average,
                       update_stats, remat, band)

        def up(x, h):
            new = spatial.at(bands, 2 * h)
            return spatial.place(upsample2x(x), band, new), new, 2 * h

        h = latent_h
        x = self.fc(spatial.place(seg_at(latent_h, latent_w), None, band),
                    band=band)
        x = run(self.head_0, x, h)
        x, band, h = up(x, h)
        x = run(self.G_middle_0, x, h)
        if self.num_upsampling_layers in ("more", "most"):
            x, band, h = up(x, h)
        x = run(self.G_middle_1, x, h)
        for blk in (self.up_0, self.up_1, self.up_2, self.up_3):
            x, band, h = up(x, h)
            x = run(blk, x, h)
        if self.num_upsampling_layers == "most":
            x, band, h = up(x, h)
            x = run(self.up_4, x, h)
        x = self.conv_img(F.leaky_relu(x, 0.2), band=band)
        return spatial.place(torch.tanh(x), band, None)


class SpadeGenerator(SpadeStyleGenerator):
    """GauGAN's generator: seg (B,H,W,semantic_nc) -> image, no style."""

    def __init__(self, ngf: int = 64, output_nc: int = 3,
                 semantic_nc: int = 36, crop_size: int = 512,
                 aspect_ratio: float = 2.0,
                 num_upsampling_layers: str = "more",
                 norm_g: str = "spectralspadesyncbatch3x3"):
        super().__init__(ngf, output_nc, semantic_nc, crop_size,
                         aspect_ratio, num_upsampling_layers, norm_g, 0)

    @staticmethod
    def make_block(fin, fout, semantic_nc, w_dim, spectral, param_free,
                   ks) -> nn.Module:
        return SpadeResnetBlock(fin, fout, semantic_nc, spectral, param_free,
                                ks)

    def forward(self, seg: torch.Tensor, w=None, **kw) -> torch.Tensor:
        """``SpadeStyleGenerator.forward`` with no style code (``w`` is not
        read)."""
        return super().forward(seg, None, **kw)
