"""SPADE+Style conditional norm blocks (counterpart of
``seg2eye_tpu/models/normalization.py``), and GauGAN's plain SPADE ones.

  * ``SpadeStyleBlock``: (SPADE(x, seg) + AdaIN(x, w)) / 2.  The block owns
    the parameters, under the reference's names, and the normalisation
    statistics; the modulation is one call to ``ops.spade_style.spade_style``
    (the CUDA kernel for CUDA tensors).
  * ``SpadeBlock``: plain SPADE, normalize(x) * (1 + gamma) + beta (NVlabs/
    SPADE), under SPADE's parameter names, one call to ``ops.spade.spade``;
    ``SpadeResnetBlock`` is ``SpadeStyleResnetBlock`` with these norms and
    no style input.  The JAX package has no counterpart.
  * Param-free batch statistics are biased, over (N, H, W), in float32
    (bfloat16 CUDA tensors: ``ops.batch_stats``, one read of x; everything
    else ``torch.var_mean``); the running statistics are used only when asked
    (``use_running_average``, from ``opt.eval_use_running_stats``).  A
    training forward (``update_stats=True``) updates them as torch's
    BatchNorm does: momentum 0.1, the unbiased variance into
    ``running_var``, ``num_batches_tracked`` counted.  Under data
    parallelism they are the global batch's (``parallel.data_parallel.
    synced_var_mean``), and the kernel normalises each rank's samples with
    them; instance statistics stay per sample.
  * Under tensor parallelism (``parallel.tensor_parallel``) a site whose
    ``mlp_gamma``/``mlp_beta`` are sharded runs the kernel on this model
    rank's channel slice: the kernel is separable by channel, so x, the
    statistics, [s0|s1], the gamma/beta biases and weights are sliced,
    the seg MLP is whole, and the output channels are gathered.  The
    other sites run whole on every rank.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from seg2eye_tpu_torch.models.layers import FCStyle, SpectralConv, at_least_f32
from seg2eye_tpu_torch.ops.batch_stats import batch_stats, takes_kernel
from seg2eye_tpu_torch.ops.spade import spade
from seg2eye_tpu_torch.ops.spade_style import NHIDDEN, spade_style
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.parallel import tensor_parallel as tp


def parse_norm_g(norm_g: str) -> Tuple[bool, str, int]:
    """'spectralspadebatch3x3' -> (spectral=True, param_free='batch', ks=3).
    SPADE's 'syncbatch' reads as 'batch': the batch statistics of a norm
    site are already the global batch's under the port's data parallelism
    (``parallel.data_parallel.synced_var_mean``), as a synchronized BN's
    are, and its buffers are BatchNorm2d's."""
    spectral = "spectral" in norm_g
    cfg = norm_g.replace("spectral", "")
    if not cfg.startswith("spade"):
        raise ValueError(f"norm_G must name a spade norm, got {norm_g!r}")
    rest = cfg[len("spade"):]
    ks = int(rest[-3])
    param_free = rest[:-3]
    return spectral, ("batch" if param_free == "syncbatch" else param_free), ks


class _SPADE(nn.Module):
    """Parameter holder with the reference's SPADE names:
    ``mlp_shared.0``, ``mlp_gamma``, ``mlp_beta``, ``param_free_norm``;
    ``modulate`` runs the site."""

    def __init__(self, param_free: str, norm_nc: int, label_nc: int):
        super().__init__()
        self.param_free = param_free
        if param_free == "batch":
            # running_mean / running_var / num_batches_tracked buffers only;
            # the statistics are computed in ``modulate``
            self.param_free_norm = nn.BatchNorm2d(norm_nc, affine=False)
        elif param_free == "instance":
            self.param_free_norm = nn.InstanceNorm2d(norm_nc, affine=False)
        else:
            raise ValueError(f"param-free norm {param_free!r}")
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, NHIDDEN, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(NHIDDEN, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(NHIDDEN, norm_nc, 3, padding=1)

    def modulate(self, x: torch.Tensor, seg: torch.Tensor, style,
                 use_running_average: bool = False,
                 update_stats: bool = False, band=None) -> torch.Tensor:
        """x: (N,C,H,W) channels_last; seg: (N,S,H,W); style: (N, 2C)
        [s0|s1] for SPADE+Style (``ops.spade_style``), or None for plain
        SPADE (``ops.spade``).  ``band`` (``parallel.spatial.Band``): x is
        an H band of the map, seg the whole map; the statistics are the
        whole map's, and the kernel runs on the band with two neighbouring
        rows of x and seg beyond each interior edge."""
        n, c = x.shape[:2]
        if self.param_free == "batch":
            pfn = self.param_free_norm
            if use_running_average:
                mean, var = pfn.running_mean, pfn.running_var
            elif band is not None:
                var, mean = band.var_mean(at_least_f32(x), (0, 2, 3))
            elif dp.active():
                var, mean, count = dp.synced_var_mean(at_least_f32(x),
                                                      (0, 2, 3))
                if update_stats:
                    self._update_running_stats(mean, var, count)
            else:
                var, mean = (
                    batch_stats(x.permute(0, 2, 3, 1)) if takes_kernel(x)
                    else torch.var_mean(at_least_f32(x), dim=(0, 2, 3),
                                        correction=0))
                if update_stats:
                    self._update_running_stats(mean, var, x.numel() // c)
            mean_nc, var_nc = mean.expand(n, c), var.expand(n, c)
        elif band is not None:
            var_nc, mean_nc = band.var_mean(at_least_f32(x), (2, 3))
        else:
            var_nc, mean_nc = torch.var_mean(at_least_f32(x), dim=(2, 3),
                                             correction=0)
        rows = x.shape[2]
        if band is not None:
            x, top = band.extend(x, 2)
            seg = band.take(seg, 2)
        ws, bs = self.mlp_shared[0].weight, self.mlp_shared[0].bias
        bg, bb = self.mlp_gamma.bias, self.mlp_beta.bias
        sliced = tp.is_sharded(self.mlp_gamma.weight)
        if sliced:
            # each model rank's gradient of what it reads whole covers its
            # slice only: the backward sums them over the model group
            x, mean_nc, var_nc, bg, bb = (tp.my_block(t, d) for t, d in (
                (x, 1), (mean_nc, 1), (var_nc, 1), (bg, 0), (bb, 0)))
            if style is not None:
                style = tp.my_block(style.reshape(n, 2, c), 2).reshape(n, -1)
            ws, bs = tp.partial(ws), tp.partial(bs)
        else:
            ws = tp.replicated(ws)
        x, seg = x.permute(0, 2, 3, 1), seg.permute(0, 2, 3, 1).to(x.dtype)
        weights = (ws, bs, self.mlp_gamma.weight, bg, self.mlp_beta.weight,
                   bb)
        out = (spade(x, seg, mean_nc, var_nc, *weights) if style is None
               else spade_style(x, seg, style, mean_nc, var_nc, *weights))
        out = out.permute(0, 3, 1, 2)
        if band is not None:
            out = out[:, :, top:top + rows]
        return tp.gather(out) if sliced else out

    @torch.no_grad()
    def _update_running_stats(self, mean, var, count) -> None:
        """``count``: the elements behind each statistic, an int or (data
        parallel, the global count) a 0-d tensor."""
        pfn = self.param_free_norm
        if torch.is_tensor(count):
            unbiased = var * (count / (count - 1).clamp(min=1))
        else:
            unbiased = var * (count / max(count - 1, 1))
        pfn.running_mean.mul_(0.9).add_(0.1 * mean)
        pfn.running_var.mul_(0.9).add_(0.1 * unbiased)
        pfn.num_batches_tracked += 1


class SpadeStyleBlock(nn.Module):
    def __init__(self, param_free: str, norm_nc: int, label_nc: int,
                 w_dim: int, ks: int = 3):
        super().__init__()
        if ks != 3:
            raise ValueError("the fused norm implements the default 3x3 SPADE")
        self.spade = _SPADE(param_free, norm_nc, label_nc)
        self.adain = FCStyle(w_dim, 2 * norm_nc, gain=1.0)

    def forward(self, x: torch.Tensor, seg: torch.Tensor, w: torch.Tensor,
                use_running_average: bool = False,
                update_stats: bool = False, band=None) -> torch.Tensor:
        """x: (N,C,H,W) channels_last; seg: (N,S,H,W); w: (N,w_dim).
        ``band``: as ``_SPADE.modulate``'s."""
        style = self.adain(at_least_f32(w))                       # (N, 2C)
        return self.spade.modulate(x, seg, style, use_running_average,
                                   update_stats, band)


class SpadeBlock(_SPADE):
    """GauGAN's plain SPADE norm (NVlabs/SPADE ``normalization.SPADE``),
    under its parameter names (``mlp_shared.0``, ``mlp_gamma``,
    ``mlp_beta``, ``param_free_norm``): normalize(x) * (1 + gamma) +
    beta, one call to ``ops.spade.spade`` (the CUDA kernel for CUDA
    tensors), with the statistics of ``SpadeStyleBlock``."""

    def __init__(self, param_free: str, norm_nc: int, label_nc: int,
                 ks: int = 3):
        if ks != 3:
            raise ValueError("the fused norm implements the default 3x3 SPADE")
        super().__init__(param_free, norm_nc, label_nc)

    def forward(self, x: torch.Tensor, seg: torch.Tensor, w=None,
                use_running_average: bool = False,
                update_stats: bool = False, band=None) -> torch.Tensor:
        """x: (N,C,H,W) channels_last; seg: (N,S,H,W); ``w`` is not read
        (the resnet block hands every norm the same arguments)."""
        return self.modulate(x, seg, None, use_running_average,
                             update_stats, band)


class SpadeStyleResnetBlock(nn.Module):
    """ResNet block with SPADE+Style norms (reference architecture.py:13-62).

    With ``remat`` (``--remat``) the block runs under non-reentrant
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward.  The recompute must see what
    the forward saw and write nothing: the spectral kernels (whose power
    iteration advances u/v) are computed once, outside the checkpointed
    body, and passed in; the running statistics are updated by the first
    run of the body only (the recompute's batch statistics are the same
    numbers, from the same input)."""

    def __init__(self, fin: int, fout: int, semantic_nc: int, w_dim: int,
                 spectral: bool = True, param_free: str = "batch",
                 ks: int = 3):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout

        def norm(ch):
            return self.make_norm(param_free, ch, semantic_nc, w_dim, ks)

        self.conv_0 = SpectralConv(fin, fmiddle, 3, spectral=spectral)
        self.conv_1 = SpectralConv(fmiddle, fout, 3, spectral=spectral)
        self.norm_0 = norm(fin)
        self.norm_1 = norm(fmiddle)
        if self.learned_shortcut:
            self.conv_s = SpectralConv(fin, fout, 1, bias=False,
                                       spectral=spectral)
            self.norm_s = norm(fin)

    @staticmethod
    def make_norm(param_free, ch, semantic_nc, w_dim, ks) -> nn.Module:
        return SpadeStyleBlock(param_free, ch, semantic_nc, w_dim, ks)

    def _convs(self):
        return [self.conv_0, self.conv_1] + (
            [self.conv_s] if self.learned_shortcut else [])

    def _body(self, x, seg, w, kernels, use_running_average, update_stats,
              band=None):
        k0, k1, *ks = kernels

        def norm(layer, t):
            return layer(t, seg, w, use_running_average, update_stats, band)

        x_s = (self.conv_s(norm(self.norm_s, x), kernel=ks[0], band=band)
               if self.learned_shortcut else x)
        dx = self.conv_0(F.leaky_relu(norm(self.norm_0, x), 0.2), kernel=k0,
                         band=band)
        dx = self.conv_1(F.leaky_relu(norm(self.norm_1, dx), 0.2), kernel=k1,
                         band=band)
        return x_s + dx

    def forward(self, x, seg, w, use_running_average: bool = False,
                update_stats: bool = False, remat: bool = False, band=None):
        """``band``: x is an H band (``parallel.spatial.Band``), seg the
        whole map at x's resolution; the result is the band."""
        kernels = [c.kernel(update_stats) for c in self._convs()]
        if not (remat and torch.is_grad_enabled()):
            return self._body(x, seg, w, kernels, use_running_average,
                              update_stats, band)
        first = [True]

        def body(x, seg, w, *kernels):
            writes, first[0] = first[0], False
            return self._body(x, seg, w, kernels, use_running_average,
                              update_stats and writes)

        return checkpoint(body, x, seg, w, *kernels, use_reentrant=False)


class SpadeResnetBlock(SpadeStyleResnetBlock):
    """GauGAN's ResNet block (NVlabs/SPADE ``architecture.py``
    SPADEResnetBlock): ``SpadeStyleResnetBlock`` with plain SPADE norms,
    which read no style (``w`` is None throughout)."""

    def __init__(self, fin: int, fout: int, semantic_nc: int,
                 spectral: bool = True, param_free: str = "batch",
                 ks: int = 3):
        super().__init__(fin, fout, semantic_nc, 0, spectral, param_free, ks)

    @staticmethod
    def make_norm(param_free, ch, semantic_nc, w_dim, ks) -> nn.Module:
        return SpadeBlock(param_free, ch, semantic_nc, ks)
