"""Pix2Pix (Seg2Eye) inference (counterpart of the inference subset of
``seg2eye_tpu/models/pix2pix.py``).

  * ``preprocess``: one-hot label map; uint8 style images are normalised
    on the device, (x / 255 - 0.5) / 0.5.
  * ``encode_w``: the (B, k) style references run as ONE fused (B*k)
    encoder batch; mu and every feature map are then aggregated over k
    (mean or max).
  * ``generate``: the generator with batch statistics, as the reference's
    Tester runs it (train mode); running statistics only under
    ``opt.eval_use_running_stats``.

Batches keep the JAX package's layouts: label (B,H,W) int, style_image
(B,k,H,W,1) float or uint8, and the result (B,H,W,1) float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from seg2eye_tpu_torch.models.encoder import ConvEncoder
from seg2eye_tpu_torch.models.generator import SpadeStyleGenerator
from seg2eye_tpu_torch.models.layers import at_least_f32
from seg2eye_tpu_torch.ops.image import one_hot_label

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_networks(opt) -> Dict[str, torch.nn.Module]:
    """Generator and encoder for ``opt``, on the CPU, with placeholder
    weights: load a checkpoint or run ``utils.weights.init_networks``."""
    if opt.netG != "spadestyle" or opt.netE != "conv":
        raise ValueError(f"unknown netG/netE '{opt.netG}'/'{opt.netE}'")
    gen = SpadeStyleGenerator(
        ngf=opt.ngf, output_nc=opt.output_nc, semantic_nc=opt.semantic_nc,
        crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
        num_upsampling_layers=opt.num_upsampling_layers, norm_g=opt.norm_G,
        w_dim=opt.w_dim)
    enc = ConvEncoder(ngf=opt.ngf, w_dim=opt.w_dim, crop_size=opt.crop_size,
                      norm_e=opt.norm_E, input_nc=opt.input_nc)
    return {"G": gen, "E": enc}


class Pix2Pix:
    """The generator and encoder of one configuration, on one device."""

    def __init__(self, opt, nets: Dict[str, torch.nn.Module],
                 device: str | torch.device = "cuda"):
        if opt.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {opt.compute_dtype!r} is not "
                             f"one of {sorted(_DTYPES)}")
        self.opt = opt
        self.device = torch.device(device)
        self.dtype = _DTYPES[opt.compute_dtype]
        self.netG = nets["G"].to(self.device).eval()
        self.netE = nets["E"].to(self.device).eval()

    def preprocess(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (seg (B,H,W,S), style (B,k,H,W,1)) on the device, compute dtype."""
        def norm(x):
            x = torch.as_tensor(x).to(self.device)
            if x.dtype == torch.uint8:
                x = (x.to(torch.float32) / 255.0 - 0.5) / 0.5
            return x.to(self.dtype)

        label = torch.as_tensor(batch["label"]).to(self.device)
        seg = one_hot_label(label, self.opt.semantic_nc).to(self.dtype)
        return seg, norm(batch["style_image"])

    def _aggregate(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.opt.style_aggr_method == "mean":
            return t.mean(dim)
        if self.opt.style_aggr_method == "max":
            return t.amax(dim)
        raise ValueError(self.opt.style_aggr_method)

    def encode_w(self, style: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """style (B,k,H,W,1) -> (w (B,w_dim), aggregated NCHW features)."""
        b, k = style.shape[:2]
        if self.opt.per_sample_encode_enabled and b > 1:
            raise NotImplementedError(
                "per-sample encoding (batch-subnorm encoders) is not ported")
        flat = style.reshape(b * k, *style.shape[2:]).permute(0, 3, 1, 2)
        mu, _, feats = self.netE(flat)
        w = self._aggregate(mu.reshape(b, k, -1), 1)
        feats = [self._aggregate(f.reshape(b, k, *f.shape[1:]), 1)
                 for f in feats]
        return w, feats

    def generate(self, seg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """-> fake (B,H,W,output_nc) in the compute dtype."""
        fake = self.netG(seg, at_least_f32(w),
                         use_running_average=self.opt.eval_use_running_stats)
        return fake.permute(0, 2, 3, 1)

    @torch.no_grad()
    def inference(self, batch: Dict,
                  latent_style: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode the style references (unless ``latent_style`` is given)
        and generate -> (B,H,W,1) float32."""
        seg, style = self.preprocess(batch)
        if latent_style is None:
            latent_style, _ = self.encode_w(style)
        latent_style = torch.as_tensor(latent_style, device=self.device)
        return self.generate(seg, latent_style).to(torch.float32)

    @torch.no_grad()
    def encode_only(self, batch: Dict) -> torch.Tensor:
        _, style = self.preprocess(batch)
        return self.encode_w(style)[0]
