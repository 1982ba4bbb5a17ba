"""Pix2Pix (Seg2Eye): inference and the two training losses (counterpart
of ``seg2eye_tpu/models/pix2pix.py``).

  * ``preprocess``: one-hot label map; uint8 style images and target are
    normalised on the device, (x / 255 - 0.5) / 0.5.
  * ``encode_w``: the (B, k) style references run as ONE fused (B*k)
    encoder batch; mu and every feature map are then aggregated over k
    (mean or max).  With per-sample encoding
    (``opt.per_sample_encode_enabled``: ``--per_sample_encode on``, or
    'auto' with a batch-subnorm encoder) and B > 1 the encoder runs once
    per sample over its own k references, in order, as the reference's
    loop does: in training each run advances u/v and the running
    statistics, so sample b sees a u iterated b + 1 times; a batch sub-norm
    normalises over that sample's k references.  Under data parallelism,
    on a data x model grid too, each rank encodes its samples of the
    global batch so (see ``_encode_samples_replayed``): the run matches the
    one-process run of the global batch.
  * ``generate``: the generator with batch statistics, as the reference's
    Tester runs it (train mode); running statistics only under
    ``opt.eval_use_running_stats``.  A training forward uses batch
    statistics and updates the running ones; with ``opt.remat`` each block
    is recomputed in the backward.
  * ``discriminate``: fake and real run through D as ONE 2B batch,
    [all fake | all real], and every output is split back in halves.
  * ``generator_loss``/``discriminator_loss``: the reference's loss dicts,
    weighted entries beside their ``/raw`` side channel; the total is the
    sum of the weighted entries.  The style-consistency terms
    (``lambda_style_w``/``lambda_style_feat``/``lambda_gram``) encode the
    fake a second time.  The VGG loss (``no_vgg_loss`` False) runs fake and
    real through the frozen VGG19 as one interleaved 2B batch
    [f0, r0, f1, r1, ...] in the compute dtype.

Every training forward (``update_stats=True``) advances the spectral u/v
and the BN running statistics of the nets it runs, as torch's train mode
does: D's inside the generator loss, G's and E's when the discriminator
step regenerates the fake.  The port's modules read no train/eval flag:
each forward is told what to do.

A float32 model computes in full float32: ``inference`` and
``encode_only`` run under ``utils.precision.full_float32``, so that cuDNN
does not take its TF32 default on the card (the training steps wrap
forward, backward and update in it); bfloat16 leaves the flags as they are.

Batches keep the JAX package's layouts: label (B,H,W) int, style_image
(B,k,H,W,1) and target (B,H,W,1) float or uint8, and fakes (B,H,W,1).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from seg2eye_tpu_torch.models.discriminator import MultiscaleDiscriminator
from seg2eye_tpu_torch.models.encoder import ConvEncoder
from seg2eye_tpu_torch.models.generator import SpadeStyleGenerator
from seg2eye_tpu_torch.models.layers import (BatchSubNorm, SpectralConv,
                                             at_least_f32)
from seg2eye_tpu_torch.models.vgg import VGG19Features, to_rgb
from seg2eye_tpu_torch.ops import losses as L
from seg2eye_tpu_torch.ops import metrics
from seg2eye_tpu_torch.ops.image import one_hot_label
from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.utils.precision import full_float32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_networks(opt) -> Dict[str, torch.nn.Module]:
    """Generator and encoder for ``opt``, and the discriminator (and, with
    the VGG loss on, the frozen VGG19) when ``opt.isTrain``, on the CPU,
    with placeholder weights: load a checkpoint or run
    ``utils.weights.init_networks``."""
    if opt.netG != "spadestyle" or opt.netE != "conv":
        raise ValueError(f"unknown netG/netE '{opt.netG}'/'{opt.netE}'")
    gen = SpadeStyleGenerator(
        ngf=opt.ngf, output_nc=opt.output_nc, semantic_nc=opt.semantic_nc,
        crop_size=opt.crop_size, aspect_ratio=opt.aspect_ratio,
        num_upsampling_layers=opt.num_upsampling_layers, norm_g=opt.norm_G,
        w_dim=opt.w_dim)
    enc = ConvEncoder(ngf=opt.ngf, w_dim=opt.w_dim, crop_size=opt.crop_size,
                      norm_e=opt.norm_E, input_nc=opt.input_nc)
    nets = {"G": gen, "E": enc}
    if opt.isTrain:
        if opt.netD != "multiscale" or opt.netD_subarch != "n_layer":
            raise ValueError(f"unknown netD '{opt.netD}/{opt.netD_subarch}'")
        nets["D"] = MultiscaleDiscriminator(
            opt.semantic_nc + opt.output_nc, ndf=opt.ndf,
            n_layers=opt.n_layers_D, num_d=opt.num_D, norm_d=opt.norm_D,
            get_intermediate_features=not opt.no_ganFeat_loss)
        if not opt.no_vgg_loss:
            nets["VGG"] = VGG19Features()
    return nets


class Pix2Pix:
    """The networks of one configuration, on one device."""

    def __init__(self, opt, nets: Dict[str, torch.nn.Module],
                 device: str | torch.device = "cuda"):
        if opt.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {opt.compute_dtype!r} is not "
                             f"one of {sorted(_DTYPES)}")
        self.opt = opt
        self.device = torch.device(device)
        self.dtype = _DTYPES[opt.compute_dtype]
        self.netG = nets["G"].to(self.device)
        self.netE = nets["E"].to(self.device)
        self.netD = nets["D"].to(self.device) if "D" in nets else None
        self.netVGG = nets["VGG"].to(self.device) if "VGG" in nets else None

    def preprocess(self, batch: Dict
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
        """-> (seg (B,H,W,S), style (B,k,H,W,1), target (B,H,W,1) or None)
        on the device, in the compute dtype."""
        def norm(x):
            x = torch.as_tensor(x).to(self.device)
            if x.dtype == torch.uint8:
                x = (x.to(torch.float32) / 255.0 - 0.5) / 0.5
            return x.to(self.dtype)

        label = torch.as_tensor(batch["label"]).to(self.device)
        seg = one_hot_label(label, self.opt.semantic_nc).to(self.dtype)
        target = batch.get("target")
        return (seg, norm(batch["style_image"]),
                None if target is None else norm(target))

    def _aggregate(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.opt.style_aggr_method == "mean":
            return t.mean(dim)
        if self.opt.style_aggr_method == "max":
            return t.amax(dim)
        raise ValueError(self.opt.style_aggr_method)

    def encode_w(self, style: torch.Tensor, update_stats: bool = False,
                 bands=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """style (B,k,H,W,1) -> (w (B,w_dim), aggregated NCHW features).
        Outside training a batch sub-norm uses batch statistics, or the
        running ones under ``opt.eval_use_running_stats``, and updates
        nothing.  ``bands``: the encoder computes in H bands
        (``ConvEncoder.forward``; the features are then bands)."""
        b, k = style.shape[:2]
        running = self.opt.eval_use_running_stats and not update_stats
        world = dp.world_size()
        if self.opt.per_sample_encode_enabled and b * world > 1:
            if update_stats and world > 1:
                outs = self._encode_samples_replayed(style, world)
            else:
                with dp.local():     # statistics of each sample's own k
                    outs = [self.netE(style[i].permute(0, 3, 1, 2),
                                      update_stats, running, bands)
                            for i in range(b)]
            mu = torch.stack([out[0] for out in outs])
            feats = [torch.stack(f) for f in zip(*(out[2] for out in outs))]
        else:
            flat = style.reshape(b * k, *style.shape[2:]).permute(0, 3, 1, 2)
            mu, _, feats = self.netE(flat, update_stats, running, bands)
            mu = mu.reshape(b, k, -1)
            feats = [f.reshape(b, k, *f.shape[1:]) for f in feats]
        return (self._aggregate(mu, 1),
                [self._aggregate(f, 1) for f in feats])

    def _encode_samples_replayed(self, style: torch.Tensor, world: int):
        """Training per-sample encoding of this rank's samples of a global
        batch, as the one-process run encodes the whole batch in order:
        global sample j runs with every spectral u iterated j + 1 times,
        so rank r first iterates them r b times and, after its b samples,
        on to N b; each sample's batch sub-norms use its own statistics,
        and every sample's running update is replayed on every rank in
        global order (each rank's (mean, variance) rows gathered).  On a
        data x model grid r and N are the data index and degree: the model
        ranks of one data index encode the same samples, whole and equal
        on each, so their sharded spectral convs issue the same
        model-group collectives in the same order and their logged
        statistics are equal; the rows are gathered over the data group."""
        b = style.shape[0]
        r = dp.rank()
        convs = [m for m in self.netE.modules()
                 if isinstance(m, SpectralConv) and m.spectral]
        norms = [m for m in self.netE.modules()
                 if isinstance(m, BatchSubNorm)]

        @torch.no_grad()
        def power_iterations(n):
            for _ in range(n):
                for conv in convs:
                    conv.kernel(update_stats=True)

        power_iterations(r * b)
        for norm in norms:
            norm.stats_log = []
        try:
            with dp.local():
                outs = [self.netE(style[i].permute(0, 3, 1, 2), True)
                        for i in range(b)]
            logs = [norm.stats_log for norm in norms]
        finally:
            for norm in norms:
                norm.stats_log = None
        power_iterations((world - 1 - r) * b)
        with torch.no_grad():
            for norm, log in zip(norms, logs):
                means = dp.gather_rows(torch.stack([m for m, _ in log]))
                variances = dp.gather_rows(torch.stack([v for _, v in log]))
                m = norm.momentum
                for mean, var in zip(means, variances):
                    norm.running_mean.mul_(1 - m).add_(m * mean)
                    norm.running_var.mul_(1 - m).add_(m * var)
                norm.num_batches_tracked.add_(len(means))
        return outs

    def generate(self, seg: torch.Tensor, w: torch.Tensor,
                 update_stats: bool = False, bands=None) -> torch.Tensor:
        """-> fake (B,H,W,output_nc) in the compute dtype.  A training
        forward (``update_stats``) always uses batch statistics.
        ``bands``: the generator computes in H bands and gathers the
        fake."""
        running = self.opt.eval_use_running_stats and not update_stats
        fake = self.netG(seg, at_least_f32(w), use_running_average=running,
                         update_stats=update_stats, remat=self.opt.remat,
                         bands=bands)
        return fake.permute(0, 2, 3, 1)

    def discriminate(self, seg: torch.Tensor, fake: torch.Tensor,
                     real: torch.Tensor):
        """A training forward of D on [all fake | all real] -> (pred_fake,
        pred_real), each a list per scale of NCHW stage outputs."""
        both = torch.cat([torch.cat([seg, fake], -1),
                          torch.cat([seg, real], -1)], 0)
        out = self.netD(both.permute(0, 3, 1, 2), update_stats=True)
        half = fake.shape[0]
        pred_fake = [[t[:half] for t in scale] for scale in out]
        pred_real = [[t[half:] for t in scale] for scale in out]
        return pred_fake, pred_real

    # ------------------------------------------------------------------ #
    def generator_loss(self, batch: Dict
                       ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """One training forward of E, G and D -> (total, loss dict with the
        raw side channel, fake)."""
        opt = self.opt
        seg, style, target = self.preprocess(batch)
        w_real, feats_real = self.encode_w(style, update_stats=True)
        fake = self.generate(seg, w_real, update_stats=True)
        pred_fake, pred_real = self.discriminate(seg, fake, target)

        losses: Dict[str, torch.Tensor] = {}
        raw: Dict[str, torch.Tensor] = {}
        losses["GAN"] = L.gan_loss(pred_fake, True, for_discriminator=False,
                                   mode=opt.gan_mode)
        if opt.lambda_l2:
            l2 = L.l2_loss(fake, target)
            losses["L2/weighted"] = l2 * opt.lambda_l2
            raw["L2/raw"] = l2
        if opt.lambda_l1:
            l1 = L.l1_loss(fake, target)
            losses["L1/weighted"] = l1 * opt.lambda_l1
            raw["L1/raw"] = l1
        if opt.lambda_openeds:
            eds = torch.mean(metrics.mse_for_tensors(at_least_f32(fake),
                                                     at_least_f32(target)))
            losses["openeds/weighted"] = eds * opt.lambda_openeds
            raw["openeds/raw"] = eds

        if opt.lambda_style_feat or opt.lambda_style_w or opt.lambda_gram:
            w_fake, feats_fake = self.encode_w(fake[:, None],
                                               update_stats=True)
            if opt.lambda_style_w > 0:
                sw = L.l2_loss(w_fake, w_real)
                losses["style_w/weighted"] = sw * opt.lambda_style_w
                raw["style_w/raw"] = sw
            if opt.lambda_style_feat > 0:
                sf = L.multi_feature_mse(feats_fake, feats_real)
                losses["style_feat/weighted"] = sf * opt.lambda_style_feat
                raw["style_feat/raw"] = sf
            if opt.lambda_gram > 0:
                gl = L.multi_gram_loss(feats_fake, feats_real)
                losses["gram/weighted"] = gl * opt.lambda_gram
                raw["gram/raw"] = gl

        if not opt.no_ganFeat_loss:
            losses["GAN_Feat"] = L.feature_matching_loss(
                pred_fake, pred_real, opt.lambda_feat)
        if not opt.no_vgg_loss:
            vl = self.vgg_loss(fake, target)
            losses["VGG/weighted"] = vl * opt.lambda_vgg
            raw["VGG/raw"] = vl
        total = sum(torch.mean(v) for v in losses.values())
        return total, {**losses, **raw}, fake

    def vgg_loss(self, fake: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        """The perceptual loss of fake against target (B,H,W,C): one
        interleaved 2B VGG19 batch in the compute dtype."""
        if self.netVGG is None:
            raise ValueError("the VGG loss needs the VGG19 network: build "
                             "the networks with opt.isTrain and the VGG "
                             "loss on")
        pair = torch.stack([to_rgb(fake), to_rgb(target)], 1)
        x = pair.reshape(-1, *pair.shape[2:]).to(self.dtype)
        feats = self.netVGG(x.permute(0, 3, 1, 2))
        halves = [f.reshape(-1, 2, *f.shape[1:]) for f in feats]
        return L.vgg_loss([f[:, 0] for f in halves],
                          [f[:, 1] for f in halves])

    def discriminator_loss(self, batch: Dict, fake: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict]:
        """One training forward of D on the detached ``fake`` and the real
        target -> (total, loss dict)."""
        seg, _, target = self.preprocess(batch)
        pred_fake, pred_real = self.discriminate(seg, fake.detach(), target)
        losses = {
            "D/Fake": L.gan_loss(pred_fake, False, for_discriminator=True,
                                 mode=self.opt.gan_mode),
            "D/real": L.gan_loss(pred_real, True, for_discriminator=True,
                                 mode=self.opt.gan_mode),
        }
        return sum(torch.mean(v) for v in losses.values()), losses

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def inference(self, batch: Dict,
                  latent_style: Optional[torch.Tensor] = None,
                  bands=None) -> torch.Tensor:
        """Encode the style references (unless ``latent_style`` is given)
        and generate -> (B,H,W,1) float32.  ``bands``
        (``parallel.spatial.Bands``, ``--spatial_shard``): every rank of
        its group holds the whole batch and computes H bands of each map;
        the fake is whole on every rank (JAX's ``constrain=``)."""
        with full_float32(self.dtype == torch.float32):
            seg, style, _ = self.preprocess(batch)
            if latent_style is None:
                latent_style, _ = self.encode_w(style, bands=bands)
            latent_style = torch.as_tensor(latent_style, device=self.device)
            return self.generate(seg, latent_style,
                                 bands=bands).to(torch.float32)

    @torch.no_grad()
    def encode_only(self, batch: Dict) -> torch.Tensor:
        with full_float32(self.dtype == torch.float32):
            _, style, _ = self.preprocess(batch)
            return self.encode_w(style)[0]
