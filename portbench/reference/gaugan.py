"""Plain reference of GauGAN (Park, Liu, Wang and Zhu, "Semantic Image
Synthesis with Spatially-Adaptive Normalization", CVPR 2019,
arXiv:1903.07291), written from NVlabs/SPADE's ``models/networks/
{generator,architecture,normalization,discriminator,loss}.py``,
``models/pix2pix_model.py`` and its options: the SPADE generator without
the VAE, the multiscale PatchGAN discriminator, VGG19 up to relu5_1, the
hinge GAN loss with feature matching and the VGG loss, TTUR Adam.

Functional, as ``reference.seg2eye``: every network is a dict of tensors
under the port's state-dict keys (which are NVlabs/SPADE's), float32 NCHW
activations, products through ``common.Products``.  Each norm site is plain
SPADE:

    actv  = relu(conv3x3(seg, ws) + bs)
    gamma = conv3x3(actv, wg) + bg,  beta = conv3x3(actv, wb) + bb
    out   = norm(x) * (1 + gamma) + beta

with batch statistics over (N, H, W) (biased), the running ones updated
(momentum 0.1, unbiased variance) on a training forward, and one power
iteration of every spectral conv a training forward uses.  The resnet
block, the discriminator, the spectral weights, instance norm, the
feature-matching loss and Adam are ``reference.seg2eye``'s.

Departures from NVlabs/SPADE, each also the port's:

  * 'syncbatch' is the batch statistics of the whole batch: one card holds
    the whole batch, which a synchronized BN pools over its GPUs;
  * weights are drawn from the seed (``specs``), VGG19 at torchvision's
    init (kaiming normal, fan_out), not ImageNet's weights, which are not
    in the repository;
  * batches come from the seed: no loader, no flip or crop; instance maps
    are uint8 ids (the edges read only their inequality);
  * fake and real run through VGG19 as two batches here and as one
    interleaved batch in the port: the same arithmetic per image.

Only the configuration the benchmark runs is written out (norm_G
spectralspadesyncbatch3x3, norm_D spectralinstance, 'more' upsampling
('normal' too, for the tests' small maps), hinge loss, feature matching,
the VGG loss, no VAE).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import seg2eye as s2e
from portbench.reference.common import Products, Spec
from portbench.reference.seg2eye import (Adam, EPS, NHIDDEN, _Params, _conv,
                                         _pair, discriminator_losses,
                                         generator_losses, trained_keys)

BLOCKS = s2e.BLOCKS
N_UP = {"normal": 5, "more": 6}
# torchvision vgg19.features convs (index, in, out) per slice, "M" a 2x2
# max pool; each slice ends after the ReLU of conv{1..5}_1
VGG_BLOCKS = (
    ((0, 3, 64),),
    ((2, 64, 64), "M", (5, 64, 128)),
    ((7, 128, 128), "M", (10, 128, 256)),
    ((12, 256, 256), (14, 256, 256), (16, 256, 256), "M", (19, 256, 512)),
    ((21, 512, 512), (23, 512, 512), (25, 512, 512), "M", (28, 512, 512)),
)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def _check(cfg: Dict) -> None:
    want = {"netG": "spade", "norm_G": "spectralspadesyncbatch3x3",
            "norm_D": "spectralinstance", "gan_mode": "hinge",
            "no_ganFeat_loss": False, "no_vgg_loss": False, "no_TTUR": False}
    for k, v in want.items():
        if cfg[k] != v:
            raise ValueError(f"the reference implements {k}={v!r}, "
                             f"not {cfg[k]!r}")
    if cfg["num_upsampling_layers"] not in N_UP:
        raise ValueError(f"the reference implements the upsampling "
                         f"schedules {sorted(N_UP)}")


def semantic_nc(cfg: Dict) -> int:
    """label_nc, + 1 with a don't-care label, + 1 with instance edges."""
    return (cfg["label_nc"] + int(cfg["contain_dontcare_label"])
            + int(not cfg["no_instance"]))


def latent_hw(cfg: Dict) -> Tuple[int, int]:
    sw = cfg["crop_size"] // 2 ** N_UP[cfg["num_upsampling_layers"]]
    return round(sw / cfg["aspect_ratio"]), sw


def image_hw(cfg: Dict) -> Tuple[int, int]:
    return round(cfg["crop_size"] / cfg["aspect_ratio"]), cfg["crop_size"]


# ----------------------------------------------------------------- specs
def _site(name, c, s) -> List[Spec]:
    """SPADE's own names: the norm module holds the parameters."""
    p = name + "."
    return ([Spec(p + "param_free_norm.running_mean", (c,), "zeros"),
             Spec(p + "param_free_norm.running_var", (c,), "ones"),
             Spec(p + "param_free_norm.num_batches_tracked", (), "count")]
            + _conv(p + "mlp_shared.0", NHIDDEN, s, 3)
            + _conv(p + "mlp_gamma", c, NHIDDEN, 3)
            + _conv(p + "mlp_beta", c, NHIDDEN, 3))


def _scales(cfg: Dict) -> Dict[str, int]:
    """Each block's resolution over the latent's: 'more' upsamples again
    before G_middle_1."""
    mid = 4 if cfg["num_upsampling_layers"] == "more" else 2
    return {"head_0": 1, "G_middle_0": 2, "G_middle_1": mid,
            "up_0": 2 * mid, "up_1": 4 * mid, "up_2": 8 * mid,
            "up_3": 16 * mid}


def site_shapes(cfg: Dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(N, H, W, C) of every norm site of one generator forward, in order:
    per block norm_s (with a learned shortcut), norm_0, norm_1."""
    h, w = latent_hw(cfg)
    out = []
    for name, (fin, fout) in s2e._block_widths(cfg["ngf"]).items():
        r = _scales(cfg)[name]
        cs = ([fin] if fin != fout else []) + [fin, min(fin, fout)]
        out += [(batch, h * r, w * r, c) for c in cs]
    return out


def generator_specs(cfg: Dict) -> List[Spec]:
    nf, s = cfg["ngf"], semantic_nc(cfg)
    out = _conv("fc", 16 * nf, s, 3)
    for name, (fin, fout) in s2e._block_widths(nf).items():
        mid = min(fin, fout)
        out += _conv(name + ".conv_0", mid, fin, 3, spectral=True)
        out += _conv(name + ".conv_1", fout, mid, 3, spectral=True)
        out += _site(name + ".norm_0", fin, s)
        out += _site(name + ".norm_1", mid, s)
        if fin != fout:
            out += _conv(name + ".conv_s", fout, fin, 1, bias=False,
                         spectral=True)
            out += _site(name + ".norm_s", fin, s)
    return out + _conv("conv_img", cfg["output_nc"], nf, 3)


def discriminator_specs(cfg: Dict) -> List[Spec]:
    """``reference.seg2eye``'s, over the semantic channels and the image."""
    return s2e.discriminator_specs({**cfg, "label_nc": semantic_nc(cfg)})


def vgg_specs() -> List[Spec]:
    """torchvision's init: kaiming normal (fan_out, ReLU), zero bias."""
    out = []
    for block in VGG_BLOCKS:
        for step in block:
            if step != "M":
                idx, fin, fout = step
                out += [Spec(f"features.{idx}.weight", (fout, fin, 3, 3),
                             "normal", math.sqrt(2.0 / (fout * 9))),
                        Spec(f"features.{idx}.bias", (fout,), "zeros")]
    return out


def specs(cfg: Dict) -> Dict[str, List[Spec]]:
    _check(cfg)
    return {"G": generator_specs(cfg), "D": discriminator_specs(cfg),
            "VGG": vgg_specs()}


# ----------------------------------------------------------------- nets
class Nets(s2e.Nets):
    """GauGAN's networks over their state dicts; the resnet block and the
    discriminator are ``reference.seg2eye.Nets``', every norm site plain
    SPADE and no style code (``w`` is None)."""

    def __init__(self, cfg: Dict, sd: Dict[str, Dict[str, torch.Tensor]],
                 prod: Products = Products()):
        _check(cfg)
        self.cfg, self.sd, self.p = cfg, sd, prod

    def _site(self, name, x, seg, w, update):
        g, p = self.sd["G"], name + "."
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        if update:
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                rm, rv = (p + "param_free_norm.running_mean",
                          p + "param_free_norm.running_var")
                g[rm] = 0.9 * g[rm] + 0.1 * mean.detach()
                g[rv] = 0.9 * g[rv] + 0.1 * var.detach() * (n / (n - 1))
                nbt = p + "param_free_norm.num_batches_tracked"
                g[nbt] = g[nbt] + 1
        actv = torch.relu(self.p.conv(seg, g[p + "mlp_shared.0.weight"],
                                      g[p + "mlp_shared.0.bias"], padding=1))
        gamma = self.p.conv(actv, g[p + "mlp_gamma.weight"],
                            g[p + "mlp_gamma.bias"], padding=1)
        beta = self.p.conv(actv, g[p + "mlp_beta.weight"],
                           g[p + "mlp_beta.bias"], padding=1)
        normalized = (x - mean[None, :, None, None]) * torch.rsqrt(
            var[None, :, None, None] + EPS)
        return normalized * (1.0 + gamma) + beta

    def generate(self, seg: torch.Tensor, update: bool) -> torch.Tensor:
        """seg (B,S,H,W) -> fake (B,3,H,W) in [-1,1]."""
        g = self.sd["G"]
        h, w = latent_hw(self.cfg)
        pyramid = {}

        def seg_at(hh, ww):
            if (hh, ww) not in pyramid:
                pyramid[(hh, ww)] = F.interpolate(seg, size=(hh, ww),
                                                  mode="nearest")
            return pyramid[(hh, ww)]

        def run(name, x):
            return self._block(name, x, seg_at(*x.shape[2:]), None, update)

        def up(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        x = self.p.conv(seg_at(h, w), g["fc.weight"], g["fc.bias"], padding=1)
        x = run("head_0", x)
        x = run("G_middle_0", up(x))
        if self.cfg["num_upsampling_layers"] == "more":
            x = up(x)
        x = run("G_middle_1", x)
        for name in ("up_0", "up_1", "up_2", "up_3"):
            x = run(name, up(x))
        x = self.p.conv(F.leaky_relu(x, 0.2), g["conv_img.weight"],
                        g["conv_img.bias"], padding=1)
        return torch.tanh(x)

    def vgg(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N,3,H,W) in [-1,1] (no ImageNet normalisation, as SPADE's
        VGGLoss) -> relu1_1 .. relu5_1."""
        v, outs = self.sd["VGG"], []
        for block in VGG_BLOCKS:
            for step in block:
                if step == "M":
                    x = F.max_pool2d(x, 2, 2)
                else:
                    k = f"features.{step[0]}."
                    x = torch.relu(self.p.conv(x, v[k + "weight"],
                                               v[k + "bias"], padding=1))
            outs.append(x)
        return outs

    def vgg_loss(self, fake: torch.Tensor, real: torch.Tensor):
        """SPADE's VGGLoss: the weighted L1 of the five slices, the real
        features detached."""
        total = 0.0
        for wt, f, r in zip(VGG_WEIGHTS, self.vgg(fake), self.vgg(real)):
            total = total + wt * torch.mean(torch.abs(f - r.detach()))
        return total


# ----------------------------------------------------------------- batches
def get_edges(t: torch.Tensor) -> torch.Tensor:
    """NVlabs/SPADE ``pix2pix_model.get_edges``: (B,1,H,W) instance ids ->
    1.0 where a pixel differs from one of its 4 neighbours."""
    edge = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    edge[:, :, :, 1:] |= t[:, :, :, 1:] != t[:, :, :, :-1]
    edge[:, :, :, :-1] |= t[:, :, :, 1:] != t[:, :, :, :-1]
    edge[:, :, 1:, :] |= t[:, :, 1:, :] != t[:, :, :-1, :]
    edge[:, :, :-1, :] |= t[:, :, 1:, :] != t[:, :, :-1, :]
    return edge.float()


def preprocess(cfg: Dict, batch: Dict, device) -> Tuple:
    """uint8 host batch -> (input semantics (B,S,H,W): the one-hot label map
    then the instance edges; the real image (B,3,H,W) in [-1,1]), float32
    (``pix2pix_model.preprocess_input``)."""
    label = torch.as_tensor(batch["label"]).to(device).long()[:, None]
    b, _, h, w = label.shape
    nc = cfg["label_nc"] + int(cfg["contain_dontcare_label"])
    semantics = torch.zeros(b, nc, h, w, device=device).scatter_(1, label,
                                                                 1.0)
    if not cfg["no_instance"]:
        inst = torch.as_tensor(batch["instance"]).to(device)[:, None]
        semantics = torch.cat([semantics, get_edges(inst)], 1)
    image = torch.as_tensor(batch["target"]).to(device).to(torch.float32)
    image = ((image / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    return semantics, image


# ----------------------------------------------------------------- training
class Trainer:
    """The reference iteration: the G step (G and D forward, D frozen, the
    hinge, feature-matching and VGG losses, G Adam at lr / 2), then the D
    step with the fake regenerated by the updated G (D Adam at 2 lr); TTUR
    betas (0, 0.9)."""

    def __init__(self, cfg: Dict, sd: Dict, prod: Products = Products()):
        self.nets = Nets(cfg, sd, prod)
        self.cfg = cfg
        betas = (0.0, 0.9)
        self.g = [("G", k) for k in trained_keys(sd["G"])]
        self.d = [("D", k) for k in trained_keys(sd["D"])]
        self.opt_g = Adam(self.g, cfg["lr"] / 2, betas)
        self.opt_d = Adam(self.d, cfg["lr"] * 2, betas)

    def _grads(self, loss, keys):
        sd = self.nets.sd
        leaves = [sd[n][k] for n, k in keys]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        return {nk: g for nk, g in zip(keys, grads) if g is not None}

    def _discriminate(self, seg, fake, target):
        out = self.nets.discriminate(_pair(seg, fake, target), True)
        half = fake.shape[0]
        return ([[t[:half] for t in s] for s in out],
                [[t[half:] for t in s] for s in out])

    def step(self, batch: Dict, device) -> Tuple[Dict, Dict]:
        """-> (losses, {(net, key): gradient as the optimizer got it})."""
        nets, sd = self.nets, self.nets.sd
        seg, target = preprocess(self.cfg, batch, device)
        for n, k in self.g:
            sd[n][k].requires_grad_(True)
        fake = nets.generate(seg, True)
        pf, pr = self._discriminate(seg, fake, target)
        g_losses = generator_losses(self.cfg, pf, pr)
        g_losses["VGG"] = nets.vgg_loss(fake, target) * self.cfg["lambda_vgg"]
        g_grads = self._grads(sum(g_losses.values()), self.g)
        self.opt_g.step(_Params(sd), g_grads)

        with torch.no_grad():
            fake = nets.generate(seg, True)
        for n, k in self.d:
            sd[n][k].requires_grad_(True)
        d_losses = discriminator_losses(*self._discriminate(seg, fake,
                                                            target))
        d_grads = self._grads(sum(d_losses.values()), self.d)
        self.opt_d.step(_Params(sd), d_grads)
        losses = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        return losses, {**g_grads, **d_grads}
