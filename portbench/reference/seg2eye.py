"""Plain reference of Seg2Eye (SPADE+Style generator, conv style encoder,
multiscale PatchGAN discriminator, hinge GAN with feature matching, TTUR
Adam), written from mcbuehler/Seg2Eye's models and options.

Functional: every network is a dict of tensors under the port's state-dict
keys (which are the reference's), so the same seeded dict is loaded into
the port and handed here.  Activations are NCHW float32; products follow
``common.Products``; each norm site is the plain SPADE+Style math:

    actv  = relu(conv3x3(seg, ws) + bs)
    gamma = conv3x3(actv, wg) + bg,  beta = conv3x3(actv, wb) + bb
    out   = (norm(x) * (1 + gamma) + beta + x * (s0 + 1) + s1) / 2

with batch statistics over (N, H, W) (biased), the running ones updated
(momentum 0.1, unbiased variance) on a training forward.  A training
forward also runs one power iteration of every spectral conv it uses.

Only the configuration the benchmark runs is written out (norm_G
spectralspadebatch3x3, norm_E and norm_D spectralinstance, 'normal'
upsampling, mean aggregation, hinge loss, feature matching, no VGG).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import Products, Spec, fan_in_std

EPS = 1e-5
NHIDDEN = 128
ENC_SIZE = 256
BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2",
          "up_3")


def _check(cfg: Dict) -> None:
    want = {"norm_G": "spectralspadebatch3x3", "norm_E": "spectralinstance",
            "norm_D": "spectralinstance", "num_upsampling_layers": "normal",
            "style_aggr_method": "mean", "gan_mode": "hinge",
            "no_ganFeat_loss": False, "no_vgg_loss": True}
    for k, v in want.items():
        if cfg[k] != v:
            raise ValueError(f"the reference implements {k}={v!r}, "
                             f"not {cfg[k]!r}")


def image_hw(cfg: Dict) -> Tuple[int, int]:
    return round(cfg["crop_size"] / cfg["aspect_ratio"]), cfg["crop_size"]


# ----------------------------------------------------------------- specs
def _conv(name, cout, cin, k, bias=True, spectral=False) -> List[Spec]:
    shape = (cout, cin, k, k)
    std = fan_in_std(shape)
    if not spectral:
        out = [Spec(name + ".weight", shape, "normal", std)]
        return out + ([Spec(name + ".bias", (cout,), "zeros")] if bias else [])
    out = [Spec(name + ".weight_orig", shape, "normal", std)]
    if bias:
        out.append(Spec(name + ".bias", (cout,), "zeros"))
    return out + [Spec(name + ".weight_u", (cout,), "u"),
                  Spec(name + ".weight_v", (cin * k * k,), "v", of=name)]


def _linear(name, cout, cin) -> List[Spec]:
    return [Spec(name + ".weight", (cout, cin), "normal",
                 fan_in_std((cout, cin))),
            Spec(name + ".bias", (cout,), "zeros")]


def _site(name, c, s, w_dim) -> List[Spec]:
    p = name + ".spade."
    return ([Spec(p + "param_free_norm.running_mean", (c,), "zeros"),
             Spec(p + "param_free_norm.running_var", (c,), "ones"),
             Spec(p + "param_free_norm.num_batches_tracked", (), "count")]
            + _conv(p + "mlp_shared.0", NHIDDEN, s, 3)
            + _conv(p + "mlp_gamma", c, NHIDDEN, 3)
            + _conv(p + "mlp_beta", c, NHIDDEN, 3)
            + _linear(name + ".adain.linear", 2 * c, w_dim))


def _block_widths(ngf: int):
    nf = ngf
    return dict(zip(BLOCKS, ((16 * nf, 16 * nf),) * 3 + (
        (16 * nf, 8 * nf), (8 * nf, 4 * nf), (4 * nf, 2 * nf),
        (2 * nf, nf))))


def site_shapes(cfg: Dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(N, H, W, C) of every norm site of one generator forward, in order:
    per block norm_s (with a learned shortcut), norm_0, norm_1."""
    sw = cfg["crop_size"] // 2 ** 5
    h = round(sw / cfg["aspect_ratio"])
    scale = {"head_0": 1, "G_middle_0": 2, "G_middle_1": 2, "up_0": 4,
             "up_1": 8, "up_2": 16, "up_3": 32}
    out = []
    for name, (fin, fout) in _block_widths(cfg["ngf"]).items():
        r = scale[name]
        cs = ([fin] if fin != fout else []) + [fin, min(fin, fout)]
        out += [(batch, h * r, sw * r, c) for c in cs]
    return out


def generator_specs(cfg: Dict) -> List[Spec]:
    nf, s, wd = cfg["ngf"], cfg["label_nc"], cfg["w_dim"]
    out = _conv("fc", 16 * nf, s, 3)
    for name, (fin, fout) in _block_widths(nf).items():
        mid = min(fin, fout)
        out += _conv(name + ".conv_0", mid, fin, 3, spectral=True)
        out += _conv(name + ".conv_1", fout, mid, 3, spectral=True)
        out += _site(name + ".norm_0", fin, s, wd)
        out += _site(name + ".norm_1", mid, s, wd)
        if fin != fout:
            out += _conv(name + ".conv_s", fout, fin, 1, bias=False,
                         spectral=True)
            out += _site(name + ".norm_s", fin, s, wd)
    return out + _conv("conv_img", cfg["output_nc"], nf, 3)


def _encoder_widths(cfg: Dict) -> List[int]:
    """Six stride-2 layers, five below crop 256; the input is resized to
    256 x 256 either way."""
    ngf = cfg["ngf"]
    return [ngf, 2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf] + (
        [8 * ngf] if cfg["crop_size"] >= 256 else [])


def encoder_specs(cfg: Dict) -> List[Spec]:
    out, fin = [], cfg["input_nc"]
    widths = _encoder_widths(cfg)
    for i, fout in enumerate(widths):
        out += _conv(f"layer{i}.0", fout, fin, 3, bias=False, spectral=True)
        fin = fout
    grid = ENC_SIZE // 2 ** len(widths)
    return (out + _linear("fc_mu", cfg["w_dim"], fin * grid * grid)
            + _linear("fc_var", cfg["w_dim"], fin * grid * grid))


def discriminator_specs(cfg: Dict) -> List[Spec]:
    out = []
    cin, ndf, n_layers = cfg["label_nc"] + cfg["output_nc"], cfg["ndf"], \
        cfg["n_layers_D"]
    for i in range(cfg["num_D"]):
        p = f"discriminator_{i}."
        out += _conv(p + "model0.0", ndf, cin, 4)
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            out += _conv(p + f"model{n}.0.0", nf, nf_prev, 4, bias=False,
                         spectral=True)
        out += _conv(p + f"model{n_layers}.0", 1, nf, 4)
    return out


def specs(cfg: Dict, train: bool) -> Dict[str, List[Spec]]:
    _check(cfg)
    out = {"G": generator_specs(cfg), "E": encoder_specs(cfg)}
    if train:
        out["D"] = discriminator_specs(cfg)
    return out


# ----------------------------------------------------------------- nets
def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + 1e-12)


def spectral_weight(sd: Dict, name: str, update: bool) -> torch.Tensor:
    """W / sigma with the stored (u, v); a training forward first runs one
    power iteration, v = normalize(W^T u), u = normalize(W v)."""
    w = sd[name + ".weight_orig"]
    mat = w.reshape(w.shape[0], -1)
    if update:
        with torch.no_grad():
            v = _l2n(mat.T @ sd[name + ".weight_u"])
            sd[name + ".weight_u"] = _l2n(mat @ v)
            sd[name + ".weight_v"] = v
    sigma = torch.dot(sd[name + ".weight_u"], mat @ sd[name + ".weight_v"])
    return w / sigma


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def instance_norm(x):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + EPS)


class Nets:
    """One configuration's networks over their state dicts (``sd``: net
    name -> {key: tensor}), computing with ``prod``'s products."""

    def __init__(self, cfg: Dict, sd: Dict[str, Dict[str, torch.Tensor]],
                 prod: Products = Products()):
        _check(cfg)
        self.cfg, self.sd, self.p = cfg, sd, prod

    # ---- generator
    def _site(self, name, x, seg, w, update):
        g, p = self.sd["G"], name + ".spade."
        s = self.p.linear(w, g[name + ".adain.linear.weight"],
                          g[name + ".adain.linear.bias"])
        s = _lrelu(s)
        c = x.shape[1]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        if update:
            with torch.no_grad():
                n = x.numel() // c
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
        adain = x * (s[:, :c, None, None] + 1.0) + s[:, c:, None, None]
        return (normalized * (1.0 + gamma) + beta + adain) * 0.5

    def _block(self, name, x, seg, w, update):
        g = self.sd["G"]
        shortcut = name + ".conv_s.weight_orig" in g
        k0 = spectral_weight(g, name + ".conv_0", update)
        k1 = spectral_weight(g, name + ".conv_1", update)
        ks = spectral_weight(g, name + ".conv_s", update) if shortcut else None
        x_s = (self.p.conv(self._site(name + ".norm_s", x, seg, w, update), ks)
               if shortcut else x)
        dx = self.p.conv(_lrelu(self._site(name + ".norm_0", x, seg, w,
                                           update)),
                         k0, g[name + ".conv_0.bias"], padding=1)
        dx = self.p.conv(_lrelu(self._site(name + ".norm_1", dx, seg, w,
                                           update)),
                         k1, g[name + ".conv_1.bias"], padding=1)
        return x_s + dx

    def generate(self, seg: torch.Tensor, w: torch.Tensor,
                 update: bool) -> torch.Tensor:
        """seg (B,S,H,W) one-hot, w (B,w_dim) -> fake (B,1,H,W) in [-1,1]."""
        g = self.sd["G"]
        sw = self.cfg["crop_size"] // 2 ** 5
        h = round(sw / self.cfg["aspect_ratio"])
        pyramid = {}

        def seg_at(hh, ww):
            if (hh, ww) not in pyramid:
                pyramid[(hh, ww)] = F.interpolate(seg, size=(hh, ww),
                                                  mode="nearest")
            return pyramid[(hh, ww)]

        def run(name, x):
            return self._block(name, x, seg_at(*x.shape[2:]), w, update)

        def up(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        x = self.p.conv(seg_at(h, sw), g["fc.weight"], g["fc.bias"], padding=1)
        x = run("head_0", x)
        x = run("G_middle_0", up(x))
        x = run("G_middle_1", x)
        for name in ("up_0", "up_1", "up_2", "up_3"):
            x = run(name, up(x))
        x = self.p.conv(_lrelu(x), g["conv_img.weight"], g["conv_img.bias"],
                        padding=1)
        return torch.tanh(x)

    # ---- encoder
    def encode(self, x: torch.Tensor, update: bool):
        """x (N,1,H,W) in [-1,1] -> (mu (N,w_dim), the feature maps)."""
        e = self.sd["E"]
        if x.shape[2:] != (ENC_SIZE, ENC_SIZE):
            x = F.interpolate(x, size=(ENC_SIZE, ENC_SIZE), mode="bilinear",
                              align_corners=False)
        feats = []
        for i in range(len(_encoder_widths(self.cfg))):
            x = self.p.conv(x, spectral_weight(e, f"layer{i}.0", update),
                            stride=2, padding=1)
            x = instance_norm(x)
            feats.append(x)
        out = _lrelu(x).reshape(x.shape[0], -1)
        return self.p.linear(out, e["fc_mu.weight"], e["fc_mu.bias"]), feats

    def encode_w(self, style: torch.Tensor, update: bool):
        """style (B,k,1,H,W) -> (w (B,w_dim), features averaged over k)."""
        b, k = style.shape[:2]
        mu, feats = self.encode(style.reshape(b * k, *style.shape[2:]), update)
        return (mu.reshape(b, k, -1).mean(1),
                [f.reshape(b, k, *f.shape[1:]).mean(1) for f in feats])

    # ---- discriminator
    def discriminate(self, x: torch.Tensor, update: bool):
        """x (N,S+1,H,W) -> per scale, the five stage outputs."""
        d, n_layers = self.sd["D"], self.cfg["n_layers_D"]
        result = []
        for i in range(self.cfg["num_D"]):
            p = f"discriminator_{i}."
            h = _lrelu(self.p.conv(x, d[p + "model0.0.weight"],
                                   d[p + "model0.0.bias"], 2, 2))
            stages = [h]
            for n in range(1, n_layers):
                stride = 1 if n == n_layers - 1 else 2
                kern = spectral_weight(d, p + f"model{n}.0.0", update)
                h = _lrelu(instance_norm(self.p.conv(h, kern, None, stride,
                                                     2)))
                stages.append(h)
            last = p + f"model{n_layers}.0"
            stages.append(self.p.conv(h, d[last + ".weight"],
                                      d[last + ".bias"], 1, 2))
            result.append(stages)
            if i != self.cfg["num_D"] - 1:
                x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return result


# ----------------------------------------------------------------- batches
def preprocess(cfg: Dict, batch: Dict, device) -> Tuple:
    """uint8 host batch -> (seg one-hot (B,S,H,W), style (B,k,1,H,W),
    target (B,1,H,W) or None), float32 in [-1,1]."""
    def norm(a):
        t = torch.as_tensor(a).to(device).to(torch.float32)
        return (t / 255.0 - 0.5) / 0.5

    label = torch.as_tensor(batch["label"]).to(device).long()
    seg = F.one_hot(label, cfg["label_nc"]).to(torch.float32)
    style = norm(batch["style_image"]).permute(0, 1, 4, 2, 3)
    target = batch.get("target")
    return (seg.permute(0, 3, 1, 2), style,
            None if target is None else norm(target).permute(0, 3, 1, 2))


def _hinge_d(logits, real: bool):
    return -torch.mean(torch.clamp_max((logits if real else -logits) - 1.0,
                                       0.0))


def generator_losses(cfg, pred_fake, pred_real) -> Dict[str, torch.Tensor]:
    num_d = len(pred_fake)
    gan = sum(-torch.mean(s[-1]) for s in pred_fake) / num_d
    feat = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            feat = feat + torch.mean(torch.abs(
                pred_fake[i][j] - pred_real[i][j].detach())) * (
                    cfg["lambda_feat"] / num_d)
    return {"GAN": gan, "GAN_Feat": feat}


def discriminator_losses(pred_fake, pred_real) -> Dict[str, torch.Tensor]:
    num_d = len(pred_fake)
    return {"D/Fake": sum(_hinge_d(s[-1], False) for s in pred_fake) / num_d,
            "D/real": sum(_hinge_d(s[-1], True) for s in pred_real) / num_d}


# ----------------------------------------------------------------- training
class Adam:
    """torch.optim.Adam's update, written out (no weight decay)."""

    def __init__(self, names: List[str], lr: float, betas, eps: float = 1e-8):
        self.names, self.lr, self.betas, self.eps = names, lr, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        for name in self.names:
            g = grads.get(name)
            if g is None:
                continue
            t = self.t[name] = self.t.get(name, 0) + 1
            m = self.m[name] = b1 * self.m.get(name, torch.zeros_like(g)) \
                + (1 - b1) * g
            v = self.v[name] = b2 * self.v.get(name, torch.zeros_like(g)) \
                + (1 - b2) * g * g
            denom = (v.sqrt() / (1 - b2 ** t) ** 0.5) + self.eps
            params[name] -= self.lr / (1 - b1 ** t) * m / denom


def trained_keys(sd: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in sd if k.rsplit(".", 1)[-1] in
            ("weight_orig", "weight", "bias")]


class Trainer:
    """The reference iteration: the G step (E, G, D forward; D frozen;
    G+E Adam at lr / 2), then the D step with the fake regenerated by the
    updated G and E (D Adam at 2 lr); TTUR betas (0, 0.9)."""

    def __init__(self, cfg: Dict, sd: Dict, prod: Products = Products()):
        self.nets = Nets(cfg, sd, prod)
        self.cfg = cfg
        betas = (0.0, 0.9)
        self.ge = [("G", k) for k in trained_keys(sd["G"])] + \
            [("E", k) for k in trained_keys(sd["E"])]
        self.d = [("D", k) for k in trained_keys(sd["D"])]
        self.opt_g = Adam(self.ge, cfg["lr"] / 2, betas)
        self.opt_d = Adam(self.d, cfg["lr"] * 2, betas)

    def _leaves(self, keys):
        return {nk: self.nets.sd[nk[0]][nk[1]] for nk in keys}

    def step(self, batch: Dict, device) -> Tuple[Dict, Dict]:
        """-> (losses, {(net, key): gradient as the optimizer got it})."""
        nets, sd = self.nets, self.nets.sd
        seg, style, target = preprocess(self.cfg, batch, device)
        for nk in self.ge:
            sd[nk[0]][nk[1]].requires_grad_(True)
        w, _ = nets.encode_w(style, True)
        fake = nets.generate(seg, w, True)
        pf, pr = self._split(nets.discriminate(_pair(seg, fake, target), True),
                             fake.shape[0])
        g_losses = generator_losses(self.cfg, pf, pr)
        total = sum(g_losses.values())
        leaves = self._leaves(self.ge)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        g_grads = {nk: g for nk, g in zip(leaves, grads) if g is not None}
        for t in leaves.values():
            t.requires_grad_(False)
        self.opt_g.step(_Params(sd), g_grads)

        with torch.no_grad():
            w, _ = nets.encode_w(style, True)
            fake = nets.generate(seg, w, True)
        for nk in self.d:
            sd[nk[0]][nk[1]].requires_grad_(True)
        pf, pr = self._split(nets.discriminate(_pair(seg, fake, target), True),
                             fake.shape[0])
        d_losses = discriminator_losses(pf, pr)
        leaves = self._leaves(self.d)
        grads = torch.autograd.grad(sum(d_losses.values()),
                                    list(leaves.values()), allow_unused=True)
        d_grads = {nk: g for nk, g in zip(leaves, grads) if g is not None}
        for t in leaves.values():
            t.requires_grad_(False)
        self.opt_d.step(_Params(sd), d_grads)
        losses = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        return losses, {**g_grads, **d_grads}

    @staticmethod
    def _split(out, half):
        return ([[t[:half] for t in s] for s in out],
                [[t[half:] for t in s] for s in out])


def _pair(seg, fake, target):
    """D's 2B batch, [all fake | all real], each beside its seg map."""
    return torch.cat([torch.cat([seg, fake], 1), torch.cat([seg, target], 1)])


class _Params:
    """(net, key) indexing into the nested state dicts, for ``Adam.step``."""

    def __init__(self, sd):
        self.sd = sd

    def __getitem__(self, nk):
        return self.sd[nk[0]][nk[1]]

    def __setitem__(self, nk, value):
        self.sd[nk[0]][nk[1]] = value


# ----------------------------------------------------------------- scoring
def to_255(x):
    return torch.trunc((x + 1.0) * 255.0 / 2.0)


@torch.no_grad()
def score(nets: Nets, batch: Dict, device, native_hw=(640, 400)):
    """The Tester's scored inference: encode (stored u/v), generate with
    batch statistics, bilinear resize to ``native_hw``, truncation to
    [0,255], per-image sqrt(SSE) / (H*W) against ``target_original``.
    -> (fake (B,H,W,1), errors (B,))."""
    seg, style, _ = preprocess(nets.cfg, batch, device)
    w, _ = nets.encode_w(style, False)
    fake = nets.generate(seg, w, False)
    resized = to_255(F.interpolate(fake, size=native_hw, mode="bilinear",
                                   align_corners=False))
    target = torch.as_tensor(batch["target_original"]).to(device).to(
        torch.float32).permute(0, 3, 1, 2)
    sse = ((resized - target) ** 2).reshape(fake.shape[0], -1).sum(-1)
    errors = torch.sqrt(sse) / (native_hw[0] * native_hw[1])
    return fake.permute(0, 2, 3, 1), errors
