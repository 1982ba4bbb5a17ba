"""Weights for the port's networks.

  * ``from_jax_variables``: the JAX package's variables (as numpy arrays)
    -> state_dicts that load into the port's modules with ``strict=True``.
    The layout work is the port's own copy of the generator, encoder,
    discriminator and VGG19 exports of ``seg2eye_tpu/utils/torch_export.py``:
    HWIO kernels -> OIHW,
    (in, out) linears -> (out, in), the encoder fc re-flattened from HWC
    to CHW, spectral ``weight_v`` in torch's (I, kh, kw) flatten order, BN
    statistics -> running_{mean,var}, a batch sub-norm's scale and bias ->
    the affine BatchNorm2d's weight and bias.
  * ``init_networks``: seeded random weights with the JAX package's init
    schemes, for runs without a checkpoint.
  * ``export_deeplab`` (the port's copy of the JAX package's, for the
    ResNet, Xception, DRN and MobileNet backbones) and
    ``deeplab_from_jax_variables``: DeepLab variables -> the reference's
    DeepLab state_dict, MobileNet's ``low_level_features``/
    ``high_level_features`` aliases included;
    ``export_{xception,drn}_backbone``: a backbone's variables -> the
    reference's backbone state_dict (what ``pretrained_backbone`` loads);
    ``init_deeplab``: a seeded DeepLab for a RefineNet configuration.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

from seg2eye_tpu_torch.models.deeplab import (RESNET_LAYERS, DeepLab,
                                              kaiming_init_)
from seg2eye_tpu_torch.models.layers import (BatchSubNorm, FCStyle,
                                             SpectralConv, weight_init)
from seg2eye_tpu_torch.models.pix2pix import build_networks
from seg2eye_tpu_torch.models.vgg import init_vgg19_


GEN_BLOCKS = ("head_0", "G_middle_0", "G_middle_1",
              "up_0", "up_1", "up_2", "up_3", "up_4")


def _f32(x):
    """To the checkpoint dtype: float32, except that float64 stays float64."""
    a = np.asarray(x)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _conv(k):
    """flax HWIO kernel -> torch OIHW weight."""
    return _f32(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _lin(w):
    return _f32(np.transpose(np.asarray(w), (1, 0)))


def _unperm_v(v, kernel_hwio):
    """Spectral v flattened in (kh, kw, I) order -> torch's (I, kh, kw)."""
    kh, kw, i, _ = kernel_hwio.shape
    return _f32(np.transpose(np.asarray(v).reshape(kh, kw, i),
                             (2, 0, 1)).reshape(-1))


def _bn(sd: Dict, torch_base: str, p_node, bs_node):
    """Affine BN: flax {scale,bias} + batch_stats {mean,var} -> the five
    torch BatchNorm2d keys."""
    sd[f"{torch_base}.weight"] = _f32(p_node["scale"])
    sd[f"{torch_base}.bias"] = _f32(p_node["bias"])
    _bn_stats(sd, torch_base, bs_node)


def _bn_stats(sd: Dict, torch_base: str, bs_node):
    sd[f"{torch_base}.running_mean"] = _f32(bs_node["mean"])
    sd[f"{torch_base}.running_var"] = _f32(bs_node["var"])
    sd[f"{torch_base}.num_batches_tracked"] = np.asarray(0, np.int64)


def _spectral(sd: Dict, torch_base: str, conv_p, conv_sp):
    """Spectral-normed conv: kernel -> weight_orig + power-iteration u/v;
    a conv without spectral state gets a plain ``weight``."""
    if conv_sp is None:
        sd[f"{torch_base}.weight"] = _conv(conv_p["kernel"])
        return
    sd[f"{torch_base}.weight_orig"] = _conv(conv_p["kernel"])
    sd[f"{torch_base}.weight_u"] = _f32(conv_sp["u"])
    sd[f"{torch_base}.weight_v"] = _unperm_v(conv_sp["v"],
                                             np.asarray(conv_p["kernel"]))


def export_generator(variables: Dict) -> Dict[str, np.ndarray]:
    """Generator variables -> the port's (and the reference's) generator
    state_dict, as numpy arrays."""
    p, sp = variables["params"], variables.get("spectral", {})
    bs = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    sd["fc.weight"] = _conv(p["fc"]["kernel"])
    sd["fc.bias"] = _f32(p["fc"]["bias"])
    sd["conv_img.weight"] = _conv(p["conv_img"]["kernel"])
    sd["conv_img.bias"] = _f32(p["conv_img"]["bias"])
    for blk in GEN_BLOCKS:
        if blk not in p:
            continue
        for conv in ("conv_0", "conv_1", "conv_s"):
            if conv not in p[blk]:
                continue
            _spectral(sd, f"{blk}.{conv}", p[blk][conv],
                      sp.get(blk, {}).get(conv))
            if "bias" in p[blk][conv]:
                sd[f"{blk}.{conv}.bias"] = _f32(p[blk][conv]["bias"])
        for norm in ("norm_0", "norm_1", "norm_s"):
            if norm not in p[blk]:
                continue
            base, np_ = f"{blk}.{norm}", p[blk][norm]
            for torch_name, jax_name in (("mlp_shared.0", "mlp_shared"),
                                         ("mlp_gamma", "mlp_gamma"),
                                         ("mlp_beta", "mlp_beta")):
                sd[f"{base}.spade.{torch_name}.weight"] = _conv(
                    np_[f"spade_{jax_name}_kernel"])
                sd[f"{base}.spade.{torch_name}.bias"] = _f32(
                    np_[f"spade_{jax_name}_bias"])
            sd[f"{base}.adain.linear.weight"] = _lin(
                np_["adain_linear"]["weight"])
            sd[f"{base}.adain.linear.bias"] = _f32(
                np_["adain_linear"]["bias"])
            if blk in bs and norm in bs[blk]:   # param-free BN (norm batch)
                _bn_stats(sd, f"{base}.spade.param_free_norm", bs[blk][norm])
    return sd


def export_encoder(variables: Dict) -> Dict[str, np.ndarray]:
    """Encoder variables -> the port's (and the reference's) encoder
    state_dict, as numpy arrays.  The spectral+instance layer norms carry
    no state; fc_mu/fc_var are re-flattened from HWC to torch's CHW."""
    p, sp = variables["params"], variables.get("spectral", {})
    sd: Dict[str, np.ndarray] = {}
    n_layers = sum(1 for k in p if k.startswith("layer"))
    for i in range(n_layers):
        _spectral(sd, f"layer{i}.0", p[f"layer{i}"], sp.get(f"layer{i}"))
        if "bias" in p[f"layer{i}"]:
            sd[f"layer{i}.0.bias"] = _f32(p[f"layer{i}"]["bias"])
        norm = p.get(f"norm{i}", {})
        if "TorchBatchNorm_0" in norm:
            # batch sub-norm (norm_E='spectralbatch'): the affine
            # BatchNorm2d at Sequential slot 1
            _bn(sd, f"layer{i}.1", norm["TorchBatchNorm_0"],
                variables["batch_stats"][f"norm{i}"]["TorchBatchNorm_0"])
    c = np.asarray(p[f"layer{n_layers - 1}"]["kernel"]).shape[-1]
    for fc in ("fc_mu", "fc_var"):
        w_dim = np.asarray(p[fc]["bias"]).shape[0]
        w = _lin(p[fc]["kernel"])                       # (w_dim, g*g*c)
        # the final grid is 4x4 at crop >= 256 and 8x8 below
        g = int(round((w.shape[1] // c) ** 0.5))
        assert g * g * c == w.shape[1], (w.shape, c)
        if g != 4:
            warnings.warn(
                f"encoder final grid is {g}x{g} (crop_size<256 path); the "
                "unmodified reference ConvEncoder hardcodes 4x4 "
                "(models/networks/encoder.py:36-47) and cannot strict-load "
                "this export — it is only loadable by a matching "
                "generalized-geometry module.", stacklevel=2)
        w = w.reshape(w_dim, g, g, c)
        sd[f"{fc}.weight"] = np.transpose(w, (0, 3, 1, 2)).reshape(w_dim, -1)
        sd[f"{fc}.bias"] = _f32(p[fc]["bias"])
    return sd


def export_discriminator(variables: Dict, num_d: int = 2,
                         n_layers: int = 4) -> Dict[str, np.ndarray]:
    """Multiscale discriminator variables -> the port's (and the
    reference's) discriminator state_dict, as numpy arrays."""
    p, sp = variables["params"], variables.get("spectral", {})
    sd: Dict[str, np.ndarray] = {}
    for k in range(num_d):
        dk = f"discriminator_{k}"
        sd[f"{dk}.model0.0.weight"] = _conv(p[dk]["model0_conv"]["kernel"])
        sd[f"{dk}.model0.0.bias"] = _f32(p[dk]["model0_conv"]["bias"])
        for n in range(1, n_layers):
            conv_p = p[dk][f"model{n}_conv"]
            if "bias" in conv_p:
                # no sub-norm: the bare conv, bias kept, at model{n}.0
                _spectral(sd, f"{dk}.model{n}.0", conv_p,
                          sp.get(dk, {}).get(f"model{n}_conv"))
                sd[f"{dk}.model{n}.0.bias"] = _f32(conv_p["bias"])
                continue
            _spectral(sd, f"{dk}.model{n}.0.0", conv_p,
                      sp.get(dk, {}).get(f"model{n}_conv"))
            norm = p[dk].get(f"norm{n}", {})
            if "TorchBatchNorm_0" in norm:
                # batch sub-norm (norm_D='spectralbatch'): the affine
                # BatchNorm2d at Sequential slot 1
                _bn(sd, f"{dk}.model{n}.0.1", norm["TorchBatchNorm_0"],
                    variables["batch_stats"][dk][f"norm{n}"]
                    ["TorchBatchNorm_0"])
        last = f"model{n_layers}_conv"
        sd[f"{dk}.model{n_layers}.0.weight"] = _conv(p[dk][last]["kernel"])
        sd[f"{dk}.model{n_layers}.0.bias"] = _f32(p[dk][last]["bias"])
    return sd


def export_vgg19(variables: Dict) -> Dict[str, np.ndarray]:
    """VGG19Features variables -> torchvision's ``features.{idx}`` names,
    as numpy arrays."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in variables["params"].items():
        idx = int(name.removeprefix("conv"))
        sd[f"features.{idx}.weight"] = _conv(node["kernel"])
        sd[f"features.{idx}.bias"] = _f32(node["bias"])
    return sd


def from_jax_variables(variables: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G": generator variables, "E": encoder variables[, "D":
    discriminator variables][, "VGG": VGG19 variables]} (numpy arrays) ->
    state_dicts of CPU tensors under the same keys."""
    out = {"G": _to_torch(export_generator(variables["G"])),
           "E": _to_torch(export_encoder(variables["E"]))}
    if "D" in variables:
        d = variables["D"]["params"]
        num_d = sum(1 for k in d if k.startswith("discriminator_"))
        n_layers = sum(1 for k in d["discriminator_0"]
                       if k.startswith("model")) - 1
        out["D"] = _to_torch(export_discriminator(variables["D"], num_d,
                                                 n_layers))
    if "VGG" in variables:
        out["VGG"] = _to_torch(export_vgg19(variables["VGG"]))
    return out


def _export_resnet_into(sd, p, bs, prefix: str = ""):
    def k(name):
        return prefix + name

    sd[k("conv1.weight")] = _conv(p["conv1"]["kernel"])
    _bn(sd, k("bn1"), p["bn1"], bs["bn1"])
    layers = {"layer1": 3, "layer2": 4, "layer3": 23, "layer4": 3}
    for lname, blocks in layers.items():
        for i in range(blocks):
            fblk = f"{lname}_{i}"
            if fblk not in p:
                continue
            tbase = k(f"{lname}.{i}")
            for j in (1, 2, 3):
                sd[f"{tbase}.conv{j}.weight"] = _conv(
                    p[fblk][f"conv{j}"]["conv"]["kernel"])
                _bn(sd, f"{tbase}.bn{j}", p[fblk][f"conv{j}"]["bn"],
                    bs[fblk][f"conv{j}"]["bn"])
            if "downsample" in p[fblk]:
                sd[f"{tbase}.downsample.0.weight"] = _conv(
                    p[fblk]["downsample"]["conv"]["kernel"])
                _bn(sd, f"{tbase}.downsample.1", p[fblk]["downsample"]["bn"],
                    bs[fblk]["downsample"]["bn"])


def _export_sepconv(sd, fp, fbs, torch_base: str):
    sd[f"{torch_base}.conv1.weight"] = _conv(fp["depthwise"]["kernel"])
    _bn(sd, f"{torch_base}.bn", fp["bn"], fbs["bn"])
    sd[f"{torch_base}.pointwise.weight"] = _conv(fp["pointwise"]["kernel"])


def _export_xception_into(sd, p, bs, prefix: str = ""):
    def k(name):
        return prefix + name

    sd[k("conv1.weight")] = _conv(p["conv1"]["kernel"])
    _bn(sd, k("bn1"), p["bn1"], bs["bn1"])
    sd[k("conv2.weight")] = _conv(p["conv2"]["kernel"])
    _bn(sd, k("bn2"), p["bn2"], bs["bn2"])
    for b in range(1, 21):
        fb = f"block{b}"
        off = 0 if b not in (1, 2) else -1
        for u in range(3):
            si = 3 * u + 1 + off
            _export_sepconv(sd, p[fb][f"sep{u}"], bs[fb][f"sep{u}"],
                            k(f"{fb}.rep.{si}"))
            _bn(sd, k(f"{fb}.rep.{si + 1}"), p[fb][f"sepbn{u}"],
                bs[fb][f"sepbn{u}"])
        if "skip" in p[fb]:
            sd[k(f"{fb}.skip.weight")] = _conv(p[fb]["skip"]["kernel"])
            _bn(sd, k(f"{fb}.skipbn"), p[fb]["skipbn"], bs[fb]["skipbn"])
    for i in (3, 4, 5):
        _export_sepconv(sd, p[f"conv{i}"], bs[f"conv{i}"], k(f"conv{i}"))
        _bn(sd, k(f"bn{i}"), p[f"bn{i}"], bs[f"bn{i}"])


def _export_drn_into(sd, p, bs, prefix: str = ""):
    def k(name):
        return prefix + name

    sd[k("layer0.0.weight")] = _conv(p["layer0_conv"]["kernel"])
    _bn(sd, k("layer0.1"), p["layer0_bn"], bs["layer0_bn"])
    for lname in ("layer1", "layer2", "layer7", "layer8"):
        i = 0
        while f"{lname}_conv{i}" in p:
            sd[k(f"{lname}.{3 * i}.weight")] = _conv(
                p[f"{lname}_conv{i}"]["kernel"])
            _bn(sd, k(f"{lname}.{3 * i + 1}"), p[f"{lname}_bn{i}"],
                bs[f"{lname}_bn{i}"])
            i += 1
    for lname, blocks in (("layer3", 3), ("layer4", 4), ("layer5", 6),
                          ("layer6", 3)):
        for i in range(blocks):
            fb, tb = f"{lname}_{i}", k(f"{lname}.{i}")
            if fb not in p:
                continue
            for j in (1, 2, 3):
                sd[f"{tb}.conv{j}.weight"] = _conv(p[fb][f"conv{j}"]["kernel"])
                _bn(sd, f"{tb}.bn{j}", p[fb][f"bn{j}"], bs[fb][f"bn{j}"])
            if "down" in p[fb]:
                sd[f"{tb}.downsample.0.weight"] = _conv(p[fb]["down"]["kernel"])
                _bn(sd, f"{tb}.downsample.1", p[fb]["down_bn"],
                    bs[fb]["down_bn"])


def _export_mobilenet_into(sd, p, bs, prefix: str = ""):
    def k(name):
        return prefix + name

    sd[k("features.0.0.weight")] = _conv(p["stem"]["conv"]["kernel"])
    _bn(sd, k("features.0.1"), p["stem"]["bn"], bs["stem"]["bn"])
    cfg = [(1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1)]  # t, n
    fi = 1
    for bi, (t, n) in enumerate(cfg):
        for i in range(n):
            fb, tb = f"block{bi}_{i}", k(f"features.{fi}")
            fi += 1
            if t != 1:
                sd[f"{tb}.conv.0.weight"] = _conv(
                    p[fb]["expand"]["conv"]["kernel"])
                _bn(sd, f"{tb}.conv.1", p[fb]["expand"]["bn"],
                    bs[fb]["expand"]["bn"])
                dwi = 3
            else:
                dwi = 0
            sd[f"{tb}.conv.{dwi}.weight"] = _conv(p[fb]["dw"]["kernel"])
            _bn(sd, f"{tb}.conv.{dwi + 1}", p[fb]["dw_bn"], bs[fb]["dw_bn"])
            sd[f"{tb}.conv.{dwi + 3}.weight"] = _conv(
                p[fb]["project"]["conv"]["kernel"])
            _bn(sd, f"{tb}.conv.{dwi + 4}", p[fb]["project"]["bn"],
                bs[fb]["project"]["bn"])

    # the reference's low_level_features = features[0:4] and
    # high_level_features = features[4:] share the modules of ``features``
    # (original indices kept), so its state_dict carries every tensor under
    # two names
    feat_prefix = k("features.")
    for key in [key for key in sd if key.startswith(feat_prefix)]:
        rest = key[len(feat_prefix):]
        idx = int(rest.split(".", 1)[0])
        fam = "low_level_features" if idx < 4 else "high_level_features"
        sd[k(f"{fam}.{rest}")] = sd[key]


_BACKBONE_EXPORTERS = {
    "resnet": _export_resnet_into,
    "xception": _export_xception_into,
    "drn": _export_drn_into,
    "mobilenet": _export_mobilenet_into,
}


def export_xception_backbone(variables: Dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _export_xception_into(sd, variables["params"], variables["batch_stats"])
    return sd


def export_drn_backbone(variables: Dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _export_drn_into(sd, variables["params"], variables["batch_stats"])
    return sd


def export_deeplab(variables: Dict,
                   backbone: str = "resnet") -> Dict[str, np.ndarray]:
    """DeepLab variables -> the reference's DeepLab state_dict, as numpy
    arrays."""
    p, bs = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _BACKBONE_EXPORTERS[backbone](sd, p["backbone"], bs["backbone"],
                                  "backbone.")

    def convbn(fp, fbs, torch_conv, torch_bn):
        sd[torch_conv] = _conv(fp["conv"]["kernel"])
        _bn(sd, torch_bn, fp["bn"], fbs["bn"])

    ap, abs_ = p["aspp"], bs["aspp"]
    for i in (1, 2, 3, 4):
        convbn(ap[f"aspp{i}"], abs_[f"aspp{i}"],
               f"aspp.aspp{i}.atrous_conv.weight", f"aspp.aspp{i}.bn")
    convbn(ap["global_pool"], abs_["global_pool"],
           "aspp.global_avg_pool.1.weight", "aspp.global_avg_pool.2")
    convbn(ap["proj"], abs_["proj"], "aspp.conv1.weight", "aspp.bn1")

    dp, dbs = p["decoder"], bs["decoder"]
    convbn(dp["low_proj"], dbs["low_proj"],
           "decoder.conv1.weight", "decoder.bn1")
    convbn(dp["conv1"], dbs["conv1"],
           "decoder.last_conv.0.weight", "decoder.last_conv.1")
    convbn(dp["conv2"], dbs["conv2"],
           "decoder.last_conv.4.weight", "decoder.last_conv.5")
    sd["decoder.last_conv.8.weight"] = _conv(dp["classifier"]["kernel"])
    sd["decoder.last_conv.8.bias"] = _f32(dp["classifier"]["bias"])
    return sd


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def deeplab_from_jax_variables(variables: Dict, backbone: str = "resnet"
                               ) -> Dict[str, torch.Tensor]:
    """DeepLab variables (numpy arrays) -> a state_dict of CPU tensors that
    the port's ``DeepLab`` of that backbone loads with ``strict=True``."""
    return _to_torch(export_deeplab(variables, backbone))


def init_deeplab(cfg, num_classes: int, generator: torch.Generator,
                 device: str | torch.device = "cuda") -> DeepLab:
    """The DeepLab of a RefineNet configuration (backbone, output stride,
    ResNet depth) with seeded kaiming weights (``models.deeplab.
    kaiming_init_``), drawn on the CPU from ``generator``, then moved to
    ``device``."""
    net = DeepLab(cfg.backbone, cfg.output_stride, num_classes,
                  RESNET_LAYERS[cfg.resnet_depth])
    return kaiming_init_(net, generator).to(device)


@torch.no_grad()
def _init_module(net: nn.Module, init, gain: float,
                 generator: torch.Generator) -> None:
    fc_linears = {id(m.linear) for m in net.modules() if isinstance(m, FCStyle)}
    for m in net.modules():
        if isinstance(m, SpectralConv):
            m.reset_parameters(init, generator)
        elif isinstance(m, FCStyle):
            m.reset_parameters(generator)
        elif isinstance(m, BatchSubNorm):
            m.weight.normal_(1.0, gain, generator=generator)
            m.bias.zero_()
        elif (isinstance(m, (nn.Conv2d, nn.Linear))
              and id(m) not in fc_linears):
            init(m.weight, generator)
            m.bias.zero_()


def init_networks(opt, generator: torch.Generator,
                  device: str | torch.device = "cuda"
                  ) -> Dict[str, nn.Module]:
    """Generator and encoder (and the discriminator and, with the VGG loss
    on, VGG19 when ``opt.isTrain``) for ``opt`` with seeded random weights:
    ``opt.init_type`` (gain ``opt.init_variance``) for convs and linears,
    He for the style FC layers, N(1, init_variance) batch sub-norm scales,
    zero biases, random normalised spectral u with v = normalize(W^T u);
    VGG19 last, with torchvision's init (pretrained weights come from
    ``--vgg_weights``).
    ``generator`` is a CPU generator: weights are drawn on the CPU, so one
    seed gives the same weights on every device, then moved to ``device``."""
    nets = build_networks(opt)
    init = weight_init(opt.init_type, opt.init_variance)
    for name, net in nets.items():
        if name == "VGG":
            init_vgg19_(net, generator)
        else:
            _init_module(net, init, opt.init_variance, generator)
    return {k: v.to(device) for k, v in nets.items()}
