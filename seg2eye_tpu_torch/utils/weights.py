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


def export_network(name: str, variables: Dict) -> Dict[str, np.ndarray]:
    """One network's variables -> its state_dict, as numpy arrays; ``name``
    is "G", "E", "D" or "VGG" (the discriminator's scales and depth are
    read off its variables)."""
    if name == "D":
        d = variables["params"]
        num_d = sum(1 for k in d if k.startswith("discriminator_"))
        n_layers = sum(1 for k in d["discriminator_0"]
                       if k.startswith("model")) - 1
        return export_discriminator(variables, num_d, n_layers)
    return {"G": export_generator, "E": export_encoder,
            "VGG": export_vgg19}[name](variables)


def from_jax_variables(variables: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G": generator variables, "E": encoder variables[, "D":
    discriminator variables][, "VGG": VGG19 variables]} (numpy arrays) ->
    state_dicts of CPU tensors under the same keys."""
    return {name: _to_torch(export_network(name, v))
            for name, v in variables.items()}


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


# ------------------------------------------------- the reverse: to the JAX layout
# The port's counterpart of ``seg2eye_tpu/utils/torch_convert.py``: a
# state_dict of the port's (the reference's) keys -> the JAX package's
# variables, as numpy arrays.  No template: which blocks, convs, biases,
# spectral states and batch statistics a network has is read off its keys.
# Each layout step is the exact inverse of its export above (``_hwio`` of
# ``_conv``, ``_perm_v`` of ``_unperm_v``, the encoder fc's CHW -> HWC), so
# a round trip gives back the same bits.  ``num_batches_tracked`` has no
# counterpart in the JAX package.

def _hwio(w):
    """torch OIHW weight -> flax HWIO kernel."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _perm_v(v, w_oihw):
    """Spectral v in torch's (I, kh, kw) flatten order -> (kh, kw, I)."""
    _, i, kh, kw = w_oihw.shape
    return np.transpose(np.asarray(v).reshape(i, kh, kw),
                        (1, 2, 0)).reshape(-1)


def _put(tree: Dict, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _import_conv(sd, base: str, p, sp, path) -> None:
    """A conv at ``base``: a spectral one (weight_orig, u, v) or a plain
    weight, and its bias if it has one."""
    if f"{base}.weight_orig" in sd:
        w = np.asarray(sd[f"{base}.weight_orig"])
        _put(p, (*path, "kernel"), _hwio(w))
        _put(sp, (*path, "u"), sd[f"{base}.weight_u"])
        _put(sp, (*path, "v"), _perm_v(sd[f"{base}.weight_v"], w))
    else:
        _put(p, (*path, "kernel"), _hwio(sd[f"{base}.weight"]))
    if f"{base}.bias" in sd:
        _put(p, (*path, "bias"), sd[f"{base}.bias"])


def _import_bn(sd, base: str, p, bs, path) -> None:
    _put(p, (*path, "scale"), sd[f"{base}.weight"])
    _put(p, (*path, "bias"), sd[f"{base}.bias"])
    _put(bs, (*path, "mean"), sd[f"{base}.running_mean"])
    _put(bs, (*path, "var"), sd[f"{base}.running_var"])


def _collections(p, sp=None, bs=None) -> Dict:
    out = {"params": p}
    if sp:
        out["spectral"] = sp
    if bs:
        out["batch_stats"] = bs
    return out


def import_generator(sd: Dict) -> Dict:
    """The generator's state_dict -> its {'params', 'spectral'[,
    'batch_stats']} (``torch_convert.convert_generator``)."""
    p, sp, bs = {}, {}, {}
    for name in ("fc", "conv_img"):
        _import_conv(sd, name, p, sp, (name,))
    for blk in GEN_BLOCKS:
        for conv in ("conv_0", "conv_1", "conv_s"):
            base = f"{blk}.{conv}"
            if f"{base}.weight_orig" in sd or f"{base}.weight" in sd:
                _import_conv(sd, base, p, sp, (blk, conv))
        for norm in ("norm_0", "norm_1", "norm_s"):
            base = f"{blk}.{norm}"
            if f"{base}.spade.mlp_shared.0.weight" not in sd:
                continue
            for torch_name, jax_name in (("mlp_shared.0", "mlp_shared"),
                                         ("mlp_gamma", "mlp_gamma"),
                                         ("mlp_beta", "mlp_beta")):
                _put(p, (blk, norm, f"spade_{jax_name}_kernel"),
                     _hwio(sd[f"{base}.spade.{torch_name}.weight"]))
                _put(p, (blk, norm, f"spade_{jax_name}_bias"),
                     sd[f"{base}.spade.{torch_name}.bias"])
            _put(p, (blk, norm, "adain_linear", "weight"),
                 np.asarray(sd[f"{base}.adain.linear.weight"]).T)
            _put(p, (blk, norm, "adain_linear", "bias"),
                 sd[f"{base}.adain.linear.bias"])
            stats = f"{base}.spade.param_free_norm"
            if f"{stats}.running_mean" in sd:
                _put(bs, (blk, norm, "mean"), sd[f"{stats}.running_mean"])
                _put(bs, (blk, norm, "var"), sd[f"{stats}.running_var"])
    return _collections(p, sp, bs)


def import_encoder(sd: Dict) -> Dict:
    """The encoder's state_dict -> its variables
    (``torch_convert.convert_encoder``): fc_mu/fc_var re-flattened from
    torch's CHW to HWC."""
    p, sp, bs = {}, {}, {}
    n_layers = 0
    while any(f"layer{n_layers}.0.{w}" in sd for w in ("weight_orig",
                                                        "weight")):
        i = n_layers
        _import_conv(sd, f"layer{i}.0", p, sp, (f"layer{i}",))
        if f"layer{i}.1.weight" in sd:
            _import_bn(sd, f"layer{i}.1", p, bs,
                       (f"norm{i}", "TorchBatchNorm_0"))
        n_layers += 1
    c = p[f"layer{n_layers - 1}"]["kernel"].shape[-1]
    for fc in ("fc_mu", "fc_var"):
        w = np.asarray(sd[f"{fc}.weight"])
        w_dim = w.shape[0]
        g = int(round((w.shape[1] // c) ** 0.5))
        assert g * g * c == w.shape[1], (w.shape, c)
        w = np.transpose(w.reshape(w_dim, c, g, g), (0, 2, 3, 1))
        _put(p, (fc, "kernel"), w.reshape(w_dim, -1).T)
        _put(p, (fc, "bias"), sd[f"{fc}.bias"])
    return _collections(p, sp, bs)


def import_discriminator(sd: Dict) -> Dict:
    """The multiscale discriminator's state_dict -> its variables
    (``torch_convert.convert_discriminator``)."""
    p, sp, bs = {}, {}, {}
    k = 0
    while f"discriminator_{k}.model0.0.weight" in sd:
        dk = f"discriminator_{k}"
        last = max(int(key[len(dk) + 6:].split(".")[0]) for key in sd
                   if key.startswith(f"{dk}.model"))
        _import_conv(sd, f"{dk}.model0.0", p, sp, (dk, "model0_conv"))
        for n in range(1, last):
            base = f"{dk}.model{n}.0"
            nested = any(key.startswith(f"{base}.0.") for key in sd)
            _import_conv(sd, f"{base}.0" if nested else base, p, sp,
                         (dk, f"model{n}_conv"))
            if f"{base}.1.weight" in sd:
                _import_bn(sd, f"{base}.1", p, bs,
                           (dk, f"norm{n}", "TorchBatchNorm_0"))
        _import_conv(sd, f"{dk}.model{last}.0", p, sp, (dk, f"model{last}_conv"))
        k += 1
    return _collections(p, sp, bs)


def _import_resnet_into(sd, p, bs, prefix: str = "") -> None:
    _put(p, ("conv1", "kernel"), _hwio(sd[f"{prefix}conv1.weight"]))
    _import_bn(sd, f"{prefix}bn1", p, bs, ("bn1",))
    for lname in ("layer1", "layer2", "layer3", "layer4"):
        i = 0
        while f"{prefix}{lname}.{i}.conv1.weight" in sd:
            fb, tb = f"{lname}_{i}", f"{prefix}{lname}.{i}"
            for j in (1, 2, 3):
                _put(p, (fb, f"conv{j}", "conv", "kernel"),
                     _hwio(sd[f"{tb}.conv{j}.weight"]))
                _import_bn(sd, f"{tb}.bn{j}", p, bs, (fb, f"conv{j}", "bn"))
            if f"{tb}.downsample.0.weight" in sd:
                _put(p, (fb, "downsample", "conv", "kernel"),
                     _hwio(sd[f"{tb}.downsample.0.weight"]))
                _import_bn(sd, f"{tb}.downsample.1", p, bs,
                           (fb, "downsample", "bn"))
            i += 1


def _import_sepconv(sd, base: str, p, bs, path) -> None:
    _put(p, (*path, "depthwise", "kernel"), _hwio(sd[f"{base}.conv1.weight"]))
    _import_bn(sd, f"{base}.bn", p, bs, (*path, "bn"))
    _put(p, (*path, "pointwise", "kernel"),
         _hwio(sd[f"{base}.pointwise.weight"]))


def _import_xception_into(sd, p, bs, prefix: str = "") -> None:
    for i in (1, 2):
        _put(p, (f"conv{i}", "kernel"), _hwio(sd[f"{prefix}conv{i}.weight"]))
        _import_bn(sd, f"{prefix}bn{i}", p, bs, (f"bn{i}",))
    for b in range(1, 21):
        fb = f"block{b}"
        off = 0 if b not in (1, 2) else -1
        for u in range(3):
            si = 3 * u + 1 + off
            _import_sepconv(sd, f"{prefix}{fb}.rep.{si}", p, bs,
                            (fb, f"sep{u}"))
            _import_bn(sd, f"{prefix}{fb}.rep.{si + 1}", p, bs,
                       (fb, f"sepbn{u}"))
        if f"{prefix}{fb}.skip.weight" in sd:
            _put(p, (fb, "skip", "kernel"),
                 _hwio(sd[f"{prefix}{fb}.skip.weight"]))
            _import_bn(sd, f"{prefix}{fb}.skipbn", p, bs, (fb, "skipbn"))
    for i in (3, 4, 5):
        _import_sepconv(sd, f"{prefix}conv{i}", p, bs, (f"conv{i}",))
        _import_bn(sd, f"{prefix}bn{i}", p, bs, (f"bn{i}",))


def _import_drn_into(sd, p, bs, prefix: str = "") -> None:
    _put(p, ("layer0_conv", "kernel"), _hwio(sd[f"{prefix}layer0.0.weight"]))
    _import_bn(sd, f"{prefix}layer0.1", p, bs, ("layer0_bn",))
    for lname in ("layer1", "layer2", "layer7", "layer8"):
        i = 0
        while f"{prefix}{lname}.{3 * i}.weight" in sd:
            _put(p, (f"{lname}_conv{i}", "kernel"),
                 _hwio(sd[f"{prefix}{lname}.{3 * i}.weight"]))
            _import_bn(sd, f"{prefix}{lname}.{3 * i + 1}", p, bs,
                       (f"{lname}_bn{i}",))
            i += 1
    for lname in ("layer3", "layer4", "layer5", "layer6"):
        i = 0
        while f"{prefix}{lname}.{i}.conv1.weight" in sd:
            fb, tb = f"{lname}_{i}", f"{prefix}{lname}.{i}"
            for j in (1, 2, 3):
                _put(p, (fb, f"conv{j}", "kernel"),
                     _hwio(sd[f"{tb}.conv{j}.weight"]))
                _import_bn(sd, f"{tb}.bn{j}", p, bs, (fb, f"bn{j}"))
            if f"{tb}.downsample.0.weight" in sd:
                _put(p, (fb, "down", "kernel"),
                     _hwio(sd[f"{tb}.downsample.0.weight"]))
                _import_bn(sd, f"{tb}.downsample.1", p, bs, (fb, "down_bn"))
            i += 1


def _import_mobilenet_into(sd, p, bs, prefix: str = "") -> None:
    """Reads ``features.*``; the low/high_level_features aliases of the
    same tensors are not read."""
    _put(p, ("stem", "conv", "kernel"),
         _hwio(sd[f"{prefix}features.0.0.weight"]))
    _import_bn(sd, f"{prefix}features.0.1", p, bs, ("stem", "bn"))
    cfg = [(1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1)]  # t, n
    fi = 1
    for bi, (t, n) in enumerate(cfg):
        for i in range(n):
            fb, tb = f"block{bi}_{i}", f"{prefix}features.{fi}"
            fi += 1
            dwi = 0
            if t != 1:
                _put(p, (fb, "expand", "conv", "kernel"),
                     _hwio(sd[f"{tb}.conv.0.weight"]))
                _import_bn(sd, f"{tb}.conv.1", p, bs, (fb, "expand", "bn"))
                dwi = 3
            _put(p, (fb, "dw", "kernel"), _hwio(sd[f"{tb}.conv.{dwi}.weight"]))
            _import_bn(sd, f"{tb}.conv.{dwi + 1}", p, bs, (fb, "dw_bn"))
            _put(p, (fb, "project", "conv", "kernel"),
                 _hwio(sd[f"{tb}.conv.{dwi + 3}.weight"]))
            _import_bn(sd, f"{tb}.conv.{dwi + 4}", p, bs,
                       (fb, "project", "bn"))


_BACKBONE_IMPORTERS = {
    "resnet": _import_resnet_into,
    "xception": _import_xception_into,
    "drn": _import_drn_into,
    "mobilenet": _import_mobilenet_into,
}


def import_deeplab(sd: Dict, backbone: str = "resnet") -> Dict:
    """The reference's DeepLab state_dict -> DeepLab variables
    {'params', 'batch_stats'} (``torch_convert.convert_deeplab``)."""
    p, bs = {"backbone": {}}, {"backbone": {}}
    _BACKBONE_IMPORTERS[backbone](sd, p["backbone"], bs["backbone"],
                                  "backbone.")

    def convbn(path, torch_conv, torch_bn):
        _put(p, (*path, "conv", "kernel"), _hwio(sd[torch_conv]))
        _import_bn(sd, torch_bn, p, bs, (*path, "bn"))

    for i in (1, 2, 3, 4):
        convbn(("aspp", f"aspp{i}"), f"aspp.aspp{i}.atrous_conv.weight",
               f"aspp.aspp{i}.bn")
    convbn(("aspp", "global_pool"), "aspp.global_avg_pool.1.weight",
           "aspp.global_avg_pool.2")
    convbn(("aspp", "proj"), "aspp.conv1.weight", "aspp.bn1")
    convbn(("decoder", "low_proj"), "decoder.conv1.weight", "decoder.bn1")
    convbn(("decoder", "conv1"), "decoder.last_conv.0.weight",
           "decoder.last_conv.1")
    convbn(("decoder", "conv2"), "decoder.last_conv.4.weight",
           "decoder.last_conv.5")
    _put(p, ("decoder", "classifier", "kernel"),
         _hwio(sd["decoder.last_conv.8.weight"]))
    _put(p, ("decoder", "classifier", "bias"), sd["decoder.last_conv.8.bias"])
    return {"params": p, "batch_stats": bs}


def numpy_state_dict(net: nn.Module) -> Dict[str, np.ndarray]:
    """A module's state_dict as CPU numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}


IMPORTERS = {"G": import_generator, "E": import_encoder,
             "D": import_discriminator}


def to_jax_variables(nets: Dict[str, nn.Module]) -> Dict[str, Dict]:
    """{"G", "E"[, "D"]: the port's modules} -> the JAX package's variables
    of each, as numpy arrays (the reverse of ``from_jax_variables``)."""
    return {k: IMPORTERS[k](numpy_state_dict(net)) for k, net in nets.items()
            if k in IMPORTERS}


def deeplab_to_jax_variables(net: DeepLab, backbone: str) -> Dict:
    """The port's DeepLab -> the JAX package's DeepLab variables."""
    return import_deeplab(numpy_state_dict(net), backbone)
