"""Weights for the port's networks.

  * ``from_jax_variables``: the JAX package's variables (as numpy arrays)
    -> state_dicts that load into the port's modules with ``strict=True``.
    The layout work is the port's own copy of the generator and encoder
    half of ``seg2eye_tpu/utils/torch_export.py``: HWIO kernels -> OIHW,
    (in, out) linears -> (out, in), the encoder fc re-flattened from HWC
    to CHW, spectral ``weight_v`` in torch's (I, kh, kw) flatten order, BN
    statistics -> running_{mean,var}.
  * ``init_networks``: seeded random weights with the JAX package's init
    schemes, for runs without a checkpoint.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

from seg2eye_tpu_torch.models.layers import FCStyle, SpectralConv, weight_init
from seg2eye_tpu_torch.models.pix2pix import build_networks


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
        if "TorchBatchNorm_0" in p.get(f"norm{i}", {}):
            raise NotImplementedError(
                "batch-subnorm encoders (norm_E='spectralbatch') are not "
                "ported")
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


def from_jax_variables(variables: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G": generator variables, "E": encoder variables} (numpy arrays)
    -> {"G": state_dict, "E": state_dict} of CPU tensors."""
    def to_torch(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    return {"G": to_torch(export_generator(variables["G"])),
            "E": to_torch(export_encoder(variables["E"]))}


@torch.no_grad()
def _init_module(net: nn.Module, init, generator: torch.Generator) -> None:
    fc_linears = {id(m.linear) for m in net.modules() if isinstance(m, FCStyle)}
    for m in net.modules():
        if isinstance(m, SpectralConv):
            m.reset_parameters(init, generator)
        elif isinstance(m, FCStyle):
            m.reset_parameters(generator)
        elif (isinstance(m, (nn.Conv2d, nn.Linear))
              and id(m) not in fc_linears):
            init(m.weight, generator)
            m.bias.zero_()


def init_networks(opt, generator: torch.Generator,
                  device: str | torch.device = "cuda"
                  ) -> Dict[str, nn.Module]:
    """Generator and encoder for ``opt`` with seeded random weights: xavier
    (gain ``opt.init_variance``) for convs and linears, He for the style FC
    layers, zero biases, random normalised spectral u with v = normalize(W^T u).
    ``generator`` is a CPU generator: weights are drawn on the CPU, so one
    seed gives the same weights on every device, then moved to ``device``."""
    nets = build_networks(opt)
    init = weight_init(opt.init_type, opt.init_variance)
    for net in nets.values():
        _init_module(net, init, generator)
    return {k: v.to(device) for k, v in nets.items()}
