"""Weights for the port's networks.

  * ``from_jax_variables``: the JAX package's variables -> state_dicts that
    load into the port's modules with ``strict=True``.  The layout work
    (OIHW kernels, (out, in) linears, CHW-flattened encoder fc, spectral
    ``weight_v`` in torch's flatten order) is ``seg2eye_tpu.utils.
    torch_export``'s, a numpy-only module, imported only here.
  * ``init_networks``: seeded random weights with the JAX package's init
    schemes, for runs without a checkpoint.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from seg2eye_tpu_torch.models.layers import FCStyle, SpectralConv, weight_init
from seg2eye_tpu_torch.models.pix2pix import build_networks


def from_jax_variables(variables: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G": generator variables, "E": encoder variables} (numpy or JAX
    arrays) -> {"G": state_dict, "E": state_dict} of CPU tensors."""
    from seg2eye_tpu.utils.torch_export import export_encoder, export_generator

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
