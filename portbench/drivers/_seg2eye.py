"""What the Seg2Eye drivers share: the port's options from a configuration
file, the benchmark's seeded weights, and the port's networks holding them."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from portbench.reference import seg2eye as ref
from portbench.reference.common import make_state


def options(cfg: Dict, cell: Dict, train: bool):
    """The port's ``Options`` of a configuration: every field the file
    names, the cell's compute dtype and batch."""
    from seg2eye_tpu_torch.options import Options

    fields = {f.name for f in dataclasses.fields(Options)}
    given = {k: v for k, v in cfg.items() if k in fields}
    opt = Options(**given, compute_dtype=cell["dtype"],
                  batchSize=int(cell["sizes"]["batch"]),
                  isTrain=train).finalize()
    if (opt.image_height, opt.image_width) != (cell["sizes"]["height"],
                                               cell["sizes"]["width"]):
        raise ValueError("the cell's image size is not the configuration's")
    return opt


def weights(cfg: Dict, seed: int, device, train: bool
            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state dict} drawn on ``device`` from the seed."""
    return {net: make_state(s, seed, device, f"weights/{net}")
            for net, s in ref.specs(cfg, train).items()}


def port_nets(opt, sd: Dict, device) -> Dict[str, torch.nn.Module]:
    """The port's networks, built without weights and loaded with ``sd``
    (``strict=True``)."""
    from seg2eye_tpu_torch.models.pix2pix import build_networks

    with torch.device("meta"):
        nets = build_networks(opt)
    for name, net in nets.items():
        net.to_empty(device=device)
        net.load_state_dict(sd[name], strict=True)
    return nets

