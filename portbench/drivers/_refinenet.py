"""What the RefineNet drivers share: the port's configuration and model
from a configuration file, holding the benchmark's seeded weights."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from portbench.reference import deeplab as ref
from portbench.reference.common import make_state


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_state(ref.specs(cfg), seed, device, "weights/net")


def port_model(cfg: Dict, cell: Dict, sd: Dict, device):
    """(RefineNetModel, RefineNetConfig) holding ``sd`` (``strict=True``)."""
    from seg2eye_tpu_torch.models.deeplab import RESNET_LAYERS, DeepLab
    from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
    from seg2eye_tpu_torch.refinenet.model import RefineNetModel

    fields = {f.name for f in dataclasses.fields(RefineNetConfig)}
    rcfg = RefineNetConfig(**{k: v for k, v in cfg.items() if k in fields},
                           compute_dtype=cell["dtype"])
    if (rcfg.input_height, rcfg.input_width) != (cell["sizes"]["height"],
                                                 cell["sizes"]["width"]):
        raise ValueError("the cell's image size is not the configuration's")
    model = RefineNetModel(rcfg, device)
    with torch.device("meta"):
        net = DeepLab(rcfg.backbone, rcfg.output_stride, model.num_classes,
                      RESNET_LAYERS[rcfg.resnet_depth])
    net.to_empty(device=device)
    net.load_state_dict(sd, strict=True)
    model.net = net
    return model, rcfg

