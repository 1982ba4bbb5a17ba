"""The JAX package's serving artifacts as the port's live models, for
``export_inference``/``export_refiner`` to export again.

A JAX artifact directory holds ``program.jaxexport`` (StableHLO, not read
here), ``variables.msgpack`` (flax msgpack: {"E", "G"} for Seg2Eye, the
DeepLab's {params, batch_stats} for a refiner) and ``meta.json``, whose
``baked_options`` (Seg2Eye) or ``baked_config`` and ``model_type``
(RefineNet/SegNet) give the configuration.  The weights load strictly,
after their structure is checked against the configuration's networks.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import torch

from seg2eye_tpu_torch.utils import flax_msgpack

VARIABLES, META = "variables.msgpack", "meta.json"


def _read(art_dir: str):
    with open(os.path.join(art_dir, META)) as f:
        meta = json.load(f)
    return meta, flax_msgpack.read(os.path.join(art_dir, VARIABLES))


def seg2eye_from_jax_artifact(art_dir: str, device="cuda"
                              ) -> Tuple[object, Tuple[int, int]]:
    """-> (the ``Pix2Pix`` of a JAX Seg2Eye artifact on ``device``, its
    native (H, W))."""
    from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
    from seg2eye_tpu_torch.options import Options
    from seg2eye_tpu_torch.utils.checkpoint import load_jax_network

    meta, variables = _read(art_dir)
    baked = dict(meta["baked_options"])
    baked["label_nc"] = baked.pop("semantic_nc")
    opt = Options(**baked, isTrain=False).finalize()
    nets = build_networks(opt)
    for name, net in nets.items():
        load_jax_network(net, name, variables[name],
                         os.path.join(art_dir, VARIABLES))
    native_h, native_w = meta["native_hw"]
    return Pix2Pix(opt, nets, torch.device(device)), (native_h, native_w)


def refiner_from_jax_artifact(art_dir: str, device="cuda"):
    """-> the ``RefineNetModel`` or ``SegNetModel`` of a JAX refiner
    artifact on ``device``."""
    from seg2eye_tpu_torch.refinenet.config import RefineNetConfig
    from seg2eye_tpu_torch.refinenet.model import RefineNetModel, SegNetModel
    from seg2eye_tpu_torch.utils import weights

    meta, variables = _read(art_dir)
    cfg = RefineNetConfig(**meta["baked_config"])
    cls = {"refinenet": RefineNetModel, "segnet": SegNetModel}[
        meta["model_type"]]
    model = cls(cfg, device).init(torch.Generator().manual_seed(0))
    flax_msgpack.check_like(variables, weights.deeplab_to_jax_variables(
        model.net, cfg.backbone), os.path.join(art_dir, VARIABLES))
    model.net.load_state_dict(weights.deeplab_from_jax_variables(
        variables, cfg.backbone), strict=True)
    return model
