"""RefineNet configuration (the port's copy of
``seg2eye_tpu/refinenet/config.py``, held to it field for field by a
test): the reference's defaults (refinenet/core/config_default.py), JSON
overlays applied in order (unknown keys raise), flags generated from the
fields, the batch-scaled learning rate and the md5-of-config run
identifier.  ``compute_dtype``, ``input_{width,height}``, ``max_steps``,
``prefetch`` and ``device_normalize`` are the JAX package's additions;
``use_apex`` is kept for the JSON files and does nothing (the compute
dtype is ``compute_dtype``).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass


@dataclass
class RefineNetConfig:
    # training (config_default.py:12-45)
    fully_reproducible: bool = False
    use_apex: bool = True          # reference AMP flag; here: bf16 policy is
                                   # controlled by compute_dtype instead
    batch_size: int = 32
    weight_decay: float = 0.0001
    num_epochs: int = 50
    num_warmup_epochs: int = 5
    train_data_workers: int = 8

    log_every_n_steps: int = 20
    tensorboard_scalars_every_n_steps: int = 20
    tensorboard_images_every_n_steps: int = 200
    tensorboard_learning_rate_every_n_steps: int = 200

    base_learning_rate: float = 0.0004
    lr_decay_strategy: str = "exponential"     # exponential | cyclic
    lr_decay_factor: float = 0.5
    lr_decay_epoch_interval: float = 5
    gradient_norm_clip: float = 0.0

    test_num_samples: int = 10000
    test_batch_size: int = 64
    test_data_workers: int = 4
    test_every_n_steps: int = 1000
    track_running_stats: bool = True

    checkpoints_keep_n: int = 3
    resume_from: str = ""

    # model
    backbone: str = "resnet"
    output_stride: int = 16
    resnet_depth: int = 101                     # 101 (reference) | 50 | 26 | 14
    # a torch .pth state_dict of the backbone under the reference's names
    # (for ResNet the torchvision ResNet-101 the reference downloads,
    # resnet.py:138-146); "" = from scratch
    pretrained_backbone: str = ""

    # data paths (reference passes these via argparse in the scripts)
    dataroot: str = ""
    distances_and_indices: str = ""
    segmentations_train: str = ""
    segmentations_generative: str = ""
    segmentations_sequence: str = ""
    output_dir_base: str = "outputs"

    # the JAX package's additions
    seed: int = 0
    compute_dtype: str = "bfloat16"
    input_width: int = 400                      # OpenEDS native (dataset.py:13)
    input_height: int = 640
    max_steps: int = 0                          # 0 = full num_epochs
    prefetch: int = 2
    # uint8 host->device image transport, normalised on the device: 4x
    # less transfer, bit-exact when the sources are already at the input
    # size (dataset.u8_transport_ok); float32 otherwise
    device_normalize: bool = True

    @property
    def learning_rate(self) -> float:
        # lr scales with batch size (config_default.py:29-31)
        return self.batch_size * self.base_learning_rate

    def full_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, sort_keys=True)

    def identifier(self, model_name: str) -> str:
        md5 = hashlib.md5(self.full_json().encode("utf-8")).hexdigest()[:6]
        return f"{model_name}/{time.strftime('%y%m%d_%H%M%S')}.{md5}"

    def replace(self, **kw) -> "RefineNetConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_json(cls, *paths: str, **overrides) -> "RefineNetConfig":
        d = {}
        for p in paths:
            with open(p) as f:
                d.update(json.load(f))
        d.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # reference asserts on unknown keys (config_default.py:101-105)
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_args(cls, argv=None) -> "RefineNetConfig":
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser.add_argument("config_json", nargs="*",
                            help="JSON config overlays, applied in order")
        defaults = cls()
        for f in dataclasses.fields(cls):
            v = getattr(defaults, f.name)
            if isinstance(v, bool):
                parser.add_argument("--" + f.name, action="store_true",
                                    default=None)
            else:
                parser.add_argument("--" + f.name, type=type(v), default=None)
        ns = parser.parse_args(argv)
        overrides = {f.name: getattr(ns, f.name)
                     for f in dataclasses.fields(cls)
                     if getattr(ns, f.name) is not None}
        return cls.from_json(*ns.config_json, **overrides)
