"""Options for the port: field for field the JAX package's
``seg2eye_tpu/options.py`` (same names, types and defaults, the same
``parse_options`` flags), so that a run of the port needs nothing of
``seg2eye_tpu``.  The tests hold the two against each other.  Fields the
port does not read yet (training, discriminator, mesh layout) are kept so
that flags and saved ``opt.pkl`` files carry across unchanged.

The port adds ``PORT_FIELDS``, GauGAN's (NVlabs/SPADE ``base_options.py``):
``no_instance`` and ``contain_dontcare_label``, which add the instance-edge
and don't-care channels to ``semantic_nc``.  Their defaults (no instance
map, no don't-care label) leave every JAX option as it is.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
from dataclasses import dataclass


# the fields the JAX package's Options lacks
PORT_FIELDS = ("no_instance", "contain_dontcare_label")


@dataclass
class Options:
    # experiment specifics (reference: options/base_options.py:19-31)
    name: str = ""
    checkpoints_dir: str = "./checkpoints"
    model: str = "pix2pix"
    norm_G: str = "spectralspadebatch3x3"
    norm_D: str = "spectralinstance"
    norm_E: str = "spectralinstance"
    netG: str = "spadestyle"
    netD: str = "multiscale"
    netE: str = "conv"

    # input/output sizes (base_options.py:33-44)
    batchSize: int = 1
    preprocess_mode: str = "fixed"
    load_size: int = 256
    crop_size: int = 256
    aspect_ratio: float = 0.8
    label_nc: int = 4
    input_nc: int = 1
    output_nc: int = 1
    input_ns: int = 4
    style_aggr_method: str = "mean"           # mean | max
    style_sample_method: str = "random"       # random | first | ref_first | ref_randomN

    # inputs (base_options.py:46-58)
    dataroot: str = ""
    dataset_key: str = "train"
    dataset_mode: str = "openeds"
    serial_batches: bool = False
    no_flip: bool = False
    nThreads: int = 0
    load_from_opt_file: bool = False
    style_ref: str = ""
    seg_file: str = ""

    ngf: int = 64
    # GauGAN's label channels (NVlabs/SPADE base_options.py); port only
    no_instance: bool = True
    contain_dontcare_label: bool = False
    init_type: str = "xavier"
    init_variance: float = 0.02
    w_dim: int = 16
    nef: int = 16

    # generator and discriminator architecture
    num_upsampling_layers: str = "normal"     # normal | more | most
    netD_subarch: str = "n_layer"
    num_D: int = 2
    n_layers_D: int = 4

    # train options (reference: options/train_options.py)
    isTrain: bool = True
    display_freq: int = 5000
    print_freq: int = 500
    save_latest_freq: int = 5000
    save_epoch_freq: int = 1
    tf_log: bool = False
    validation_limit: int = 250
    write_error_log: bool = False
    full_val_freq: int = 50000

    continue_train: bool = False
    which_epoch: str = "latest"
    niter: int = 14
    niter_decay: int = 7
    optimizer: str = "adam"
    beta1: float = 0.5
    beta2: float = 0.999
    lr: float = 0.0002
    D_steps_per_G: int = 1
    weight_decay: float = 0.0

    ndf: int = 64
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    lambda_l2: float = 0.0
    lambda_l1: float = 0.0
    lambda_openeds: float = 0.0
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = True                  # train_options.py:51 set_defaults
    vgg_weights: str = ""
    gan_mode: str = "hinge"                   # ls | original | hinge | w
    no_TTUR: bool = False
    lambda_kld: float = 0.05
    lambda_style_w: float = 0.0
    lambda_style_feat: float = 0.0
    lambda_gram: float = 0.0

    # test options (reference: options/test_options.py)
    results_dir: str = "results/"
    how_many: float = float("inf")
    produce_npy: bool = False

    # additions of the JAX package; the port reads seed, compute_dtype,
    # prefetch, eval_use_running_stats and per_sample_encode
    seed: int = 0
    compute_dtype: str = "bfloat16"           # bfloat16 | float32
    data_axis: int = 0
    model_axis: int = 1
    tp_min_channels: int = 256
    prefetch: int = 2
    host_cache_mb: int = 1024
    device_normalize: bool = True
    eval_use_running_stats: bool = False      # reference never calls .eval()
    max_steps: int = 0
    profile_steps: int = 0
    reuse_fake: bool = False
    spatial_shard: bool = False
    per_sample_encode: str = "auto"           # auto | on | off
    remat: bool = False

    # derived (filled by finalize(); base_options.py:158-161)
    semantic_nc: int = 4

    def finalize(self) -> "Options":
        self.semantic_nc = (self.label_nc + int(self.contain_dontcare_label)
                            + int(not self.no_instance))
        if self.per_sample_encode not in ("auto", "on", "off"):
            raise ValueError(
                f"--per_sample_encode must be auto|on|off, "
                f"got {self.per_sample_encode!r}")
        return self

    @property
    def per_sample_encode_enabled(self) -> bool:
        """'auto' is on exactly for a batch-subnorm encoder."""
        if self.per_sample_encode == "auto":
            sub = (self.norm_E[len("spectral"):]
                   if self.norm_E.startswith("spectral") else self.norm_E)
            return sub == "batch"
        return self.per_sample_encode == "on"

    # 'fixed' preprocess: W = crop_size, H = round(crop_size / aspect_ratio)
    @property
    def image_width(self) -> int:
        return self.crop_size

    @property
    def image_height(self) -> int:
        return round(self.crop_size / self.aspect_ratio)

    @property
    def expr_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw).finalize()

    def save(self):
        """``opt.txt`` (default-diffed dump) and ``opt.pkl`` in expr_dir."""
        os.makedirs(self.expr_dir, exist_ok=True)
        defaults = Options()
        lines = ["----------------- Options ---------------"]
        for f in sorted(dataclasses.fields(self), key=lambda f: f.name):
            v = getattr(self, f.name)
            comment = ""
            if v != getattr(defaults, f.name):
                comment = "\t[default: %s]" % str(getattr(defaults, f.name))
            lines.append("{:>25}: {:<30}{}".format(f.name, str(v), comment))
        lines.append("----------------- End -------------------")
        with open(os.path.join(self.expr_dir, "opt.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
        with open(os.path.join(self.expr_dir, "opt.pkl"), "wb") as fh:
            pickle.dump(dataclasses.asdict(self), fh)

    @classmethod
    def load(cls, expr_dir: str) -> "Options":
        with open(os.path.join(expr_dir, "opt.pkl"), "rb") as fh:
            d = pickle.load(fh)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).finalize()


def _add_args(parser: argparse.ArgumentParser, defaults: Options):
    """One flag per field; a bool that defaults to True also gets --no_X
    (or --X for a field named no_X)."""
    for f in dataclasses.fields(Options):
        if f.name in ("semantic_nc", "isTrain"):
            continue
        v = getattr(defaults, f.name)
        if isinstance(v, bool):
            if v:
                parser.add_argument("--no_" + f.name if not f.name.startswith("no_")
                                    else "--" + f.name[3:],
                                    dest=f.name, action="store_false")
                parser.add_argument("--" + f.name, dest=f.name, action="store_true",
                                    default=v)
            else:
                parser.add_argument("--" + f.name, action="store_true", default=v)
        else:
            parser.add_argument("--" + f.name, type=type(v), default=v)
    return parser


def parse_options(argv=None, is_train: bool = True, save: bool = None) -> Options:
    """CLI entry, the reference's TrainOptions().parse() / TestOptions().parse()."""
    defaults = Options()
    if not is_train:
        defaults = defaults.replace(serial_batches=True, no_flip=True)
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_args(parser, defaults)
    ns, _ = parser.parse_known_args(argv)
    d = vars(ns)

    if d.get("load_from_opt_file"):
        # saved options, then the CLI values that differ from the defaults
        loaded = Options.load(os.path.join(d["checkpoints_dir"], d["name"]))
        merged = dataclasses.asdict(loaded)
        for f in dataclasses.fields(Options):
            if f.name in d and d[f.name] != getattr(defaults, f.name):
                merged[f.name] = d[f.name]
        d = merged

    known = {f.name for f in dataclasses.fields(Options)}
    opt = Options(**{k: v for k, v in d.items() if k in known})
    opt.isTrain = is_train
    if not is_train:
        opt.serial_batches = True
        opt.no_flip = True
    opt.finalize()
    _print_options(opt, defaults)
    if save if save is not None else is_train:
        opt.save()
    return opt


def _print_options(opt: Options, defaults: Options) -> None:
    print("----------------- Options ---------------")
    for f in sorted(dataclasses.fields(Options), key=lambda f: f.name):
        v = getattr(opt, f.name)
        comment = ""
        if f.name != "isTrain" and v != getattr(defaults, f.name):
            comment = "\t[default: %s]" % str(getattr(defaults, f.name))
        print("{:>25}: {:<30}{}".format(f.name, str(v), comment))
    print("----------------- End -------------------")
