"""Serving export: a versioned, self-contained inference artifact
(counterpart of ``seg2eye_tpu/serving/export.py``).

The artifact is a ``torch.export`` program with a symbolic batch ("b"),
its weights inside, and a ``meta.json``; ``ServingModel`` loads and runs
it without the model code: no ``Options``, no ``models`` or ``refinenet``
module, no tracing.  What it imports is ``ops.spade_style``, whose
``seg2eye::spade_style`` op the Seg2Eye program calls at each of its norm
sites (the CUDA kernels on the card, the plain version on the CPU), and
``utils.precision``.

Artifact layout (directory):
    program.pt2   ``torch.export.save`` of the program and its weights
    meta.json     input/output spec, the options or config the program
                  baked in, the torch version and the export device

  * ``export_inference``: the scoring pipeline of ``eval/tester.py``:
    uint8 label map + uint8 style references -> (fake [-1,1] float32,
    fake bilinearly resized to the native size and truncated to [0,255],
    integer-valued float32): in-graph normalise, one-hot, the fused (b*k)
    encode, generate, resize, truncate.  k and the native size are baked.
  * ``export_refiner``: a RefineNet or SegNet task model on the running
    statistics, uint8 in, submission-ready outputs out.

What a program cannot carry:
  * its device.  The index tensors of the resizes are constants on the
    export device, and so are the weights: an artifact runs on the device
    it was exported on, which ``meta.json`` records; ``ServingModel``
    refuses any other and never moves the program.
  * cuDNN's TF32 flags, which are global.  A float32 artifact runs inside
    ``utils.precision.full_float32`` (``ServingModel.__call__``), as the
    live float32 model does.
  * per-sample encoding (``opt.per_sample_encode_enabled``): it loops over
    the batch, which a symbolic batch cannot unroll; the JAX package's
    export fails on it too.  ``export_inference`` refuses it.

Nothing on the exported path writes a buffer (no power iteration, no
running update): a mutation would be replayed at every call.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
from torch import nn
from torch.export.graph_signature import InputKind
from torch.utils._pytree import tree_unflatten

from seg2eye_tpu_torch.utils.precision import full_float32

PROGRAM = "program.pt2"
META = "meta.json"

FORMAT_VERSION = 1
# torch.export specialises the sizes 0 and 1, so the example batch is 2;
# the program then serves any batch from 1 up
EXAMPLE_BATCH = 2
MAX_BATCH = 4096


def _batch_dim():
    return torch.export.Dim("b", min=1, max=MAX_BATCH)


def _device_of(module: nn.Module) -> torch.device:
    """The device of the module's weights."""
    return _normalized(next(module.parameters()).device)


def _export(module: nn.Module, example: Tuple[torch.Tensor, ...]
            ) -> "torch.export.ExportedProgram":
    """The program of ``module`` on ``example``, batch symbolic in every
    input; no buffer may be written.  ``_drop_checks`` then takes out what
    would make its calls cost the host more than the live model's."""
    b = _batch_dim()
    with torch.no_grad():
        program = torch.export.export(
            module, example, dynamic_shapes=tuple({0: b} for _ in example),
            strict=False)
    mutated = program.graph_signature.buffers_to_mutate
    if mutated:
        raise RuntimeError(f"the exported program writes buffers: "
                           f"{sorted(mutated.values())}")
    _drop_checks(program)
    return program


_TO = (torch.ops.aten.to.dtype, torch.ops.aten.to.dtype_layout,
       torch.ops.aten.to.device)


def _drop_checks(program) -> None:
    """Take out of the graph, in place, the nodes that compute nothing:
    the ``_assert_tensor_metadata`` checks that export puts before each
    ``.to`` (163 in the Seg2Eye program), and the ``.to``s whose input
    already has the target dtype and device (which return their input;
    those that give a program output stay, as the graph's signature names
    them), with what only they used.  The checks recheck dtypes that
    follow from the inputs', which ``ServingModel`` checks against
    ``meta.json``.
    Every other node stays: a reshape, a contiguous or a view is decided
    at run time on the real strides, as in the live model."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target in _TO and _returns_input(program, node)
              and all(user.op != "output" for user in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    graph.eliminate_dead_code()
    program.graph_module.recompile()


def _returns_input(program, node) -> bool:
    """A ``.to`` that returns its input itself: the same dtype, device
    and layout, no copy and no memory format asked for."""
    src, out = node.args[0].meta.get("val"), node.meta.get("val")
    kwargs = node.normalized_arguments(
        program.graph_module, normalize_to_only_use_kwargs=True).kwargs
    return (isinstance(src, torch.Tensor) and isinstance(out, torch.Tensor)
            and (src.dtype, src.device, src.layout)
            == (out.dtype, out.device, out.layout)
            and not kwargs.get("copy", False)
            and kwargs.get("memory_format") in (None, torch.preserve_format))


def _save(program, meta: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=2, default=str)


class _Seg2EyeProgram(nn.Module):
    """The scoring pipeline as one module: G and E are its submodules, so
    their weights become the program's parameters."""

    def __init__(self, model, native_h: int, native_w: int):
        super().__init__()
        self.netG, self.netE = model.netG, model.netE
        self.model = model
        self.native_h, self.native_w = native_h, native_w

    def forward(self, label: torch.Tensor, style: torch.Tensor):
        from seg2eye_tpu_torch.ops.image import to_255resized

        fake = self.model.inference({"label": label, "style_image": style})
        return fake, to_255resized(fake, w=self.native_w, h=self.native_h)


def export_inference(model, out_dir: str,
                     native_hw: Tuple[int, int] = (640, 400),
                     k: Optional[int] = None
                     ) -> "torch.export.ExportedProgram":
    """Export ``model``'s (a ``Pix2Pix``) scoring pipeline to ``out_dir``
    (created if needed), on the device of its weights.

    The batch is symbolic: one artifact serves any batch size.  ``k``
    (style references per sample, default opt.input_ns) is baked in, as
    is the native size ``native_hw``, (H, W) as in eval/tester.py
    (OpenEDS: (640, 400)), and every option the forward reads: the
    statistics (``opt.eval_use_running_stats``) among them."""
    opt = model.opt
    if opt.per_sample_encode_enabled:
        raise ValueError(
            "per-sample encoding (--per_sample_encode on, or 'auto' with a "
            f"batch-subnorm encoder: norm_E={opt.norm_E!r}) runs the encoder "
            "once per sample, which a program with a symbolic batch cannot "
            "do; the JAX package's export refuses it too")
    k = int(opt.input_ns if k is None else k)
    h, w = opt.image_height, opt.image_width
    native_h, native_w = int(native_hw[0]), int(native_hw[1])
    module = _Seg2EyeProgram(model, native_h, native_w)
    device = _device_of(module)
    example = (torch.zeros((EXAMPLE_BATCH, h, w), dtype=torch.uint8,
                           device=device),
               torch.zeros((EXAMPLE_BATCH, k, h, w, 1), dtype=torch.uint8,
                           device=device))
    program = _export(module, example)
    meta = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": str(device),
        "inputs": {
            "label": {"shape": ["b", h, w], "dtype": "uint8",
                      "doc": "class-id segmentation map"},
            "style_image": {"shape": ["b", k, h, w, 1], "dtype": "uint8",
                            "doc": "style reference images, raw [0,255]"},
        },
        "outputs": {
            "fake": {"shape": ["b", h, w, 1], "dtype": "float32",
                     "doc": "generated image in [-1,1]"},
            "fake_255": {"shape": ["b", native_h, native_w, 1],
                         "dtype": "float32",
                         "doc": "native-size truncated [0,255] image "
                                "(integer-valued f32, as ops.image.to_255)"},
        },
        "baked_options": {
            f: getattr(opt, f)
            for f in ("ngf", "w_dim", "input_ns", "semantic_nc", "crop_size",
                      "aspect_ratio", "num_upsampling_layers", "norm_G",
                      "style_aggr_method", "compute_dtype",
                      "eval_use_running_stats")
        },
        "native_hw": [native_h, native_w],
    }
    _save(program, meta, out_dir)
    return program


class _RefinerProgram(nn.Module):
    """A task model's eval forward and its submission outputs."""

    def __init__(self, model, kind: str):
        super().__init__()
        self.net = model.net
        self.model = model
        self.kind = kind

    def forward(self, x: torch.Tensor):
        out = self.model.forward({"input": x}, train=False)
        if self.kind == "segnet":
            return out["prediction"].to(torch.uint8)
        pred = out["prediction"].to(torch.float32)
        pred_u8 = torch.clamp((pred + 1.0) * (255.0 / 2.0), 0, 255)
        return pred, pred_u8.to(torch.uint8)[..., 0]


def export_refiner(model, out_dir: str) -> "torch.export.ExportedProgram":
    """Export a RefineNet or SegNet task model as a serving artifact, on
    the device of its weights.

    * RefineNetModel: uint8 stack (b,H,W,3), colorised predicted mask |
      NN reference image | NN reference mask (refinenet/dataset.py) ->
      (prediction float32 [-1,1] (b,H,W,1), submission uint8 (b,H,W), the
      truncation of clip((pred+1)*255/2) of refinenet/evaluate_refinenet).
    * SegNetModel: uint8 grayscale image (b,H,W,1) -> uint8 class ids
      (b,H,W), the argmax prediction.

    The batch norms use their running statistics (``train=False``, as the
    reference's model.eval()); the batch is symbolic."""
    from seg2eye_tpu_torch.refinenet.model import RefineNetModel, SegNetModel

    cfg = model.cfg
    h, w = cfg.input_height, cfg.input_width
    if isinstance(model, RefineNetModel):
        kind, in_ch = "refinenet", 3
        outputs_meta = {
            "prediction": {"shape": ["b", h, w, 1], "dtype": "float32",
                           "doc": "refined image in [-1,1]"},
            "prediction_u8": {"shape": ["b", h, w], "dtype": "uint8",
                              "doc": "submission image, truncated "
                                     "clip((pred+1)*255/2)"},
        }
        input_doc = ("colorized predicted mask | NN reference image | "
                     "NN reference mask, raw [0,255]")
    elif isinstance(model, SegNetModel):
        kind, in_ch = "segnet", 1
        outputs_meta = {
            "prediction": {"shape": ["b", h, w], "dtype": "uint8",
                           "doc": "argmax class-id map (0..3)"},
        }
        input_doc = "grayscale eye image, raw [0,255]"
    else:
        raise TypeError(f"unsupported model {type(model).__name__}")
    module = _RefinerProgram(model, kind)
    device = _device_of(module)
    program = _export(module, (torch.zeros(
        (EXAMPLE_BATCH, h, w, in_ch), dtype=torch.uint8, device=device),))
    meta = {
        "format_version": FORMAT_VERSION,
        "model_type": kind,
        "torch_version": torch.__version__,
        "device": str(device),
        "inputs": {
            "input": {"shape": ["b", h, w, in_ch], "dtype": "uint8",
                      "doc": input_doc},
        },
        "outputs": outputs_meta,
        "baked_config": {
            **{f: getattr(cfg, f)
               for f in ("backbone", "output_stride", "resnet_depth",
                         "input_height", "input_width")},
            # what the program computes in: the model's dtype
            "compute_dtype": str(model.dtype).removeprefix("torch."),
        },
    }
    _save(program, meta, out_dir)
    return program


class ServingModel:
    """Loads an exported artifact and runs it, with no model code.

    ``device``: where the caller means to serve; it must be the export
    device (``meta["device"]``), which is also the default.  A call takes
    numpy arrays, copied to that device, or tensors already on it, and
    returns tensors on it: Seg2Eye artifacts take (label, style) and return
    (fake, fake_255); refiner artifacts take one input and return their
    meta-declared outputs.  An input of another dtype or shape than
    ``meta.json`` declares is refused.

    The program's graph is called with its weights as arguments
    (``weights``, in the order of its signature), not through
    ``ExportedProgram.module()``, whose generated code walks the module
    tree for every weight at every call: about 4000 attribute lookups per
    ResNet-101 call, host time the live model does not spend."""

    def __init__(self, art_dir: str, device: Optional[str] = None):
        with open(os.path.join(art_dir, META)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta.get('format_version')} != "
                f"supported {FORMAT_VERSION}")
        self.device = torch.device(self.meta["device"])
        if device is not None and _normalized(device) != self.device:
            raise ValueError(
                f"the artifact in {art_dir} was exported on {self.device} "
                f"and runs only there, not on {device}: export it again on "
                "that device")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the artifact in {art_dir} runs on "
                               f"{self.device}, and no CUDA device is "
                               "available")
        # registers seg2eye::spade_style, which the Seg2Eye program calls
        from seg2eye_tpu_torch.ops import spade_style  # noqa: F401

        self.program = torch.export.load(os.path.join(art_dir, PROGRAM))
        state = {**self.program.state_dict, **self.program.constants}
        self.weights = [state[spec.target] for spec in
                        self.program.graph_signature.input_specs
                        if spec.kind != InputKind.USER_INPUT]
        config = self.meta.get("baked_options") or self.meta["baked_config"]
        self.float32 = config["compute_dtype"] == "float32"
        self.inputs = self.meta["inputs"]

    def _input(self, name: str, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"{name} is on {x.device}; this artifact "
                                 f"runs on {self.device}")
        else:
            x = torch.as_tensor(x).to(self.device)
        spec = self.inputs[name]
        if x.dtype != getattr(torch, spec["dtype"]):
            raise ValueError(f"{name} is {x.dtype}; this artifact takes "
                             f"{spec['dtype']}")
        if (x.dim() != len(spec["shape"]) or list(x.shape[1:]) != spec[
                "shape"][1:] or not 1 <= x.shape[0] <= MAX_BATCH):
            raise ValueError(f"{name} is {tuple(x.shape)}; this artifact "
                             f"takes {spec['shape']}, b in 1..{MAX_BATCH}")
        return x

    def __call__(self, *inputs):
        if len(inputs) != len(self.inputs):
            raise ValueError(f"this artifact takes {len(self.inputs)} "
                             f"inputs ({', '.join(self.inputs)}), got "
                             f"{len(inputs)}")
        args = [self._input(name, x) for name, x in zip(self.inputs, inputs)]
        with torch.no_grad(), full_float32(self.float32):
            flat = self.program.graph_module(*self.weights, *args)
        return tree_unflatten(list(flat), self.program.call_spec.out_spec)


def _normalized(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return device


def load_serving(art_dir: str, device: Optional[str] = None) -> ServingModel:
    return ServingModel(art_dir, device)
