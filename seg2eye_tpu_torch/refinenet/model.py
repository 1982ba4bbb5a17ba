"""RefineNet (residual refiner) and SegNet (mask predictor), the counterparts
of ``seg2eye_tpu/refinenet/model.py``.

  * RefineNet: DeepLab(num_classes=1) over a 3-channel stack (colorised
    target mask | nearest-neighbour image | its mask); prediction =
    clamp(residual + neighbour image, -1, 1); ``l1_loss``,
    ``per_image_score`` = sqrt(sum((255/2 (pred - true))^2)) / (H*W),
    ``score`` = 1471 * mean, ``eds_loss`` = mean.
  * SegNet ('MyDeepLab'): DeepLab(num_classes=4) over a grayscale image
    repeated to 3 channels; cross-entropy (``ops.classhead``), argmax
    prediction and pixel accuracy.

The model owns its DeepLab (``net``), whose state_dict is the reference's.
Batches and outputs keep the JAX package's layouts: input (B,H,W,3) or
(B,H,W,1), target (B,H,W,1) (SegNet: (B,H,W) or (B,H,W,1) class ids),
prediction and residual (B,H,W,1) (SegNet: (B,H,W) int32), logits
(B,H,W,C).  uint8 images are normalised on the device with the host's
formula x * (2/255) - 1 in float32.  Dropout runs only when ``forward`` is
given a generator, as the JAX package's runs only with an rng; a float32
model's forward runs in full float32 (``utils.precision``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from seg2eye_tpu_torch.models.deeplab import DeepLab
from seg2eye_tpu_torch.ops.classhead import sliced_argmax, sliced_nll
from seg2eye_tpu_torch.utils.precision import full_float32
from seg2eye_tpu_torch.utils.weights import init_deeplab

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_pretrained_backbone(net: DeepLab, path: str) -> DeepLab:
    """Load a torch ``.pth`` state_dict of ``net``'s backbone under the
    reference's names into ``net.backbone``: for ResNet the keys of the
    torchvision ResNet the reference bootstraps from (``conv1.weight``,
    ``bn1.*``, ``layer1.0.conv1.weight``, ...), for Xception, DRN and
    MobileNet those of the reference's backbone modules (what
    ``utils.weights.export_{xception,drn}_backbone`` write).  Any missing
    or unexpected key raises."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    net.backbone.load_state_dict(state, strict=True)
    return net


def _norm_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 transport -> [-1,1] float32 (dataset.preprocess_image's
    x * (2/255) - 1); anything else unchanged."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * (2.0 / 255.0) - 1.0
    return x


class _TaskModel:
    num_classes = 1

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.net: Optional[DeepLab] = None

    def init(self, generator: torch.Generator) -> "_TaskModel":
        """Seeded weights (``utils.weights.init_deeplab``, drawn from the
        CPU ``generator``), then the pretrained backbone if configured."""
        net = init_deeplab(self.cfg, self.num_classes, generator, "cpu")
        if self.cfg.pretrained_backbone:
            load_pretrained_backbone(net, self.cfg.pretrained_backbone)
        self.net = net.to(self.device)
        return self

    def _run(self, x: torch.Tensor, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B,H,W,3) in the compute dtype -> (B,H,W,C) float32."""
        with full_float32(self.dtype == torch.float32):
            out = self.net(x.permute(0, 3, 1, 2), train,
                           generator if train else None)
        return out.float().permute(0, 2, 3, 1)


class RefineNetModel(_TaskModel):
    def forward(self, batch: Dict, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The output dict of a (B,H,W,3) batch, with the losses and the
        score when it has a target."""
        x = _norm_input(batch["input"]).to(self.dtype)
        residual = self._run(x, train, generator)
        reference = x[..., 1:2].float()           # the neighbour's image
        y_pred = torch.clamp(residual + reference, -1.0, 1.0)
        out = {"input": x, "residual": residual, "prediction": y_pred}
        y_true = batch.get("target")
        if y_true is not None:
            y_true = _norm_input(y_true).float()
            out["groundtruth"] = y_true
            out["l1_loss"] = torch.mean(torch.abs(y_pred - y_true))
            h, w = y_true.shape[1], y_true.shape[2]
            sq = (255.0 / 2.0 * (y_pred - y_true)) ** 2
            per_image = torch.sqrt(
                torch.sum(sq.reshape(sq.shape[0], -1), dim=-1)) / float(h * w)
            out["per_image_score"] = per_image
            out["score"] = 1471.0 * torch.sum(per_image) / y_true.shape[0]
            out["eds_loss"] = torch.mean(per_image)
        return out


class SegNetModel(_TaskModel):
    """4-class eye segmentation ('MyDeepLab')."""

    def __init__(self, cfg, device: str | torch.device = "cuda",
                 num_classes: int = 4):
        super().__init__(cfg, device)
        self.num_classes = num_classes

    def forward(self, batch: Dict, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The output dict of a (B,H,W,1) batch, with the loss and the
        accuracy when it has a target."""
        img = _norm_input(batch["input"]).to(self.dtype)
        x = img.expand(*img.shape[:-1], 3).contiguous()      # 1ch -> 3ch
        logits = self._run(x, train, generator)
        out = {"input": x, "logits": logits}
        labels = batch.get("target")
        if labels is None:
            out["prediction"] = sliced_argmax(logits)
            return out
        labels = labels.long()
        if labels.dim() == 4:
            labels = labels[..., 0]
        # out-of-range labels poison their pixels' nll with NaN
        ce, pred = sliced_nll(logits, labels)
        out["prediction"] = pred
        out["ce_loss"] = torch.mean(ce)
        out["accuracy"] = torch.mean((pred == labels).float())
        return out
