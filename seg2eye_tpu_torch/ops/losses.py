"""GAN, reconstruction, style and perceptual losses (counterpart of
``seg2eye_tpu/ops/losses.py``).

  * ``gan_loss``: modes original | ls | hinge | w.  A multiscale
    discriminator's output (a list per scale of lists per layer) is scored
    on each scale's last entry, the logits, and averaged over the scales.
  * ``feature_matching_loss``: L1 between fake and detached real
    intermediates of every scale (the logits excluded), each weighted
    lambda_feat / num_D.
  * ``gram_matrix``/``style_gram_loss``: the StyleLoss of the reference.
  * ``multi_feature_mse``/``multi_gram_loss``: summed over encoder levels;
    both sides carry gradient, as in the reference (its ``.detach()`` there
    is not assigned).
  * ``vgg_loss``: SPADE's perceptual loss, L1 over the five relu{1..5}_1
    VGG19 slices weighted ``VGG_SLICE_WEIGHTS``.

Every loss is computed in at least float32.  Layouts do not matter to any
of them except ``gram_matrix``, which takes NCHW feature maps, as the
port's networks give them.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from seg2eye_tpu_torch.models.layers import at_least_f32


def _single_gan_loss(logits: torch.Tensor, target_is_real: bool,
                     for_discriminator: bool, mode: str) -> torch.Tensor:
    x = at_least_f32(logits)
    if mode == "original":
        target = 1.0 if target_is_real else 0.0
        # binary_cross_entropy_with_logits, mean-reduced
        return torch.mean(torch.clamp_min(x, 0) - x * target
                          + torch.log1p(torch.exp(-x.abs())))
    if mode == "ls":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((x - target) ** 2)
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.mean(torch.clamp_max(x - 1.0, 0.0))
            return -torch.mean(torch.clamp_max(-x - 1.0, 0.0))
        # the generator's hinge aims for real
        return -torch.mean(x)
    if mode == "w":
        return -torch.mean(x) if target_is_real else torch.mean(x)
    raise ValueError(f"Unexpected gan_mode {mode}")


def gan_loss(preds, target_is_real: bool, for_discriminator: bool,
             mode: str = "hinge") -> torch.Tensor:
    """GAN loss of one logits tensor, or of a multiscale output."""
    if isinstance(preds, (list, tuple)):
        total = 0.0
        for pred_i in preds:
            if isinstance(pred_i, (list, tuple)):
                pred_i = pred_i[-1]
            total = total + _single_gan_loss(pred_i, target_is_real,
                                             for_discriminator, mode)
        return total / len(preds)
    return _single_gan_loss(preds, target_is_real, for_discriminator, mode)


def feature_matching_loss(pred_fake: Sequence[Sequence[torch.Tensor]],
                          pred_real: Sequence[Sequence[torch.Tensor]],
                          lambda_feat: float) -> torch.Tensor:
    num_d = len(pred_fake)
    total = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            l1 = torch.mean(torch.abs(at_least_f32(pred_fake[i][j])
                                      - at_least_f32(pred_real[i][j].detach())))
            total = total + l1 * (lambda_feat / num_d)
    return total


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(at_least_f32(a) - at_least_f32(b)))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((at_least_f32(a) - at_least_f32(b)) ** 2)


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """Gram matrix of an NCHW batch flattened to (B*C, H*W), in at least
    float32, over B*C*H*W."""
    b, c, h, w = feat.shape
    f = at_least_f32(feat).reshape(b * c, h * w)
    return (f @ f.T) / (b * c * h * w)


def style_gram_loss(feat_fake: torch.Tensor,
                    feat_real: torch.Tensor) -> torch.Tensor:
    """MSE between Gram matrices, the target detached."""
    return torch.mean((gram_matrix(feat_fake)
                       - gram_matrix(feat_real).detach()) ** 2)


def multi_feature_mse(feats_fake: List[torch.Tensor],
                      feats_real: List[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for ff, fr in zip(feats_fake, feats_real):
        total = total + l2_loss(ff, fr)
    return total


def multi_gram_loss(feats_fake: List[torch.Tensor],
                    feats_real: List[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for ff, fr in zip(feats_fake, feats_real):
        total = total + style_gram_loss(ff, fr)
    return total


VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(feats_fake: List[torch.Tensor],
             feats_real: List[torch.Tensor]) -> torch.Tensor:
    """Weighted L1 over the VGG19 slices; the real features come from data
    and carry no generator gradient."""
    total = 0.0
    for wt, ff, fr in zip(VGG_SLICE_WEIGHTS, feats_fake, feats_real):
        total = total + wt * l1_loss(ff, fr)
    return total
