"""Gaze losses, the experts variants included (counterpart of
``seg2eye_tpu/refinenet/losses.py``; reference: refinenet/losses/
{angular_error,gaze_mse_error,experts_angular_error,
experts_gaze_mse_error}.py), on tensors.  Vestigial in the OpenEDS entry
points (no trainer constructs them) but part of the public loss API.

The JAX package's conventions, kept:
  * pitchyaw (..., 2) -> [cos(p) sin(y), -sin(p), cos(p) cos(y)]; note
    the sign against ``utils.gaze``'s +sin(p) (a reflection: pairwise
    errors agree between the two);
  * 3-vectors are normalised over the vector axis, x / max(||x||, 1e-12);
  * the cosine similarity, dot / max(||a|| ||b||, 1e-8), clipped to
    +-(1 - 1e-8) before acos; errors in degrees.
"""
from __future__ import annotations

import math

import torch

_TO_DEGREES = 180.0 / math.pi


def to_vector(a: torch.Tensor) -> torch.Tensor:
    """(..., 2) pitchyaw radians or (..., 3) vectors -> (..., 3) gaze
    vectors."""
    if a.shape[-1] == 2:
        sin, cos = torch.sin(a), torch.cos(a)
        return torch.stack([cos[..., 0] * sin[..., 1], -sin[..., 0],
                            cos[..., 0] * cos[..., 1]], dim=-1)
    if a.shape[-1] == 3:
        n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        return a / torch.clamp(n, min=1e-12)
    raise ValueError(f"Do not know how to convert tensor of size "
                     f"{tuple(a.shape)}")


def angular_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row angular error in degrees, (N, 2|3) -> (N,); broadcasts."""
    va, vb = to_vector(a), to_vector(b)
    denom = torch.clamp(torch.linalg.vector_norm(va, dim=-1)
                        * torch.linalg.vector_norm(vb, dim=-1), min=1e-8)
    sim = torch.sum(va * vb, dim=-1) / denom
    sim = torch.clamp(sim, -1.0 + 1e-8, 1.0 - 1e-8)
    return torch.arccos(sim) * _TO_DEGREES


def gaze_mse_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar MSE between gaze vectors."""
    return torch.mean((to_vector(a) - to_vector(b)) ** 2)


def experts_angular_error(pred_experts: torch.Tensor,
                          true: torch.Tensor) -> torch.Tensor:
    """(B, E, 2|3) expert predictions against (B, 2) ground truth -> (B, E)
    per-expert angular error in degrees."""
    assert true.shape[-1] == 2, true.shape
    return angular_error(pred_experts, to_vector(true)[:, None, :])


def experts_gaze_mse_error(pred_experts: torch.Tensor,
                           true: torch.Tensor) -> torch.Tensor:
    """(B, E, 2|3) against (B, 2) -> (B, E) per-expert MSE over the vector
    axis."""
    assert true.shape[-1] == 2, true.shape
    diff = to_vector(pred_experts) - to_vector(true)[:, None, :]
    return torch.mean(diff ** 2, dim=-1)
