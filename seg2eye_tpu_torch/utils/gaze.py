"""Gaze math (the port's copy of ``seg2eye_tpu/utils/gaze.py``; reference:
refinenet/core/gaze.py:6-71 and refinenet/losses/angular_error.py):
vestigial in the OpenEDS path but part of the public surface.  numpy
functions, and ``angular_error_torch``, the tensor form of the JAX
package's ``angular_error_jax``."""
from __future__ import annotations

import math

import numpy as np
import torch


def pitchyaw_to_vector(pitchyaws: np.ndarray) -> np.ndarray:
    """(N,2) [pitch, yaw] radians -> (N,3) unit gaze vectors."""
    sin = np.sin(pitchyaws)
    cos = np.cos(pitchyaws)
    return np.stack([cos[:, 0] * sin[:, 1], sin[:, 0],
                     cos[:, 0] * cos[:, 1]], axis=1)


def vector_to_pitchyaw(vectors: np.ndarray) -> np.ndarray:
    """(N,3) gaze vectors -> (N,2) [pitch, yaw] radians."""
    n = vectors / np.linalg.norm(vectors, axis=1, keepdims=True)
    return np.stack([np.arcsin(n[:, 1]),
                     np.arctan2(n[:, 0], n[:, 2])], axis=1)


def angular_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row angular error in degrees between pitchyaw arrays."""
    va, vb = pitchyaw_to_vector(a), pitchyaw_to_vector(b)
    sim = np.sum(va * vb, axis=1) / (
        np.linalg.norm(va, axis=1) * np.linalg.norm(vb, axis=1))
    sim = np.clip(sim, -1.0 + 1e-7, 1.0 - 1e-7)
    return np.degrees(np.arccos(sim))


def angular_error_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angular error (degrees) between pitchyaw batches, on tensors."""
    def to_vec(py):
        sin, cos = torch.sin(py), torch.cos(py)
        return torch.stack([cos[:, 0] * sin[:, 1], sin[:, 0],
                            cos[:, 0] * cos[:, 1]], dim=1)
    va, vb = to_vec(a), to_vec(b)
    sim = torch.sum(va * vb, dim=1) / (
        torch.linalg.vector_norm(va, dim=1)
        * torch.linalg.vector_norm(vb, dim=1))
    sim = torch.clamp(sim, -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.arccos(sim) * (180.0 / math.pi)
