"""Float32 that stays float32 on the card.

PyTorch lets cuDNN run float32 convolutions in TF32 by default, about
1e-3 from float32.  The port's float32 models run their forwards, and the
trainers their whole steps (cuDNN reads the flags when each backward
convolution runs), inside ``full_float32``.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32(enabled: bool = True):
    """Inside, cuDNN convolutions and matmuls of float32 tensors run in
    full float32, not TF32 (PyTorch lets cuDNN use TF32 by default); the
    two flags are restored on exit.  The flags matter on CUDA only.  Not
    ``torch.backends.cudnn.flags``, whose defaults would also reset
    cuDNN's ``enabled``, ``benchmark`` and ``deterministic``."""
    if not enabled:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
