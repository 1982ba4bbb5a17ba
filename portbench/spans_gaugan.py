"""The name of the port's VGG-loss span (``models.pix2pix.Pix2Pix.vgg_loss``,
``seg2eye_tpu_torch/utils/spans.py``'s ``LOSS_VGG``), kept beside
``spans.py``'s names so that the benchmark imports nothing of the port.  A
program without it (an older checkout) gives ``vgg_ms.train`` nothing to
read: ``spans.span_ms`` returns None."""
from __future__ import annotations

LOSS_VGG = "loss.vgg"

NAMES = (LOSS_VGG,)
