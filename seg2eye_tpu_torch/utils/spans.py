"""Named phase spans of the port, recorded through ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and one shared no-op context otherwise: off, a span
costs one flag check (``torch.autograd._profiler_enabled``, thread-local
state that the autograd engine carries to its device threads), not a
range's enter and exit.  There is no switch: spans exist exactly while a
``torch.profiler`` records (``--profile_steps``, the benchmark's traced
slice, an operator's own profiler), on the device trace's clock.  Export
(``serving.export``, non-strict) traces with no profiler on, so no range
enters an exported graph.

Where each span opens, and what reads it:

  * ``G_STEP``, ``D_STEP``: ``train.steps``' G and D updates, read in
    ``--profile_steps``' chrome trace, where they tell the G step's
    forward, backward and optimizer from the D step's;
  * ``FORWARD``, ``BACKWARD``, ``OPTIMIZER``: inside every training step
    (Seg2Eye's G and D steps, RefineNet's ``Trainer.train_step``,
    segtrain's ``SegTrainer.train_step``): the forward and loss (the D
    step's regenerated fake included), the loss's backward, and the
    gradient all-reduce, clip, optimizer step and buffer broadcast;
  * ``DEEPLAB_BACKBONE``, ``DEEPLAB_ASPP``, ``DEEPLAB_DECODER``: the three
    stages of ``models.deeplab.DeepLab.forward`` (the decoder's span
    holds the last upsample to the input), in RefineNet and segtrain
    alike, read by the benchmark's ``backbone_ms.train`` and
    ``aspp_ms.train`` (forward device time: the backward's kernels start
    outside them);
  * ``NCHW_COPY``: each NCHW copy ``models.layers.apply_conv`` makes for
    a conv (``layers.nchw_copy``), one span per copy: a counter, read by
    ``nchw_copies.train``;
  * ``BN_ACT``: each launch of the eval BN, residual add and ReLU kernel
    (``ops.bn_act.bn_act_cuda``), one span per launch: a counter, read by
    ``bn_act_passes.infer``;
  * ``REFINENET_SERVE``: RefineNet's ``Trainer.eval_step``, whole;
  * ``SCORE``: ``Tester.score_batch``, whole;
  * ``TO_DEVICE``: host-to-device copies of batches
    (``data.openeds.to_device``, ``Pix2Pix.preprocess``, the Tester's
    ``target_original``);
  * ``LOSS_VGG``: the VGG19 perceptual loss's forward
    (``models.pix2pix.Pix2Pix.vgg_loss``: fake and real through VGG19 and
    the weighted L1), read by ``vgg_ms.train``;
  * ``K1_PACK``: each packing of K1's weights (``ops.spade_style.
    PackedWeights``), one span per packing;
  * ``BACKWARD_RANGE``: the norm sites' backward (``ops.spade_style``,
    and GauGAN's ``ops.spade`` alike:
    the backward kernel's route in bfloat16, the plain recompute in
    float32), on the autograd engine's device thread; its string, which
    still says "plain recompute", is what the benchmark's
    ``norm_bwd_ms.train`` reads, so it stays.

On a card the backward's kernels are launched from the autograd device
thread, so a span's device time is that of every op that starts inside
its host interval, on any thread (``portbench/spans.py``).
"""
from __future__ import annotations

import contextlib

import torch

G_STEP = "seg2eye.g_step"
D_STEP = "seg2eye.d_step"
FORWARD = "train.forward"
BACKWARD = "train.backward"
OPTIMIZER = "train.optimizer"
REFINENET_SERVE = "refinenet.serve"
SCORE = "seg2eye.score"
TO_DEVICE = "input.to_device"
K1_PACK = "seg2eye.k1_pack"
LOSS_VGG = "loss.vgg"
DEEPLAB_BACKBONE = "deeplab.backbone"
DEEPLAB_ASPP = "deeplab.aspp"
DEEPLAB_DECODER = "deeplab.decoder"
NCHW_COPY = "layers.nchw_copy"
BN_ACT = "layers.bn_act"
BACKWARD_RANGE = "spade_style backward (plain recompute)"

NAMES = (G_STEP, D_STEP, FORWARD, BACKWARD, OPTIMIZER, REFINENET_SERVE,
         SCORE, TO_DEVICE, K1_PACK, DEEPLAB_BACKBONE, DEEPLAB_ASPP,
         DEEPLAB_DECODER, NCHW_COPY, BN_ACT, BACKWARD_RANGE, LOSS_VGG)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
