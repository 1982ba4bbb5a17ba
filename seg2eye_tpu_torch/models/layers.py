"""Shared building blocks (counterpart of ``seg2eye_tpu/models/layers.py``).

  * ``SpectralConv`` keeps torch's spectral-norm state names:
    ``weight_orig`` (a parameter) and ``weight_u``/``weight_v`` (buffers),
    and divides by ``sigma = u . (W.view(O,-1) @ v)`` with u and v held
    constant.  A training forward (``update_stats=True``) first runs one
    power iteration under ``no_grad``, v = normalize(W^T u) then
    u = normalize(W v), and stores both as NEW tensors: a graph saved by an
    earlier forward keeps the pair it used.  Otherwise the stored pair is
    used as it is.  ``torch.nn.utils.spectral_norm`` is not used because its
    hook power-iterates on every forward in train mode.
  * ``make_conv``/``apply_conv`` are the DeepLab stacks' convolutions
    (padding from the kernel and dilation, the kaiming fan mode kept on
    the module; the layout rule ``nchw_copy``), and ``Bottleneck`` the
    ResNet block that the DeepLab ResNet and DRN-D share.
  * ``BatchNorm`` is the affine batch norm of the DeepLab stacks, with
    the JAX package's ``TorchBatchNorm`` semantics (torch's);
    ``BatchSubNorm`` is the same norm after an encoder or discriminator
    conv (``norm_E``/``norm_D = 'spectralbatch'``).  Under data
    parallelism (``parallel.data_parallel.active``) both take their batch
    statistics over the global batch, as the JAX package's do over a
    sharded batch axis.
  * ``instance_norm`` is torch ``InstanceNorm2d(affine=False)``: biased
    statistics over (H, W), eps 1e-5, computed in at least float32.
  * ``FCStyle`` is the StyleGAN FC layer: linear in float32, LeakyReLU(0.2).
  * Initialisers follow the JAX package: the six ``weight_init`` schemes
    with torch's fan convention (the fan includes the receptive field),
    the He init for ``FCStyle``, zero biases, and a random normalised
    spectral ``u`` with ``v = normalize(W^T u)``.

Activations are NCHW tensors; the convolutions run in the compute dtype of
their input, with float32 parameters cast at the call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seg2eye_tpu_torch.parallel import data_parallel as dp
from seg2eye_tpu_torch.parallel import tensor_parallel as tp

EPS = 1e-5


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Widen bf16 to f32; keep f32 and f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def nchw_copy(x: torch.Tensor, conv: nn.Conv2d) -> bool:
    """Whether ``conv`` reads an NCHW copy of its channels_last input:
    every float32 dilated conv and every dilated depthwise conv, from
    their times on an H100 (``tools/time_torch_convs.py``).  cuDNN's
    float32 choice for the ASPP's 2048-channel dilated convs at batch 32
    on channels_last input is a grouped direct kernel, 470 ms a conv
    against 14 ms on NCHW input; dilated depthwise convs run 1.9-3.6
    times faster on an NCHW copy in both dtypes, the copy included.
    Undilated depthwise convs and bfloat16 dense convs are faster on
    channels_last."""
    return conv.dilation[0] > 1 and (x.dtype == torch.float32
                                     or conv.groups > 1)


def apply_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in x's dtype, on an NCHW copy of x where
    ``nchw_copy`` says so.  The copy is a ``clone``, made even when x is
    NCHW already: ``torch.export`` records a ``contiguous()`` only where
    the traced x is not contiguous, and its traced convolutions on CUDA
    come out NCHW where the card's are channels_last, so a serving
    program would run these convs on channels_last input (1273 ms a
    batch on an H100, not 219)."""
    if nchw_copy(x, conv):
        x = x.clone(memory_format=torch.contiguous_format)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def make_conv(cin: int, cout: int, k: int, stride: int = 1,
              dilation: int = 1, padding: Optional[int] = None,
              groups: int = 1, bias: bool = False,
              init_mode: str = "fan_in") -> nn.Conv2d:
    """A conv whose padding is ((k-1)//2)*dilation unless given; its
    kaiming mode is kept for ``models.deeplab.kaiming_init_``."""
    pad = ((k - 1) // 2) * dilation if padding is None else padding
    conv = nn.Conv2d(cin, cout, k, stride, pad, dilation, groups, bias)
    conv.init_mode = init_mode
    return conv


def _torch_fans(shape) -> Tuple[int, int]:
    """fan_in/fan_out of an OIHW conv weight or an (out, in) linear weight."""
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def xavier_normal_(w: torch.Tensor, gain: float,
                   generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _torch_fans(w.shape)
    return w.normal_(0.0, gain * (2.0 / (fan_in + fan_out)) ** 0.5,
                     generator=generator)


@torch.no_grad()
def he_fc_(w: torch.Tensor, gain: float,
           generator: torch.Generator) -> torch.Tensor:
    """StyleGAN FC init: randn * gain * fan_in^-0.5."""
    fan_in, _ = _torch_fans(w.shape)
    return w.normal_(0.0, gain * fan_in ** -0.5, generator=generator)


def weight_init(init_type: str, gain: float):
    """-> an in-place initialiser ``f(weight, generator)`` for conv and
    linear weights (OIHW or (out, in)), one per scheme of the JAX
    package's ``weight_init``: xavier (normal, ``gain``), normal (N(0,
    gain)), xavier_uniform (gain 1), kaiming (normal, fan_in, ReLU gain),
    orthogonal (``gain``; the rows of the (out, in * kh * kw) matrix, the
    columns of JAX's (kh * kw * in, out) one, orthonormal) and none
    (U(+-sqrt(3 / fan_in)), what the JAX package's 'none' draws; its
    comment names torch's conv default, U(+-1/sqrt(fan_in)), which is
    narrower)."""
    init = torch.nn.init
    schemes = {
        "xavier": lambda w, g: xavier_normal_(w, gain, g),
        "normal": lambda w, g: init.normal_(w, 0.0, gain, generator=g),
        "xavier_uniform": lambda w, g: init.xavier_uniform_(w, 1.0,
                                                           generator=g),
        "kaiming": lambda w, g: init.kaiming_normal_(
            w, 0.0, "fan_in", "relu", generator=g),
        "orthogonal": lambda w, g: init.orthogonal_(w, gain, generator=g),
        "none": lambda w, g: init.kaiming_uniform_(
            w, 0.0, "fan_in", "linear", generator=g),
    }
    if init_type not in schemes:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    return torch.no_grad()(schemes[init_type])


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def instance_norm(x: torch.Tensor, eps: float = EPS,
                  band=None) -> torch.Tensor:
    """Param-free instance norm over (H, W) of an NCHW tensor; of an H band
    (``parallel.spatial.Band``) with the whole map's statistics."""
    x32 = at_least_f32(x)
    if band is None:
        var, mean = torch.var_mean(x32, dim=(2, 3), keepdim=True,
                                   correction=0)
    else:
        var, mean = (t[:, :, None, None] for t in band.var_mean(x32, (2, 3)))
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def parse_nonspade_norm(norm_type: str) -> Tuple[bool, str]:
    """'spectralinstance' -> (spectral=True, 'instance')."""
    spectral = norm_type.startswith("spectral")
    sub = norm_type[len("spectral"):] if spectral else norm_type
    if sub not in ("", "none", "instance", "batch"):
        raise ValueError(f"normalization layer {sub} is not recognized")
    return spectral, sub


class SubNorm(nn.Module):
    """The param-free norm after an encoder or discriminator conv: instance
    norm or none (``sub_norm`` gives the affine 'batch' one)."""

    def __init__(self, sub: str = "instance"):
        super().__init__()
        if sub not in ("", "none", "instance"):
            raise ValueError(sub)
        self.sub = sub

    def forward(self, x: torch.Tensor, use_running_average: bool = False,
                update_stats: bool = False, band=None) -> torch.Tensor:
        return instance_norm(x, band=band) if self.sub == "instance" else x


def sub_norm(sub: str, num_features: int) -> nn.Module:
    """The norm that ``norm_E``/``norm_D``'s sub-norm names."""
    return (BatchSubNorm(num_features) if sub == "batch"
            else SubNorm(sub))


class BatchNorm(nn.BatchNorm2d):
    """Affine batch norm with ``TorchBatchNorm``'s semantics, which are
    torch's: a training forward (``train=True``) normalises with the
    biased variance of the batch and blends the unbiased one into
    ``running_var`` (momentum 0.1, eps 1e-5); otherwise the running
    statistics normalise.  Statistics and normalisation are computed in at
    least float32; the result has the input's dtype.  ``train`` is an
    argument, as in the JAX package, not the module's mode.  The
    state_dict is ``BatchNorm2d``'s, ``num_batches_tracked`` included."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=EPS, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            self.num_batches_tracked.add_(1)
            if dp.active():
                return self._synced(x, update=True)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, train, self.momentum,
                            self.eps)

    def _synced(self, x: torch.Tensor, update: bool,
                band=None) -> torch.Tensor:
        """Batch statistics of the global batch (every rank's samples,
        ``parallel.data_parallel.synced_var_mean``), or of the whole map
        of an H ``band``, the running ones updated with them when
        ``update``; in at least float32, returned in x's dtype."""
        x32 = at_least_f32(x)
        var, mean, count = dp.synced_var_mean(
            x32, (0, 2, 3), over=None if band is None else band.group)
        if update:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (count / (count - 1).clamp(min=1))
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        scale = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * scale
        return (x32 * scale[:, None, None]
                + shift[:, None, None]).to(x.dtype)


class Bottleneck(nn.Module):
    """The ResNet bottleneck (1x1, 3x3 at ``stride`` and ``dilation``, 1x1
    to 4 x planes, each with a BN; a 1x1/BN projection of the residual
    where ``downsample``), of the DeepLab ResNet and of DRN-D."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = make_conv(cin, planes, 1, init_mode="fan_out")
        self.bn1 = BatchNorm(planes)
        self.conv2 = make_conv(planes, planes, 3, stride, dilation,
                               init_mode="fan_out")
        self.bn2 = BatchNorm(planes)
        self.conv3 = make_conv(planes, planes * 4, 1, init_mode="fan_out")
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            make_conv(cin, planes * 4, 1, stride, init_mode="fan_out"),
            BatchNorm(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = torch.relu(self.bn1(apply_conv(x, self.conv1), train))
        out = torch.relu(self.bn2(apply_conv(out, self.conv2), train))
        out = self.bn3(apply_conv(out, self.conv3), train)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](
                apply_conv(x, self.downsample[0]), train)
        return torch.relu(out + residual)


class BatchSubNorm(BatchNorm):
    """The affine 'batch' sub-norm (JAX ``SubNorm('batch')``, a
    ``TorchBatchNorm``): batch statistics, with the running ones updated
    on a training forward (``update_stats``), or the running statistics
    with ``use_running_average``.  The preceding conv has no bias; the
    scale is initialised N(1, init_variance) (``utils.weights``)."""

    stats_log: Optional[list] = None

    def forward(self, x: torch.Tensor, use_running_average: bool = False,
                update_stats: bool = False, band=None) -> torch.Tensor:
        update = update_stats and not use_running_average
        if update and self.stats_log is not None:
            return self._logged(x)
        if update:
            self.num_batches_tracked.add_(1)
        if not use_running_average and (band is not None or dp.active()):
            return self._synced(x, update, band)
        stats = (self.running_mean, self.running_var) \
            if update or use_running_average else (None, None)
        y = F.batch_norm(at_least_f32(x), *stats, self.weight, self.bias,
                         not use_running_average, self.momentum, self.eps)
        return y.to(x.dtype)

    def _logged(self, x: torch.Tensor) -> torch.Tensor:
        """A training forward with this rank's batch statistics whose
        running update is deferred: (mean, unbiased variance) go to
        ``stats_log`` and the running statistics stay (per-sample encoding
        under data parallelism replays every sample's update in global
        order, ``Pix2Pix.encode_w``)."""
        x32 = at_least_f32(x)
        var, mean = torch.var_mean(x32.detach(), dim=(0, 2, 3), correction=0)
        n = x.numel() // x.shape[1]
        self.stats_log.append((mean, var * (n / max(n - 1, 1))))
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True,
                         self.momentum, self.eps)
        return y.to(x.dtype)


class SpectralConv(nn.Module):
    """Conv2d with optional spectral normalisation, torch parameter names."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True,
                 spectral: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.spectral = spectral
        w = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        if spectral:
            self.weight_orig = w
            self.register_buffer("weight_u", torch.zeros(out_ch))
            self.register_buffer("weight_v", torch.zeros(in_ch * k * k))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def kernel(self, update_stats: bool = False) -> torch.Tensor:
        """The normalised weight.  Of a tensor-parallel slice of the weight
        (``parallel.tensor_parallel``) it is this rank's rows of the whole
        matrix's W / sigma: v = normalize(sum over the model ranks of
        W_m^T u_m), u = normalize(W v) from the rows gathered (u stays
        whole), sigma = sum of u_m . (W_m v), all over the model group."""
        if not self.spectral:
            return self.weight
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        if not tp.is_sharded(w):
            if update_stats:
                with torch.no_grad():
                    v = _l2_normalize(mat.T @ self.weight_u)
                    self.weight_u = _l2_normalize(mat @ v)
                    self.weight_v = v
            sigma = torch.dot(self.weight_u, mat @ self.weight_v)
            return w / sigma
        mine = tp.rows(self.weight_u.shape[0])
        if update_stats:
            with torch.no_grad():
                v = _l2_normalize(tp.model_sum(mat.T @ self.weight_u[mine]))
                self.weight_u = _l2_normalize(tp.gather(mat @ v, 0))
                self.weight_v = v
        sigma = tp.model_sum(torch.dot(self.weight_u[mine],
                                       mat @ self.weight_v))
        return w / sigma

    @torch.no_grad()
    def reset_parameters(self, init, generator: torch.Generator) -> None:
        w = self.weight_orig if self.spectral else self.weight
        init(w, generator)
        if self.bias is not None:
            self.bias.zero_()
        if self.spectral:
            u = torch.empty_like(self.weight_u).normal_(generator=generator)
            u = _l2_normalize(u)
            self.weight_u.copy_(u)
            self.weight_v.copy_(_l2_normalize(w.reshape(w.shape[0], -1).T @ u))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                kernel: torch.Tensor | None = None,
                band=None) -> torch.Tensor:
        """``kernel``: the normalised weight, computed by the caller with
        ``self.kernel`` (a recomputed forward reuses the first one's).
        ``band``: x is an H band (``parallel.spatial.Band``) whose rows
        divide by the stride; the output is the band of the output map,
        the rows beyond the band's edges read from its neighbours."""
        if kernel is None:
            kernel = self.kernel(update_stats)
        padding = self.padding
        if band is not None:
            k = kernel.shape[2]
            x = band.pad_rows(x, padding, k - self.stride - padding)
            padding = (0, padding)
        if self.spectral and tp.is_sharded(self.weight_orig):
            # w / sigma of a slice is a slice too: mark it for conv2d
            setattr(kernel, tp.ROWS, self.weight_u.shape[0])
        return tp.conv2d(x, kernel, self.bias, self.stride, padding)


class FCStyle(nn.Module):
    """StyleGAN 'FC' layer: float32 linear + LeakyReLU(0.2)."""

    def __init__(self, in_features: int, out_features: int,
                 gain: float = 1.0):
        super().__init__()
        self.gain = gain
        self.linear = nn.Linear(in_features, out_features)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        he_fc_(self.linear.weight, self.gain, generator)
        self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(at_least_f32(x), self.linear.weight, self.linear.bias)
        return F.leaky_relu(y, 0.2).to(x.dtype)
