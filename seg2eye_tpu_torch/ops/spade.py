"""Plain SPADE norm (GauGAN's, Park et al. 2019): the CUDA kernels, their
plain PyTorch version and the dispatcher.

Per norm site (NVlabs/SPADE ``models/networks/normalization.py``, SPADE):

    actv  = relu(conv3x3(seg, ws) + bs)          # 128-ch hidden, cuDNN
    gamma = conv3x3(actv, wg) + bg               # C-ch  } in the kernel,
    beta  = conv3x3(actv, wb) + bb               #       } never in HBM
    out   = normalize(x) * (1 + gamma) + beta

It replaces no TPU kernel: the JAX package builds only the SPADE+Style
generator.  The kernels are K1's (``ops.spade_style``,
``csrc/spade_style_sm90.cu``) instantiated without the style term (the
``*_nostyle`` kernels): the same TMA + ``wgmma`` mainloop over the same
packed weights, which come from the same cache
(``spade_style.packed_weights``, one ``seg2eye.k1_pack`` span per
packing), the same launch code, and an epilogue with no AdaIN term and no
halving.  K1's own epilogue cannot express it: s0 = -1 and s1 = 0 still
leave spade / 2.

``spade`` is the entry point.  It calls the ``seg2eye::spade`` op, whose
registrations choose by device: a CPU tensor takes the plain version,
``spade_reference``; a CUDA tensor takes its dtype's kernel (bfloat16 in
one pass, float32 in 3xTF32) or raises.  The backward chooses as K1's
does: bfloat16 on CUDA the backward kernel (``spade_backward_cuda``: dx
with h = dout and no s0 term, [dgamma | dbeta], per-block sums), then one
cuDNN dgrad and wgrad and the seg MLP's backward; everything else the
autograd of ``spade_reference``, recomputed from the inputs.
``spade_backward_reference`` is the kernel route's closed form.  Both
backward routes run inside the ``utils.spans.BACKWARD_RANGE`` span, as
K1's do.

Layouts are K1's without the style: x (N,H,W,C), seg (N,H,W,S), mean/var
(N,C) float32, weights OIHW.
"""
from __future__ import annotations

import torch

from seg2eye_tpu_torch.ops import spade_style as ss
from seg2eye_tpu_torch.utils.spans import BACKWARD_RANGE, span

EPS = ss.EPS
KERNELS = {torch.bfloat16: "spade_fwd_bf16_sm90",
           torch.float32: "spade_fwd_f32_3xtf32_sm90"}
BACKWARD_KERNELS = {torch.bfloat16: "spade_bwd_bf16_sm90"}


def spade_from_actv(x, actv, mean, var, wg, bg, wb, bb, eps: float = EPS):
    """The plain version of what the kernels compute, from ``actv`` on:
    gamma and beta in x's dtype, the modulation in float32 (at least),
    stored in x's dtype."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    gamma, beta = ss._conv3x3(actv, wg, bg), ss._conv3x3(actv, wb, bb)
    return ss.modulate(x.to(f32), gamma.to(f32), beta.to(f32), mean, var,
                       eps).to(x.dtype)


def spade_reference(x, seg, mean, var, ws, bs, wg, bg, wb, bb,
                    eps: float = EPS):
    """The plain version of one site, seg MLP included."""
    actv = ss.seg_mlp_shared(seg.to(x.dtype), ws, bs)
    return spade_from_actv(x, actv, mean, var, wg, bg, wb, bb, eps)


def spade_cuda(x, actv, mean, var, wcat, bcat, eps: float = EPS):
    """Launch x's dtype's plain-SPADE kernel on one site, with
    ``spade_style_cuda``'s checks; (wcat, bcat) is ``pack_weights``'."""
    out = ss.launch_forward(KERNELS, x, actv, None, mean, var, wcat, bcat,
                            eps)
    spade.launches += 1
    return out


def spade_backward_cuda(x, actv, dout, mean, var, wgam, bcat,
                        eps: float = EPS):
    """Launch x's dtype's plain-SPADE backward kernel on one site: (dx, dgb,
    sums) as ``spade_style.epilogue_backward_reference`` gives them with
    no style."""
    out = ss.launch_backward(BACKWARD_KERNELS, x, actv, dout, None, mean,
                             var, wgam, bcat, eps)
    spade.backward_launches += 1
    return out


def _with_style(inputs, style=None):
    """K1's 11 inputs from the plain op's 10: ``style`` after seg."""
    return (*inputs[:2], style, *inputs[2:])


def _without_style(grads):
    return (*grads[:2], *grads[3:])


def spade_backward_reference(x, seg, mean, var, ws, bs, wg, bg, wb, bb, dout,
                             eps: float = EPS, needs=(True,) * 10):
    """The gradients of (x, seg, mean, var, ws, bs, wg, bg, wb, bb) for
    ``dout``, None where ``needs`` says none, in plain PyTorch: the closed
    form of what the backward kernel and its wrapper compute on the card."""
    inputs = (x, seg, mean, var, ws, bs, wg, bg, wb, bb)
    return _without_style(ss.spade_style_backward_reference(
        *_with_style(inputs), dout, eps=eps,
        needs=_with_style(needs, False)))


SCHEMA = ("(Tensor x, Tensor seg, Tensor mean, Tensor var, Tensor ws, "
          "Tensor bs, Tensor wg, Tensor bg, Tensor wb, Tensor bb, "
          "float eps) -> Tensor")


def _plain(x, seg, mean, var, ws, bs, wg, bg, wb, bb, eps):
    return spade_reference(x, seg, mean, var, ws, bs, wg, bg, wb, bb,
                           eps).contiguous()


# the op: the plain version for CPU tensors, the kernels for CUDA ones
spade_op = torch.library.custom_op(
    "seg2eye::spade", _plain, mutates_args=(), device_types="cpu",
    schema=SCHEMA)


@spade_op.register_kernel("cuda")
def _kernel(x, seg, mean, var, ws, bs, wg, bg, wb, bb, eps):
    actv = ss.seg_mlp_shared(seg.to(x.dtype), ws, bs).contiguous()
    wcat, bcat = ss.packed_weights(wg, bg, wb, bb, x.dtype)
    return spade_cuda(x.contiguous(), actv, mean, var, wcat, bcat, eps)


@spade_op.register_fake
def _fake(x, seg, mean, var, ws, bs, wg, bg, wb, bb, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:-1])
    ctx.eps = inputs[-1]


def _kernel_backward(inputs, needs, dout, eps):
    """The op's backward through the backward kernel (CUDA)."""
    x, seg, mean, var, ws, bs, wg, bg, wb, bb = inputs
    actv = ss.seg_mlp_shared(seg.to(x.dtype), ws, bs).contiguous()
    wgam, bcat, wgb = ss.packed_weights.backward(wg, bg, wb, bb, x.dtype)
    dx, dgb, sums = spade_backward_cuda(x.contiguous(), actv,
                                        dout.contiguous(), mean, var, wgam,
                                        bcat, eps)
    return _without_style(ss.input_grads(
        _with_style(inputs), _with_style(needs, False), actv, wgb, dx, dgb,
        sums, eps))


def _backward(ctx, grad_out):
    """Inside the ``BACKWARD_RANGE`` span: a CUDA tensor of a dtype with a
    backward kernel takes it; everything else the recomputed autograd."""
    inputs, needs = ctx.saved_tensors, ctx.needs_input_grad[:-1]
    with span(BACKWARD_RANGE):
        if grad_out.is_cuda and inputs[0].dtype in BACKWARD_KERNELS:
            grads = _kernel_backward(inputs, needs, grad_out, ctx.eps)
        else:
            grads = ss.recompute_backward(inputs, needs, grad_out, ctx.eps,
                                          reference=spade_reference)
    return (*grads, None)


spade_op.register_autograd(_backward, setup_context=_setup_context)


def spade(x, seg, mean, var, ws, bs, wg, bg, wb, bb,
          eps: float = EPS) -> torch.Tensor:
    """One plain SPADE norm site, through the ``seg2eye::spade`` op: CPU
    tensors take the plain version, CUDA tensors their dtype's kernel
    (every launch counts in ``spade.launches``, every packing of the
    weights in ``spade_style.packed_weights.packings``); any other device
    raises.  The backward recomputes actv and, in bfloat16 on CUDA, runs
    the backward kernel (every launch counts in
    ``spade.backward_launches``)."""
    return spade_op(x, seg, mean, var, ws, bs, wg, bg, wb, bb, eps)


spade.launches = 0
spade.backward_launches = 0
