"""PyTorch port, fused SPADE+Style norm: the plain PyTorch version (what
``spade_style`` runs for CPU tensors) against the JAX reference math and
the Pallas kernel in interpret mode, on tests/test_pallas_spade.py's
inputs and shapes (forward rtol/atol 2e-4, gradients 5e-4).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there, at every site shape of the generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.ops.pallas.spade_style import (fused_spade_style,
                                                spade_style_reference)
from seg2eye_tpu_torch.ops import _build
from seg2eye_tpu_torch.ops import spade_style as K
from test_pallas_spade import make_inputs

FWD_TOL = 2e-4
GRAD_TOL = 5e-4
# args of make_inputs: x seg style mean var ws bs wg bg wb bb
KERNEL_ARGS = (5, 7, 9)          # HWIO conv kernels -> torch OIHW


def to_torch(args):
    out = []
    for i, a in enumerate(args):
        a = np.asarray(a, np.float32)
        if i in KERNEL_ARGS:
            a = np.transpose(a, (3, 2, 0, 1))
        out.append(torch.tensor(a))
    return out


@pytest.mark.parametrize("shape", [dict(), dict(n=1, h=10, w=8, c=16)],
                         ids=["2x16x32x8", "odd_1x10x8x16"])
def test_plain_matches_jax_reference_and_pallas(shape):
    args = make_inputs(**shape)
    ref = np.asarray(spade_style_reference(*args))
    pallas = np.asarray(fused_spade_style(*args, interpret=True))
    got = K.spade_style(*to_torch(args)).numpy()
    for want in (ref, pallas):
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_gradients_match_jax():
    """Gradients through the autograd.Function (remat backward through the
    plain version) against JAX autodiff, in x, style and wg."""
    args = make_inputs(n=1, h=8, w=8, c=8)

    def loss(x, style, wg):
        a = list(args)
        a[0], a[2], a[7] = x, style, wg
        return jnp.sum(spade_style_reference(*a) ** 2)

    gj = jax.grad(loss, argnums=(0, 1, 2))(args[0], args[2], args[7])
    targs = to_torch(args)
    leaves = [targs[i].requires_grad_() for i in (0, 2, 7)]
    (K.spade_style(*targs) ** 2).sum().backward()
    gj_wg = np.transpose(np.asarray(gj[2]), (3, 2, 0, 1))
    for got, want in zip(leaves, (gj[0], gj[1], gj_wg)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_cpu_path_builds_and_launches_nothing(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(K.spade_style, "launches", 0)
    for _ in range(2):
        K.spade_style(*to_torch(make_inputs(n=1, h=4, w=4, c=4)))
    assert K.spade_style.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the launching wrapper takes CUDA tensors only."""
    x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = to_torch(
        make_inputs(n=1, h=4, w=4, c=4))
    actv = K.seg_mlp_shared(seg, ws, bs).contiguous()
    wcat, bcat = K.pack_weights(wg, bg, wb, bb, x.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        K.spade_style_cuda(x, actv, style, mean, var, wcat, bcat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weights_layout(dtype):
    """wcat[dy, dx, k, c] = (wg[c, k, dy, dx], wb[c, k, dy, dx]), in the
    kernel's dtype; bcat[c] = (bg[c], bb[c]) in float32."""
    *_, wg, bg, wb, bb = to_torch(make_inputs(n=1, h=4, w=4, c=8))
    wcat, bcat = K.pack_weights(wg, bg, wb, bb, dtype)
    assert wcat.shape == (3, 3, K.NHIDDEN, 8, 2) and wcat.dtype == dtype
    assert wcat.is_contiguous() and bcat.dtype == torch.float32
    for i, w in enumerate((wg, wb)):
        torch.testing.assert_close(wcat[..., i],
                                   w.permute(2, 3, 1, 0).to(dtype),
                                   rtol=0, atol=0)
    torch.testing.assert_close(bcat, torch.stack([bg, bb], -1), rtol=0, atol=0)


def test_packed_weights_follow_the_weights():
    """The cache packs once per dtype, and anew after an in-place change
    or when a weight is replaced."""
    *_, wg, bg, wb, bb = to_torch(make_inputs(n=1, h=4, w=4, c=8))
    packed = K.PackedWeights()
    first = packed(wg, bg, wb, bb, torch.float32)
    assert packed(wg, bg, wb, bb, torch.float32)[0] is first[0]
    assert packed(wg, bg, wb, bb, torch.bfloat16)[0].dtype == torch.bfloat16
    assert packed(wg, bg, wb, bb, torch.float32)[0] is first[0]
    with torch.no_grad():
        wb.mul_(2.0)
    again = packed(wg, bg, wb, bb, torch.float32)
    assert again[0] is not first[0]
    torch.testing.assert_close(again[0][..., 1], wb.permute(2, 3, 1, 0),
                               rtol=0, atol=0)
    bg = bg + 1.0
    torch.testing.assert_close(packed(wg, bg, wb, bb, torch.float32)[1][:, 0],
                               bg, rtol=0, atol=0)


def test_build_is_keyed_on_sources(tmp_path, monkeypatch):
    """An edited source gets a new build directory; the real sources and
    the Hopper target are what gets built."""
    assert "spade_style.cu" in [p.name for p in _build.sources()]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest()
    assert first == _build._digest()
    src.write_text("// two")
    assert _build._digest() != first

