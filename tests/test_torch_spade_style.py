"""PyTorch port, fused SPADE+Style norm: the plain PyTorch version (what
``spade_style`` runs for CPU tensors) against the JAX reference math and
the Pallas kernel in interpret mode, on tests/test_pallas_spade.py's
inputs and shapes (forward rtol/atol 2e-4, gradients 5e-4).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain version there, at every site shape of the generator.
Here the weight layouts they read are checked by rebuilding gamma|beta from
them tap by tap, in the kernels' tap and k order: the bfloat16 layout, and
the float32 one with the 3xTF32 kernel's arithmetic emulated in numpy
(TF32 hi and lo of both operands, hi*hi + hi*lo + lo*hi)."""
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


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    """wcat[.., 3 dy + dx, j, k] is wg[c, k, dy, dx] at j = 2c and
    wb[c, k, dy, dx] at j = 2c + 1, K-major, the columns padded with zeros
    to the N tile (128 wide here).  bfloat16: (9, 128, 128), the weights
    rounded to bfloat16.  float32: (2, 9, 128, 128), hi then lo: each has
    its low 13 mantissa bits zero (a TF32 value), and hi + lo rebuilds the
    weights to 2^-21 relative.  bcat[c] = (bg[c], bb[c]) in float32."""
    *_, wg, bg, wb, bb = to_torch(make_inputs(n=1, h=4, w=4, c=8))
    wcat, bcat = K.pack_weights(wg, bg, wb, bb, dtype)
    assert wcat.dtype == dtype and wcat.is_contiguous()
    assert bcat.dtype == torch.float32
    torch.testing.assert_close(bcat, torch.stack([bg, bb], -1), rtol=0, atol=0)
    assert wcat.shape == K.packed_shape(8, dtype)
    if dtype == torch.float32:
        assert wcat.shape == (2, 9, 128, K.NHIDDEN)
        hi, lo = wcat
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert not (lo.view(torch.int32) & 0x1FFF).any()
        w = hi.double() + lo.double()
    else:
        assert wcat.shape == (9, 128, K.NHIDDEN)
        w = wcat
    for dy in range(3):
        for dx in range(3):
            for i, wt in enumerate((wg, wb)):
                want, got = wt[:, :, dy, dx], w[3 * dy + dx, i:16:2]
                if dtype == torch.float32:
                    assert ((got - want.double()).abs()
                            <= 2.0 ** -21 * want.double().abs()).all()
                else:
                    torch.testing.assert_close(got, want.to(dtype),
                                               rtol=0, atol=0)
    assert not w[:, 16:].any()


@pytest.mark.parametrize("c,tile,cols", [
    (16, 128, 128), (64, 128, 128), (72, 256, 256), (128, 256, 256),
    (129, 256, 512), (1024, 256, 2048)])
def test_packed_columns(c, tile, cols):
    assert K.n_tile(c) == tile and K.packed_columns(c) == cols


def gamma_beta_from_packed(actv, wcat, bcat, c):
    """gamma|beta as the tensor-core kernel sums them: per tap, a shifted
    (pixels x 128) @ (128 x N tile) product per column tile over a
    zero-padded halo, 64 k at a time, then the bias; read from the bfloat16
    layout with plain indexing, summed in float32."""
    n, h, w, _ = actv.shape
    halo = torch.nn.functional.pad(actv.float(), (0, 0, 1, 1, 1, 1))
    cols, tile = wcat.shape[1], K.n_tile(c)
    acc = torch.zeros(n, h, w, cols)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        a = halo[:, dy:dy + h, dx:dx + w, :]
        for k0 in (0, 64):
            for j0 in range(0, cols, tile):
                b = wcat[tap, j0:j0 + tile, k0:k0 + 64].float()
                acc[..., j0:j0 + tile] += a[..., k0:k0 + 64] @ b.T
    assert not acc[..., 2 * c:].any()      # the zero-padded columns
    acc = acc[..., :2 * c].reshape(n, h, w, c, 2) + bcat
    return acc[..., 0], acc[..., 1]


@pytest.mark.parametrize("shape", [(1, 10, 8, 16), (2, 13, 7, 72),
                                   (1, 3, 5, 129)],
                         ids=["odd_1x10x8x16", "2x13x7x72", "1x3x5x129"])
def test_bf16_layout_rebuilds_the_convs(shape):
    """gamma|beta rebuilt from the bfloat16 layout equal the two 3x3 convs
    (with bfloat16-rounded weights, in float32) at ragged shapes."""
    n, h, w, c = shape
    rng = np.random.default_rng(0)
    actv = torch.tensor(np.maximum(rng.standard_normal((n, h, w, 128)), 0),
                        dtype=torch.float32)
    wg, wb = (torch.tensor(0.1 * rng.standard_normal((c, 128, 3, 3)),
                           dtype=torch.float32) for _ in range(2))
    bg, bb = (torch.tensor(0.1 * rng.standard_normal(c), dtype=torch.float32)
              for _ in range(2))
    wcat, bcat = K.pack_weights(wg, bg, wb, bb, torch.bfloat16)
    gamma, beta = gamma_beta_from_packed(actv, wcat, bcat, c)
    for got, wt, bias in ((gamma, wg, bg), (beta, wb, bb)):
        want = K._conv3x3(actv, wt.bfloat16().float(), bias)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def tf32_rna(a):
    """float32 -> TF32 as cvt.rna.tf32.f32 rounds (nearest, ties away from
    zero): add half the weight of the 13 dropped bits, then drop them."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def gamma_beta_tf32(actv, wcat, bcat, c, passes):
    """gamma|beta as the float32 kernel sums them, read from the packed
    (2, 9, cols, 128) layout: per tap, the shifted zero-padded actv split
    into TF32 hi and lo, and the products hi*hi, hi*lo, lo*hi (the first
    ``passes`` of them; 1 is single-pass TF32), exact in float64, summed."""
    n, h, w, _ = actv.shape
    halo = np.pad(actv, ((0, 0), (1, 1), (1, 1), (0, 0)))
    a_hi = tf32_rna(halo)
    a_lo = tf32_rna(halo - a_hi)
    w_hi, w_lo = np.asarray(wcat, np.float64)
    terms = [(a_hi, w_hi), (a_hi, w_lo), (a_lo, w_hi)][:passes]
    acc = np.zeros((n, h, w, wcat.shape[2]))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for a, wt in terms:
            acc += a[:, dy:dy + h, dx:dx + w].astype(np.float64) @ wt[tap].T
    acc = acc[..., :2 * c].reshape(n, h, w, c, 2) + bcat
    return acc[..., 0].astype(np.float32), acc[..., 1].astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 10, 8, 16), (2, 13, 7, 72)],
                         ids=["odd_1x10x8x16", "2x13x7x72"])
def test_3xtf32_arithmetic_matches_jax_float32(shape):
    """The float32 kernel's arithmetic (3xTF32 from the packed layout, then
    the epilogue in float32) equals the JAX float32 reference to 1e-5; a
    single TF32 pass does not, so the check tells the two apart."""
    args = make_inputs(*shape)
    want = np.asarray(spade_style_reference(*args))
    x, seg, style, mean, var, ws, bs, wg, bg, wb, bb = to_torch(args)
    actv = K.seg_mlp_shared(seg, ws, bs).numpy()
    wcat, bcat = K.pack_weights(wg, bg, wb, bb, torch.float32)
    x, style, mean, var = (t.numpy() for t in (x, style, mean, var))
    c = x.shape[-1]
    s0, s1 = style[:, None, None, :c], style[:, None, None, c:]
    rstd = 1 / np.sqrt(var[:, None, None] + np.float32(K.EPS))
    tol = 1e-5 + 1e-5 * np.abs(want)
    worst = []
    for passes in (3, 1):
        gamma, beta = gamma_beta_tf32(actv, wcat.numpy(), bcat.numpy(), c,
                                      passes)
        spade = (x - mean[:, None, None]) * rstd * (1 + gamma) + beta
        out = (spade + x * (s0 + 1) + s1) * np.float32(0.5)
        assert out.dtype == np.float32
        worst.append(float((np.abs(out - want) / tol).max()))
    assert worst[0] <= 1.0 < worst[1], worst


def test_full_float32_sets_and_restores_the_tf32_flags(monkeypatch):
    """Inside full_float32 both TF32 flags are off; on exit, after an
    exception too, each is back as it was; disabled, it changes nothing."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    with K.full_float32():
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
    assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    with pytest.raises(RuntimeError), K.full_float32():
        raise RuntimeError("inside")
    assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    with K.full_float32(enabled=False):
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)


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
    assert not torch.equal(again[0], first[0])
    torch.testing.assert_close(
        again[0], K.pack_weights(wg, bg, wb, bb, torch.float32)[0],
        rtol=0, atol=0)
    bg = bg + 1.0
    torch.testing.assert_close(packed(wg, bg, wb, bb, torch.float32)[1][:, 0],
                               bg, rtol=0, atol=0)


def test_packed_weights_drop_freed_weights():
    """An entry of the shared cache goes with its weights: once one of them
    is freed, nothing of it is kept (the packing included)."""
    import gc
    import weakref

    *_, wg, bg, wb, bb = to_torch(make_inputs(n=1, h=4, w=4, c=8))
    packed = K.PackedWeights()
    wcat = weakref.ref(packed(wg, bg, wb, bb, torch.float32)[0])
    packed(wg, bg, wb, bb, torch.bfloat16)
    assert len(packed._cache) == 2 and packed.packings == 2
    del wb
    gc.collect()
    assert not packed._cache and wcat() is None


def test_build_is_keyed_on_sources(tmp_path, monkeypatch):
    """An edited source gets a new build directory; the real sources and
    the Hopper target are what gets built."""
    assert [p.name for p in _build.sources()] == ["spade_style_sm90.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest()
    assert first == _build._digest()
    src.write_text("// two")
    assert _build._digest() != first



def test_sass_counts_per_kernel():
    """The build's SASS census: HGMMA and FFMA counted per kernel symbol,
    predicated instructions included, other opcodes ignored."""
    sass = """
\tcode for sm_90a
\t\tFunction : _Z23spade_style_sm90_kernel
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24 ;  /* 0x0 */
        /*0020*/              @!P0 HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ;  /* 0x0 */
        /*0030*/                   FFMA R5, R2, R3, R5 ;         /* 0x0 */
\t\tFunction : _Z30spade_style_3xtf32_sm90_kernel
        /*0000*/                   FFMA.FTZ R5, R2, R3, R5 ;     /* 0x0 */
        /*0010*/                   FMUL R5, R2, R3 ;             /* 0x0 */
        /*0020*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24 ;  /* 0x0 */
"""
    assert _build.sass_counts(sass) == {
        "_Z23spade_style_sm90_kernel": {"HGMMA": 2, "FFMA": 1},
        "_Z30spade_style_3xtf32_sm90_kernel": {"HGMMA": 1, "FFMA": 1}}
