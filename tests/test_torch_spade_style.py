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


# the op's inputs that take a gradient, by index into the args
GRAD_INPUTS = {"x": 0, "style": 2, "mean": 3, "var": 4, "ws": 5, "bs": 6,
               "wg": 7, "bg": 8, "wb": 9, "bb": 10}
# subsets of needs_input_grad: everything; no seg MLP (no dgrad into actv);
# the seg MLP without the gamma/beta weights (no wgrad); no conv at all
NEEDS = {"all": tuple(GRAD_INPUTS),
         "x_style_wg": ("x", "style", "wg"),
         "seg_mlp": ("ws", "bs"),
         "per_channel": ("mean", "var", "bg", "bb")}
BACKWARD_SHAPES = [(2, 7, 9, 12), (1, 8, 8, 64), (2, 5, 16, 130)]


def _jax_grads(shape):
    """jax.grad of sum(out * dout) of the JAX reference in every input of
    GRAD_INPUTS, weights back in torch's OIHW; and the inputs and dout."""
    n, h, w, c = shape
    args = make_inputs(n=n, h=h, w=w, c=c, seed=1)
    dout = np.random.default_rng(2).standard_normal((n, h, w, c)).astype(
        np.float32)
    idx = tuple(GRAD_INPUTS.values())

    def loss(*leaves):
        a = list(args)
        for i, leaf in zip(idx, leaves):
            a[i] = leaf
        return jnp.sum(spade_style_reference(*a) * dout)

    grads = jax.grad(loss, argnums=tuple(range(len(idx))))(
        *(args[i] for i in idx))
    out = {}
    for (name, i), g in zip(GRAD_INPUTS.items(), grads):
        g = np.asarray(g, np.float32)
        out[name] = np.transpose(g, (3, 2, 0, 1)) if i in KERNEL_ARGS else g
    return args, dout, out


@pytest.mark.parametrize("needs", sorted(NEEDS))
@pytest.mark.parametrize("shape", BACKWARD_SHAPES,
                         ids=["x".join(map(str, s)) for s in BACKWARD_SHAPES])
def test_backward_reference_matches_autograd_and_jax(shape, needs):
    """The plain closed form of the backward kernel and its wrapper,
    ``spade_style_backward_reference``, in float32 against autograd of the
    plain version (float32 round-off: 1e-5 of each gradient's largest
    element) and against jax.grad of the JAX reference (the existing
    gradient tolerance), in each input that takes a gradient, at ragged
    H, W and C, for subsets of needs_input_grad: an input not asked for
    gets None."""
    args, dout, want_jax = _jax_grads(shape)
    targs = to_torch(args)
    wanted = NEEDS[needs]
    flags = tuple(any(GRAD_INPUTS[k] == i for k in wanted) for i in range(11))
    got = K.spade_style_backward_reference(*targs, torch.tensor(dout),
                                           needs=flags)
    leaves = [t.clone().requires_grad_(f) for t, f in zip(targs, flags)]
    out = K.spade_style_reference(*leaves)
    want = torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                               torch.tensor(dout))
    assert [g is not None for g in got] == list(flags)
    for name, g_auto in zip([k for k in GRAD_INPUTS if k in wanted], want):
        g = got[GRAD_INPUTS[name]]
        assert g.shape == targs[GRAD_INPUTS[name]].shape, name
        scale = float(g_auto.abs().max())
        torch.testing.assert_close(g, g_auto, rtol=1e-5, atol=1e-5 * scale,
                                   msg=lambda m: f"{name}: {m}")
        np.testing.assert_allclose(g.numpy(), want_jax[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_builds_and_launches_nothing(monkeypatch, dtype):
    """A CPU tensor's backward builds nothing, counts no backward kernel
    and is the autograd of the plain version, bit for bit, in either
    dtype."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(K.spade_style, "backward_launches", 0)
    args = to_torch(make_inputs(n=1, h=5, w=6, c=12))
    args[0] = args[0].to(dtype)
    graded = (0, 2, 5, 7)
    grads = []
    for fn in (K.spade_style, K.spade_style_reference):
        leaves = [a.clone().requires_grad_(i in graded)
                  for i, a in enumerate(args)]
        out = fn(*leaves)
        dout = torch.ones_like(out)
        out.backward(dout)
        grads.append([leaves[i].grad for i in graded])
    assert K.spade_style.backward_launches == 0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("c", [12, 64, 130])
def test_gamma_layout_rebuilds_the_gamma_conv(c):
    """gamma rebuilt from the backward kernel's layout, as it sums it (per
    tap a shifted (pixels x 128) @ (128 x BN) product per column tile, 64 k
    at a time, in float32), equals the gamma conv with bfloat16-rounded
    weights; the columns past C are zero."""
    rng = np.random.default_rng(3)
    n, h, w = 2, 5, 9
    actv = torch.tensor(np.maximum(rng.standard_normal((n, h, w, 128)), 0),
                        dtype=torch.float32)
    wg = torch.tensor(0.1 * rng.standard_normal((c, 128, 3, 3)),
                      dtype=torch.float32)
    wgam = K.pack_gamma_weights(wg, torch.bfloat16)
    tile = K.gamma_tile(c)
    assert wgam.shape == (9, K.gamma_columns(c), K.NHIDDEN)
    assert wgam.shape[1] % tile == 0 and wgam.shape[1] - c < tile
    assert not wgam[:, c:].any()
    halo = torch.nn.functional.pad(actv, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n, h, w, wgam.shape[1])
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        a = halo[:, dy:dy + h, dx:dx + w, :]
        for k0 in (0, 64):
            for j0 in range(0, wgam.shape[1], tile):
                b = wgam[tap, j0:j0 + tile, k0:k0 + 64].float()
                acc[..., j0:j0 + tile] += a[..., k0:k0 + 64] @ b.T
    want = K._conv3x3(actv, wg.bfloat16().float(), torch.zeros(c))
    torch.testing.assert_close(acc[..., :c], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,tiles", [((10, 8), 1), ((13, 7), 1),
                                      ((20, 16), 3), ((320, 256), 640),
                                      ((5, 16), 1), ((17, 17), 6)])
def test_pixel_tiles(hw, tiles):
    """The kernels' pixel tiles per sample: 128 pixels as 16 x 8 where W <=
    8, else 8 x 16 (the C launcher refuses partial sums of another count)."""
    assert K.pixel_tiles(*hw) == tiles


def _emulated_backward_launch(x, actv, dout, style, mean, var, wgam, bcat,
                              eps=K.EPS):
    """The backward kernel's contract emulated on the CPU from its own
    inputs: gamma from the gamma-only packed layout and bcat's bg column,
    the epilogue in float32, [dgamma | dbeta], and the sums per
    (sample, channel)."""
    n, h, w, c = x.shape
    halo = torch.nn.functional.pad(actv.float(), (0, 0, 1, 1, 1, 1))
    gamma = torch.zeros(n, h, w, c)
    for tap in range(9):
        dy, dx_ = divmod(tap, 3)
        gamma += halo[:, dy:dy + h, dx_:dx_ + w] @ wgam[tap, :c].float().T
    gamma = gamma + bcat[:, 0]
    hh = 0.5 * dout.float()
    xm = x.float() - mean[:, None, None]
    rstd = torch.rsqrt(var[:, None, None] + eps)
    g1 = 1 + gamma
    s0p1 = style[:, None, None, :c] + 1
    dx = (hh * (g1 * rstd + s0p1)).to(x.dtype)
    dgb = torch.cat([hh * xm * rstd, hh], -1).to(x.dtype)
    sums = torch.stack([hh, hh * xm, hh * g1, hh * g1 * xm], 1).sum((2, 3))
    K.spade_style.backward_launches += 1
    return dx, dgb, sums


def test_kernel_route_plumbing(monkeypatch):
    """The bfloat16 CUDA route of the op's backward, with the launch
    replaced by an emulation of the kernel's contract on the CPU: one
    launch, the gamma layout from the forward's cache entry (no packing
    of its own), and the closed form's gradients to bfloat16 rounding."""
    monkeypatch.setattr(K, "spade_style_backward_cuda",
                        _emulated_backward_launch)
    monkeypatch.setattr(K.spade_style, "backward_launches", 0)
    packed = K.PackedWeights()
    monkeypatch.setattr(K, "packed_weights", packed)
    args = to_torch(make_inputs(n=2, h=7, w=9, c=12, seed=4))
    args[0] = args[0].bfloat16()
    wg, bg, wb, bb = args[7:]
    packed(wg, bg, wb, bb, torch.bfloat16)             # the forward's
    dout = torch.tensor(np.random.default_rng(5).standard_normal(
        args[0].shape), dtype=torch.bfloat16)
    needs = tuple(i != 1 for i in range(11))
    got = K._kernel_backward(args, needs, dout, K.EPS)
    assert K.spade_style.backward_launches == 1 and packed.packings == 1
    want = K.spade_style_backward_reference(*args, dout, needs=needs)
    assert got[1] is None and want[1] is None
    for i, (g, w_) in enumerate(zip(got, want)):
        if i == 1:
            continue
        assert g.dtype == w_.dtype and g.shape == w_.shape, i
        torch.testing.assert_close(g.float(), w_.float(), rtol=2e-2,
                                   atol=2e-2 * float(w_.abs().max()),
                                   msg=lambda m: f"input {i}: {m}")


def test_backward_work_counts_the_kernels_traffic():
    """The backward kernel's bound: the gamma product alone, actv, x, dout,
    dx and [dgamma | dbeta] once in the compute dtype, the per-channel
    float32 inputs, the weights and the block sums."""
    n, h, w, c = 16, 320, 256, 64
    flops, nbytes = K.backward_kernel_work((n, h, w, c), torch.bfloat16)
    pixels = n * h * w
    assert flops == 2 * pixels * 9 * 128 * c
    assert nbytes == (pixels * (128 + 5 * c) * 2 + 12 * n * c
                      + 9 * 128 * c * 2 + 4 * c + 4 * n * 640 * 4 * c)
