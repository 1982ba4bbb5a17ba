"""PyTorch port, ``utils/roofline.py`` against the JAX package's
``seg2eye_tpu/utils/roofline.py``, on the CPU.

FLOPs: the port counts with ``torch.utils.flop_counter`` (its convolution
backward with the groups), JAX with XLA's cost analysis of the compiled
program; both count a matmul and an unpadded conv alike.  The peaks: 0.0
on the CPU and for an unknown card, the H100's published dense rates for
its name.  ``report`` prints the JAX module's line, 'n/a' at peak 0;
``timeit`` times a CPU function on the host's clock.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seg2eye_tpu.utils import roofline as jroofline
from seg2eye_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def conv_nhwc(padding):
    """A 3x3 conv of an NHWC 2x16x16x8 input to 32 channels: the JAX
    function (NHWC, HWIO) and the port's (NCHW, OIHW) on the same
    arrays."""
    x, w = arrays((2, 16, 16, 8), (3, 3, 8, 32))

    def jfn(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), padding, dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC"))

    def tfn(x, w):
        return F.conv2d(x, w, padding=1 if padding == "SAME" else 0)

    return (jfn, (jnp.asarray(x), jnp.asarray(w)),
            tfn, (torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w).permute(3, 2, 0, 1)))


def matmul():
    a, b = arrays((64, 128), (128, 256))
    return (jnp.matmul, (jnp.asarray(a), jnp.asarray(b)),
            torch.matmul, (torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("case, want", [("matmul", 4_194_304),
                                        ("valid conv", 1_806_336)])
def test_flops_of_matches_jax(case, want):
    """(64,128) @ (128,256) and a VALID 3x3 conv (NHWC 2x16x16x8 -> 32):
    the port's count equals XLA's cost analysis of the same function,
    2 M N K and 2 N H_out W_out C_out C_in 9."""
    jfn, jargs, tfn, targs = (matmul() if case == "matmul"
                              else conv_nhwc("VALID"))
    got = roofline.flops_of(tfn, *targs)
    assert got == jroofline.flops_of(jax.jit(jfn), *jargs) == want


def test_flops_of_same_conv_counts_the_dense_product():
    """With SAME padding XLA leaves out the taps that fall on the padding
    (per axis 15 + 16 + 15 of 3 x 16 output positions read the image):
    2 N C_out C_in 46^2 = 2,166,784.  torch's counter counts the dense
    product, 2 N H W C_out C_in 9 = 2,359,296, which the port keeps: the
    padded taps are multiplied on the card too."""
    jfn, jargs, tfn, targs = conv_nhwc("SAME")
    assert roofline.flops_of(tfn, *targs) == 2 * 2 * 16 * 16 * 32 * 8 * 9 \
        == 2_359_296
    assert jroofline.flops_of(jax.jit(jfn), *jargs) \
        == 2 * 2 * 32 * 8 * 46 ** 2 == 2_166_784


def test_depthwise_backward_counts_its_groups():
    """A depthwise conv's forward + backward (input and weight gradients)
    counts 3 times its forward under the group-aware formula; torch's
    stock formula, without the groups, counts far more."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(2, 64, 16, 16, requires_grad=True)
    w = torch.randn(64, 1, 3, 3, requires_grad=True)

    def fwd():
        return F.conv2d(x, w, padding=1, groups=64)

    def step():
        fwd().sum().backward()

    forward = roofline.flops_of(fwd)
    assert forward == 2 * 2 * 64 * 16 * 16 * 9
    assert roofline.flops_of(step) == 3 * forward
    with FlopCounterMode(display=False) as stock:
        step()
    assert stock.get_total_flops() > 10 * forward


def test_peaks_by_card_name():
    """0.0 on the CPU and for an unknown card, so that callers print
    'n/a'; the H100's published dense rates for its name, as
    ``nvidia-smi`` prints it."""
    for device in (None, "cpu", torch.device("cpu"),
                   "NVIDIA A100-SXM4-80GB"):
        assert roofline.peak_flops(device) == 0.0
        assert roofline.peak_bytes(device) == 0.0
        assert roofline.bound_ms(1e12, 1e9, torch.bfloat16,
                                 device=device) == 0.0
    assert roofline.peak_flops(H100) == 989e12
    assert roofline.peak_flops(H100, torch.bfloat16) == 989e12
    assert roofline.peak_flops(H100, "tf32") == 495e12
    assert roofline.peak_flops(H100, torch.float32) == 67e12
    assert roofline.peak_flops(H100, torch.float64) == 0.0
    assert roofline.peak_bytes(H100) == 3.35e12


def test_bound_ms_is_the_larger_of_compute_and_memory():
    """989 GFLOP of bfloat16 products take at least 1 ms on the H100,
    three TF32 passes of 165 GFLOP 1 ms, and 3.35 GB 1 ms; the bound is
    the larger of the two times."""
    assert roofline.bound_ms(989e9, 0, torch.bfloat16, device=H100) \
        == pytest.approx(1.0)
    assert roofline.bound_ms(165e9, 0, "tf32", passes=3, device=H100) \
        == pytest.approx(1.0)
    assert roofline.bound_ms(0, 3.35e9, torch.bfloat16, device=H100) \
        == pytest.approx(1.0)
    assert roofline.bound_ms(989e9, 6.7e9, torch.bfloat16, device=H100) \
        == pytest.approx(2.0)
    assert roofline.bound_ms(67e9, 3.35e9, torch.float32, device=H100) \
        == pytest.approx(1.0)


def test_report_prints_the_jax_line(capsys):
    """The JAX module's line, the MFU 'n/a' at peak 0."""
    for peak in (0.0, 989e12):
        roofline.report("step", 0.004, 2e12, peak)
        jroofline.report("step", 0.004, 2e12, peak)
        got, want = capsys.readouterr().out.splitlines()
        assert got == want
    roofline.report("step", 0.004, 2e12, 0.0)
    assert capsys.readouterr().out.rstrip().endswith("MFU   n/a")


def test_timeit_times_a_cpu_function():
    """On CPU tensors: one warm-up call and ``iters`` timed ones, on the
    host's clock."""
    calls = []
    x = torch.randn(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    t = roofline.timeit(fn, (x,), iters=5)
    assert len(calls) == 6 and 0.0 < t < 10.0
