"""The benchmark's arithmetic: busy time as a union of intervals, the
nearest-rank p95 over every batch, whole-window rates, K1's work, and the
reference's FLOP count against hand formulas."""
import math
from types import SimpleNamespace

import pytest
import torch

from portbench import readers, roofline
from portbench.reference import seg2eye as s2e_ref
from portbench.reference.common import Products, make_state


def _run(**kw):
    base = dict(cell={"sizes": {"batch": 8}, "dtype": "bfloat16"},
                card="NVIDIA H100 80GB HBM3", setup_s=30.0, steps=10,
                seconds=2.0, latencies=[], peak_bytes=2 ** 31, trace=None)
    base.update(kw)
    run = SimpleNamespace(**base)
    run.images = run.steps * run.cell["sizes"]["batch"]
    return run


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),              # overlap counted once
    ([(0, 10), (2, 3), (20, 25)], 15.0),     # nested and disjoint
    ([(20, 25), (0, 10), (10, 12)], 17.0),   # unsorted, touching
])
def test_busy_is_the_union_of_intervals(intervals, want):
    assert roofline.busy_us(intervals) == want


def test_p95_is_the_nearest_rank_over_every_batch():
    lat = [i / 1000 for i in range(1, 201)]          # 1..200 ms, 200 batches
    assert readers.p95_ms(_run(latencies=lat)) == pytest.approx(190.0)
    assert readers.p95_ms(_run(latencies=[0.5])) == pytest.approx(500.0)
    # order does not matter, every batch counts
    assert readers.p95_ms(_run(latencies=lat[::-1])) == pytest.approx(190.0)


def test_rates_are_taken_over_the_whole_window():
    run = _run(steps=75, seconds=20.5)
    assert readers.images_per_s(run) == pytest.approx(75 * 8 / 20.5)


def test_mfu_divides_the_references_flops_by_window_and_peak():
    run = _run(steps=10, seconds=2.0, trace=object())
    run.model_flops = 1e12
    assert readers.mfu(run) == pytest.approx(100 * 1e12 * 10 / 2.0 / 989e12)
    run.cell = {"sizes": {"batch": 8}, "dtype": "float32"}
    assert readers.mfu(run) == pytest.approx(100 * 1e12 * 10 / 2.0 / 495e12)
    assert readers.mfu(_run()) is None                # no traced slice


def test_unknown_card_has_no_peak():
    with pytest.raises(KeyError):
        roofline.peaks("NVIDIA A100-SXM4-40GB", "bfloat16")


def test_k1_work_is_the_seg_mlp_and_gamma_beta_products():
    n, h, w, c, s = 16, 320, 256, 64, 4
    flops, nbytes = roofline.k1_work((n, h, w, c), s, "bfloat16")
    assert flops == 2 * n * h * w * 9 * (s * 128 + 128 * 2 * c)
    pixels = n * h * w
    assert nbytes == (pixels * (2 * c + s) * 2 + 4 * n * 4 * c
                      + 4 * (9 * 128 * (s + 2 * c) + 128 + 2 * c))
    # bf16 at this site is compute-bound on an H100
    t = roofline.bound_s(flops, nbytes, "NVIDIA H100 80GB HBM3", "bfloat16")
    assert t == pytest.approx(flops / 989e12)


def test_conv_backward_counts_groups():
    x = torch.empty(2, 8, 6, 6, device="meta", requires_grad=True)
    w = torch.empty(8, 1, 3, 3, device="meta", requires_grad=True)

    def depthwise():
        torch.nn.functional.conv2d(x, w, padding=1, groups=8).sum().backward()

    fwd = 2 * 2 * 8 * 6 * 6 * 1 * 9
    assert roofline.count_flops(depthwise) == 3 * fwd


def _conv_flops(n, cout, cin, k, h, w):
    return 2 * n * cout * h * w * cin * k * k


def test_generator_flops_against_a_hand_count():
    """The reference G forward at a tiny configuration: every conv at the
    resolution the architecture puts it, by hand (products of matrices and
    convolutions, as ``torch.utils.flop_counter`` counts them)."""
    cfg = dict(ngf=4, ndf=4, crop_size=64, aspect_ratio=1.0, label_nc=4,
               input_nc=1, output_nc=1, input_ns=2, w_dim=8, num_D=2,
               n_layers_D=4, norm_G="spectralspadebatch3x3",
               norm_E="spectralinstance", norm_D="spectralinstance",
               num_upsampling_layers="normal", style_aggr_method="mean",
               gan_mode="hinge", no_ganFeat_loss=False, no_vgg_loss=True)
    sd = {"G": make_state(s2e_ref.generator_specs(cfg), 0, "meta")}
    nets = s2e_ref.Nets(cfg, sd, Products())
    n, s, nf = 2, 4, 4
    seg = torch.empty(n, s, 64, 64, device="meta")
    wv = torch.empty(n, 8, device="meta")
    got = roofline.count_flops(lambda: nets.generate(seg, wv, False))

    want = _conv_flops(n, 16 * nf, s, 3, 2, 2)                      # fc
    res = {"head_0": 2, "G_middle_0": 4, "G_middle_1": 4, "up_0": 8,
           "up_1": 16, "up_2": 32, "up_3": 64}
    for name, (fin, fout) in s2e_ref._block_widths(nf).items():
        r, mid = res[name], min(fin, fout)
        sites = [fin, mid] + ([fin] if fin != fout else [])
        for c in sites:                     # seg MLP, gamma and beta, style FC
            want += (_conv_flops(n, 128, s, 3, r, r)
                     + 2 * _conv_flops(n, c, 128, 3, r, r) + 2 * n * 8 * 2 * c)
        want += _conv_flops(n, mid, fin, 3, r, r) + _conv_flops(n, fout, mid,
                                                                3, r, r)
        if fin != fout:
            want += _conv_flops(n, fout, fin, 1, r, r)
        # the spectral norms' sigma, W v and u . (W v), are matrix-vector
        # products, which the counter leaves out
    want += _conv_flops(n, 1, nf, 3, 64, 64)                        # conv_img
    assert got == want
    assert math.isfinite(got)


def _op(name, device_us, parent=None):
    return SimpleNamespace(name=name, device_time_total=device_us,
                           cpu_parent=parent, thread=1,
                           time_range=SimpleNamespace(start=0, end=1))


def test_readers_of_a_traced_slice():
    from portbench.harness import find_config
    from portbench.reference.seg2eye import site_shapes
    from portbench.trace import BACKWARD_RANGE, K1_OP, Slice, breakdown

    kernels = [("spade_style_sm90_kernel<256>", 0.0, 0.010),
               ("sm90_xmma_fprop_implicit_gemm", 0.010, 0.030),
               ("Memcpy HtoD (Pageable -> Device)", 0.030, 0.031),
               ("vectorized_elementwise_kernel<add>", 0.050, 0.060)]
    sites = site_shapes(find_config("seg2eye-default"), 16)
    outer = [_op(K1_OP, 1000.0) for _ in sites]
    inner = _op(K1_OP, 5.0, parent=outer[0])        # a nested record: skipped
    ops = outer + [inner, _op(BACKWARD_RANGE, 20000.0)]
    sl = Slice(steps=2, wall_s=0.080, kernels=kernels, ops=ops)
    assert sl.busy_s == pytest.approx(0.041)
    assert sl.group_s() == pytest.approx({"k1": 0.010, "conv": 0.020,
                                          "copy": 0.001, "memory_pass": 0.010})
    run = _run(trace=sl, cfg=find_config("seg2eye-default"),
               cell={"sizes": {"batch": 16}, "dtype": "bfloat16"})
    assert readers.idle_share(run) == pytest.approx(100 * (1 - 0.041 / 0.080))
    assert readers.group_ms(run, "conv") == pytest.approx(10.0)
    assert readers.group_ms(run, "optimizer") is None
    assert readers.norm_backward_ms(run) == pytest.approx(10.0)
    card = run.card
    bound = sum(roofline.bound_s(*roofline.k1_work(s, 4, "bfloat16"), card,
                                 "bfloat16") for s in sites)
    assert readers.k1_roofline(run) == pytest.approx(
        100 * bound / (len(sites) * 1000e-6))
    run.trace.ops = outer[:5]                  # not whole forwards
    with pytest.raises(RuntimeError):
        readers.k1_roofline(run)
    gaps = breakdown(sl)
    assert gaps["device_ops"][0] == ["sm90_xmma_fprop_implicit_gemm",
                                     pytest.approx(0.020)]
    assert sum(s for _, s in gaps["idle_gaps"]) == pytest.approx(0.019)
