"""PyTorch port, the eval BN, residual add and ReLU in one pass
(``ops.bn_act``, ``models.layers.bn_relu``).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` phase 15
holds it against the float64 closed form and the plain version at
RefineNet serving's site shapes and in NCHW planes.  Here: the
``seg2eye::bn_act`` op's CPU registration against the three ops bit for
bit, its fake registration and ``opcheck``; ``takes_kernel``'s rule and
the layouts ``planes`` takes or refuses; the bottleneck and DeepLab eval
forwards against the composition, bit for bit, with every site through the
op and without it; no training forward entering it; the kernels' profiler
names in the benchmark's ``memory_pass`` group; and the exported refiner
program holding the op and giving the eager forward's output.
"""
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from portbench import trace as bench_trace
from seg2eye_tpu_torch.models import layers
from seg2eye_tpu_torch.models.deeplab import DeepLab
from seg2eye_tpu_torch.models.layers import Bottleneck, apply_conv
from seg2eye_tpu_torch.ops import bn_act as B

CL = torch.channels_last
RESIDUALS = ("none", "plain", "bn")
# bn_relu sites of a ResNet-14 DeepLab: stem 1, 6 bottlenecks (1, 1, 1 and
# layer4's multi-grid 3) x 3, ASPP 6, decoder 3 (ResNet-101: 1 + 33 x 3 +
# 6 + 3 = 109)
RESNET14_SITES = 1 + 6 * 3 + 6 + 3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bn_vectors(c, gen):
    """(weight, bias, running_mean, running_var) away from (1, 0, 0, 1)."""
    return (torch.rand(c, generator=gen) + 0.5,
            torch.randn(c, generator=gen) * 0.1,
            torch.randn(c, generator=gen) * 0.2,
            torch.rand(c, generator=gen) + 0.5)


def op_args(dtype, residual="bn", shape=(2, 16, 5, 3), seed=0):
    """The op's arguments: x and r (N, C, H, W) channels_last in ``dtype``,
    the BN vectors float32."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=CL)
    r = torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=CL)
    c = shape[1]
    rbn = bn_vectors(c, gen) if residual == "bn" else (None,) * 4
    return (x, *bn_vectors(c, gen), 1e-5,
            None if residual == "none" else r, *rbn, 2e-5)


def composition(x, w, b, mean, var, eps, r, rw, rb, rmean, rvar, reps):
    """The chain as the sites computed it before the op: BN in eval, the
    residual (through its own BN) added, ReLU."""
    y = F.batch_norm(x, mean, var, w, b, False, 0.1, eps)
    if r is not None:
        if rw is not None:
            r = F.batch_norm(r, rmean, rvar, rw, rb, False, 0.1, reps)
        y = y + r
    return torch.relu(y)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("residual", RESIDUALS)
def test_cpu_registration_is_the_composition(dtype, residual):
    """The op's CPU registration, called as the op and through ``bn_act``,
    equals the composition bit for bit."""
    args = op_args(getattr(torch, dtype), residual)
    want = composition(*args)
    for got in (B.bn_act_op(*args), B.bn_act(*args)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("residual", RESIDUALS)
def test_fake_registration(residual):
    """Under a fake mode the op gives x's shape, dtype and strides."""
    args = op_args(torch.bfloat16, residual)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        out = B.bn_act_op(*fake)
    assert out.shape == args[0].shape and out.dtype == torch.bfloat16
    assert out.stride() == args[0].stride()


@pytest.mark.parametrize("residual", RESIDUALS)
def test_op_passes_opcheck(residual):
    torch.library.opcheck(B.bn_act_op, op_args(torch.bfloat16, residual))


def rule_case(case):
    """(x, train, r, params) of one ``takes_kernel`` or ``planes`` case:
    bfloat16, channels_last, C 16, eval, nothing recording gradients,
    unless the case changes it."""
    odd = case.startswith("odd_channels")
    shape = (2, 12, 5, 3) if odd else (2, 16, 5, 3)
    x, w, b, mean, var, _, r, *rest = op_args(torch.bfloat16, "plain",
                                              shape=shape)
    params = (w, b, mean, var)
    train = case == "train"
    if case == "float32":
        x, r = x.float(), r.float()
    elif case in ("nchw", "odd_channels_nchw"):
        x = x.contiguous()
        r = r.contiguous()
    elif case == "x_nchw":
        x = x.contiguous()
    elif case == "neither":
        x = x.contiguous().transpose(2, 3)
        r = None
    elif case == "grad":
        params = (w.requires_grad_(), b, mean, var)
    elif case == "misaligned":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype)
        x = flat[1:].view(2, 5, 3, 16).permute(0, 3, 1, 2)
    elif case == "residual_nchw":
        r = r.contiguous()
    elif case == "float64_params":
        params = (w.double(), b, mean, var)
    elif case == "residual_bn_float64":
        rw, rb, rmean, rvar = bn_vectors(x.shape[1],
                                         torch.Generator().manual_seed(3))
        params = (w, b, mean, var, rw.double(), rb, rmean, rvar)
    elif case == "residual_bn_grad":
        rw, rb, rmean, rvar = bn_vectors(x.shape[1],
                                         torch.Generator().manual_seed(3))
        params = (w, b, mean, var, rw, rb.requires_grad_(), rmean, rvar)
    elif case == "wrong_size":
        params = (w[:8], b, mean, var)
    return x, train, r, params


# the rule looks at the dtype, the device, ``train`` and autograd; the
# layout is the kernel's to take or refuse (LAYOUT)
RULE = {"takes": True, "train": False, "float32": False, "nchw": True,
        "grad": False, "odd_channels": True, "misaligned": True,
        "residual_nchw": True, "float64_params": True,
        "residual_bn_float64": True, "residual_bn_grad": False,
        "wrong_size": True}


@pytest.mark.parametrize("case", sorted(RULE))
def test_takes_kernel_rule(case, monkeypatch):
    """The sites' rule, with the tensors flagged as CUDA ones (no card
    here): a bfloat16 eval forward that records no gradient takes the
    kernel, whatever its layout.  On the CPU nothing does."""
    x, train, r, params = rule_case(case)
    assert not B.takes_kernel(x, train, r, params)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert B.takes_kernel(x, train, r, params) is RULE[case]


# what ``planes`` gives: 0 for channels_last rows, H W for NCHW planes,
# None for a ValueError
LAYOUT = {"takes": 0, "nchw": 15, "odd_channels_nchw": 15, "x_nchw": None,
          "residual_nchw": None, "odd_channels": None, "neither": None,
          "misaligned": None, "float32": None, "float64_params": None,
          "residual_bn_float64": None, "wrong_size": None}


@pytest.mark.parametrize("case", sorted(LAYOUT))
def test_kernel_layout(case, monkeypatch):
    """The layouts the kernel reads (the BN vectors flagged as on the
    card): channels_last rows with C a multiple of 8, or contiguous NCHW
    planes, r in x's.  Anything else raises, in ``planes`` and at the
    launch before anything is launched: no site falls back unseen."""
    x, _, r, params = rule_case(case)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    weights = params[::4]
    if LAYOUT[case] is not None:
        assert B.planes(x, r, weights) == LAYOUT[case]
        return
    with pytest.raises(ValueError, match="bn_act"):
        B.planes(x, r, weights)
    rbn = params[4:] if len(params) > 4 else (None,) * 4
    with pytest.raises(ValueError, match="bn_act"):
        B.bn_act_cuda(x, *params[:4], 1e-5, r, *rbn, 1e-5)


def old_bottleneck_forward(block, x, train):
    """``Bottleneck.forward`` as it was before ``bn_relu``."""
    out = torch.relu(block.bn1(apply_conv(x, block.conv1), train))
    out = torch.relu(block.bn2(apply_conv(out, block.conv2), train))
    out = block.bn3(apply_conv(out, block.conv3), train)
    residual = x
    if block.downsample is not None:
        residual = block.downsample[1](
            apply_conv(x, block.downsample[0]), train)
    return torch.relu(out + residual)


def perturbed(net, seed=0):
    """Every BN of ``net`` given vectors away from (1, 0, 0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, layers.BatchNorm):
                for t, v in zip((m.weight, m.bias, m.running_mean,
                                 m.running_var),
                                bn_vectors(m.num_features, gen)):
                    t.copy_(v)
    return net


def every_site_on_the_op(monkeypatch):
    """Route every eval site through the op (its CPU registration here);
    -> the list its calls are counted in."""
    calls = []
    op = B.bn_act

    def counted(*args):
        calls.append(args[0].shape)
        return op(*args)

    monkeypatch.setattr(B, "takes_kernel",
                        lambda x, train, r=None, params=(): not train)
    monkeypatch.setattr(B, "bn_act", counted)
    return calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("downsample", [False, True])
def test_bottleneck_eval_is_the_composition(dtype, downsample, monkeypatch):
    """A bottleneck's eval forward, by its own route and with its three
    sites on the op, equals the old forward bit for bit."""
    torch.manual_seed(0)
    cin = 16 if downsample else 32
    block = perturbed(Bottleneck(cin, 8, 2 if downsample else 1, 1,
                                 downsample))
    x = torch.randn(2, cin, 9, 6).to(getattr(torch, dtype)).contiguous(
        memory_format=CL)
    with torch.no_grad():
        want = old_bottleneck_forward(block, x, False)
        plain = block(x, False)
        calls = every_site_on_the_op(monkeypatch)
        fused = block(x, False)
    assert len(calls) == 3
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    torch.testing.assert_close(fused, want, rtol=0, atol=0)


def tiny_deeplab(seed=0):
    torch.manual_seed(seed)
    return perturbed(DeepLab("resnet", 16, 4, (1, 1, 1, 1)), seed)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_deeplab_eval_sites_on_the_op(dtype, monkeypatch):
    """A DeepLab eval forward with every BN-ReLU site on the op equals its
    own route bit for bit, one op call per site."""
    net = tiny_deeplab()
    x = torch.randn(2, 3, 64, 40).to(getattr(torch, dtype))
    with torch.no_grad():
        want = net(x, False)
        calls = every_site_on_the_op(monkeypatch)
        got = net(x, False)
    assert len(calls) == RESNET14_SITES
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_training_forward_never_enters_the_op(monkeypatch):
    """A ``train=True`` forward keeps the composition at every site, even
    with a rule that would take everything, and updates the running
    statistics as before."""
    net = tiny_deeplab()
    x = torch.randn(2, 3, 64, 40)
    calls = []
    monkeypatch.setattr(B, "takes_kernel", lambda *a, **k: True)
    monkeypatch.setattr(B, "bn_act", lambda *a: calls.append(a))
    before = net.backbone.bn1.num_batches_tracked.item()
    net(x, True).sum().backward()
    assert calls == []
    assert net.backbone.bn1.num_batches_tracked.item() == before + 1


@pytest.mark.parametrize("name", B.KERNEL_NAMES)
def test_kernel_name_is_a_memory_pass(name):
    """The kernel's profiler names count where the BN, add and ReLU passes
    they replace counted: the benchmark's ``memory_pass`` group."""
    assert B.KERNEL in name
    assert bench_trace.group_of(name) == "memory_pass"


def test_exported_refiner_holds_the_op(tmp_path, monkeypatch):
    """A bfloat16 RefineNet exported with the sites' rule taking CPU
    tensors: its program calls ``seg2eye::bn_act`` once per site, and the
    loaded artifact gives the eager forward's prediction bit for bit."""
    from seg2eye_tpu_torch.refinenet import config, model
    from seg2eye_tpu_torch.serving import export_refiner, load_serving

    cfg = config.RefineNetConfig(compute_dtype="bfloat16", resnet_depth=14,
                                 input_height=64, input_width=40)
    m = model.RefineNetModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    perturbed(m.net)
    x = torch.randint(0, 256, (2, 64, 40, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = m.forward({"input": x})["prediction"]
    monkeypatch.setattr(B, "takes_kernel",
                        lambda x, train, r=None, params=(): not train)
    program = export_refiner(m, str(tmp_path / "art"))
    monkeypatch.undo()
    ops = [n for n in program.graph.nodes
           if n.target is torch.ops.seg2eye.bn_act.default]
    assert len(ops) == RESNET14_SITES
    pred, _ = load_serving(str(tmp_path / "art"))(x)
    torch.testing.assert_close(pred, want, rtol=0, atol=0)
