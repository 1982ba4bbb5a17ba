"""PyTorch port, the norm sites' batch statistics (``ops.batch_stats``).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain version at the generator's 18 site shapes.  Here: the
``seg2eye::batch_stats`` op's CPU route against ``torch.var_mean`` bit for
bit, values and x's gradient; the backward kernel's closed form
(``batch_stats_backward_reference``) against ``var_mean``'s autograd; the
op under ``opcheck`` and ``torch.export``; and which norm sites route to it.
"""
import pytest
import torch

from seg2eye_tpu_torch.models import normalization
from seg2eye_tpu_torch.models.normalization import SpadeStyleBlock
from seg2eye_tpu_torch.ops import batch_stats as B
from seg2eye_tpu_torch.parallel import data_parallel as dp


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nhwc(dtype, shape=(2, 5, 7, 12), seed=0, offset=3.0):
    """x (N,H,W,C) with a mean far from 0 against its spread, where a
    one-pass sum of squares would cancel."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen, dtype=torch.float64)
            + offset).to(dtype)


def grads_of_stats(c, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=gen), torch.randn(c, generator=gen))


def autograd_of_var_mean(x, gvar, gmean):
    """x's gradient through the plain version's autograd, x widened to
    float32 at least as the norm sites widen it."""
    x = x.detach().requires_grad_()
    var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype,
                                                        torch.float32)),
                               dim=(0, 1, 2), correction=0)
    return torch.autograd.grad((var, mean), x, (gvar.to(var.dtype),
                                                gmean.to(mean.dtype)))[0]


def cpu_route_is_var_mean(dtype):
    """The op's CPU route: var_mean's values and x's gradient, bit for bit."""
    x = nhwc(dtype)
    gvar, gmean = grads_of_stats(x.shape[-1])
    leaf = x.clone().requires_grad_()
    var, mean = B.batch_stats(leaf)
    want_var, want_mean = torch.var_mean(x.float(), dim=(0, 1, 2),
                                         correction=0)
    assert var.dtype == mean.dtype == torch.float32
    torch.testing.assert_close(var, want_var, rtol=0, atol=0)
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=0)
    torch.autograd.backward((var, mean), (gvar, gmean))
    torch.testing.assert_close(leaf.grad, autograd_of_var_mean(x, gvar, gmean),
                               rtol=0, atol=0)


def closed_form_float64():
    """The backward's closed form is var_mean's gradient: float64 to 1e-12."""
    x = nhwc(torch.float64)
    gvar, gmean = (g.double() for g in grads_of_stats(x.shape[-1]))
    _, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
    got = B.batch_stats_backward_reference(x, mean, gvar, gmean)
    want = autograd_of_var_mean(x, gvar, gmean)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def closed_form_bfloat16():
    """bfloat16 x: the closed form, rounded once to bfloat16, lies within
    one bfloat16 ulp of var_mean's float32 gradient (before its cast), and
    nearly every element is equal to the parent route's bfloat16 gradient."""
    x = nhwc(torch.bfloat16, shape=(4, 9, 8, 24))
    gvar, gmean = grads_of_stats(x.shape[-1])
    var, mean = torch.var_mean(x.float(), dim=(0, 1, 2), correction=0)
    got = B.batch_stats_backward_reference(x, mean, gvar, gmean)
    assert got.dtype == torch.bfloat16
    want = autograd_of_var_mean(x.float(), gvar, gmean)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs())) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())
    parent = autograd_of_var_mean(x, gvar, gmean)
    assert float((got == parent).float().mean()) >= 0.95


def opcheck_holds(dtype):
    x = nhwc(dtype).requires_grad_()
    result = torch.library.opcheck(B.batch_stats_op, (x,))
    assert set(result.values()) == {"SUCCESS"}, result
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has("seg2eye::batch_stats", "CPU")
    assert has("seg2eye::batch_stats", "CUDA")
    assert not has("seg2eye::batch_stats", "CompositeImplicitAutograd")


def kernel_plumbing():
    """The CUDA registration and the kernel route of the backward, with the
    launches replaced by their plain versions: each launches once, and the
    backward gives the closed form."""
    launched = []

    def forward(x):
        launched.append("forward")
        return B.batch_stats_reference(x)

    def backward(x, mean, gvar, gmean):
        launched.append("backward")
        return B.batch_stats_backward_reference(x, mean, gvar, gmean)

    x = nhwc(torch.bfloat16)
    gvar, gmean = grads_of_stats(x.shape[-1])
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(B, "batch_stats_cuda", forward)
        m.setattr(B, "batch_stats_backward_cuda", backward)
        m.setattr(B, "takes_kernel", lambda t: t.dtype in B.KERNELS)
        var, mean = B._kernel(x)
        leaf = x.clone().requires_grad_()
        torch.autograd.backward(B.batch_stats(leaf), (gvar, gmean))
    assert launched == ["forward", "backward"]
    torch.testing.assert_close(leaf.grad, B.batch_stats_backward_reference(
        x, mean, gvar, gmean), rtol=0, atol=0)


def exported_block():
    """A bfloat16 SpadeStyleBlock on batch statistics, routed to the op,
    exports under torch.export (the fake gives the outputs' shapes): the
    program holds one ``seg2eye::batch_stats`` and matches the live block."""
    block, x, seg, w = tiny_block("batch", torch.bfloat16)
    mp = pytest.MonkeyPatch()
    with mp.context() as m, torch.no_grad():
        m.setattr(normalization, "takes_kernel",
                  lambda t: t.dtype in B.KERNELS)
        program = torch.export.export(block, (x, seg, w))
        want = block(x, seg, w)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.seg2eye.batch_stats.default) == 1
    with torch.no_grad():
        got = program.module()(x, seg, w)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def chunking_covers_every_row():
    """The kernels' grids: chunks cover the M rows once, the last one not
    empty; a large site takes the blocks asked for, a small one chunks of
    MIN_CHUNK_ROWS."""
    for m, c in [(1_310_720, 64), (327_680, 256), (1280, 1024), (105, 12),
                 (7, 72), (5120, 1030)]:
        for blocks in (264, 1056):
            rows, chunks = B.chunking(m, c, blocks)
            assert 1 <= chunks <= 65535 and (chunks - 1) * rows < m <= \
                chunks * rows, (m, c, blocks)
    assert B.chunking(1_310_720, 64, 264)[1] == 264
    assert B.chunking(5120, 1030, 264)[1] == 264 // 9
    assert B.chunking(1280, 1024, 264) == (B.MIN_CHUNK_ROWS,
                                           1280 // B.MIN_CHUNK_ROWS)


OP_CASES = {"cpu_route_float32": lambda: cpu_route_is_var_mean(torch.float32),
            "cpu_route_bfloat16":
                lambda: cpu_route_is_var_mean(torch.bfloat16),
            "closed_form_float64": closed_form_float64,
            "closed_form_bfloat16": closed_form_bfloat16,
            "opcheck_float32": lambda: opcheck_holds(torch.float32),
            "opcheck_bfloat16": lambda: opcheck_holds(torch.bfloat16),
            "kernel_plumbing": kernel_plumbing,
            "chunking": chunking_covers_every_row,
            "export": exported_block}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_batch_stats_op(case):
    OP_CASES[case]()


def tiny_block(param_free, dtype, c=12):
    torch.manual_seed(0)
    block = SpadeStyleBlock(param_free, c, 4, 8)
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(2, c, 6, 5, generator=gen) + 1.0).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    seg = torch.nn.functional.one_hot(
        torch.randint(0, 4, (2, 6, 5), generator=gen), 4).permute(0, 3, 1, 2)
    seg = seg.float().contiguous(memory_format=torch.channels_last)
    return block, x, seg, torch.randn(2, 8, generator=gen)


class OneBand:
    """A parallel.spatial.Band stand-in: the whole map as one band."""

    def var_mean(self, x, dims):
        return torch.var_mean(x, dims, correction=0)

    def extend(self, x, k):
        return x, 0

    def take(self, x, halo=0):
        return x


# (dtype, param_free, on the card, forward keywords, data parallel)
ROUTES = {"bfloat16_cuda": (torch.bfloat16, "batch", True, {}, False),
          "float32_cuda": (torch.float32, "batch", True, {}, False),
          "bfloat16_cpu": (torch.bfloat16, "batch", False, {}, False),
          "running": (torch.bfloat16, "batch", True,
                      {"use_running_average": True}, False),
          "instance": (torch.bfloat16, "instance", True, {}, False),
          "data_parallel": (torch.bfloat16, "batch", True, {}, True),
          "band": (torch.bfloat16, "batch", True, {"band": OneBand()}, False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_norm_site_routing(route, monkeypatch):
    """Only the single-process batch branch of a bfloat16 CUDA tensor takes
    the op (CUDA flagged by patching ``takes_kernel``'s device test): one
    forward, one backward through the kernel route (its launch replaced by
    the closed form), the statistics and x's gradient those of the plain
    version.  float32, CPU, running statistics, the instance branch, the
    data-parallel and the band forms stay on ``torch.var_mean``."""
    dtype, param_free, on_card, kw, data_parallel = ROUTES[route]
    calls = []

    def flagged(t):
        return t.dtype in B.KERNELS and (on_card or t.is_cuda)

    def counted(x):
        calls.append("forward")
        return B.batch_stats(x)

    def backward(x, mean, gvar, gmean):
        calls.append("backward")
        return B.batch_stats_backward_reference(x, mean, gvar, gmean)

    monkeypatch.setattr(normalization, "takes_kernel", flagged)
    monkeypatch.setattr(B, "takes_kernel", flagged)
    monkeypatch.setattr(normalization, "batch_stats", counted)
    monkeypatch.setattr(B, "batch_stats_backward_cuda", backward)
    if data_parallel:
        monkeypatch.setattr(dp, "active", lambda: True)
        monkeypatch.setattr(dp, "synced_var_mean", lambda x, dims: (
            *torch.var_mean(x, dims, correction=0), x.numel() // x.shape[1]))
    block, x, seg, w = tiny_block(param_free, dtype)
    leaf = x.clone().requires_grad_()
    (block(leaf, seg, w, **kw).float() ** 2).sum().backward()
    taken = route == "bfloat16_cuda"
    assert calls == (["forward", "backward"] if taken else [])
    if taken:
        # the plain route, for the same x: the norm site as the parent ran it
        monkeypatch.setattr(normalization, "takes_kernel", lambda t: False)
        plain = x.clone().requires_grad_()
        (block(plain, seg, w).float() ** 2).sum().backward()
        torch.testing.assert_close(leaf.grad.float(), plain.grad.float(),
                                   rtol=2.0 ** -7, atol=1e-3)
