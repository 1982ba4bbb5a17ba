"""PyTorch port, the scored-inference slice: JAX ``Pix2Pix.inference`` and
the port's on the same batch and weights (B=2, k=2 uint8 style
references), then the scored per-image errors; the CLI, the port's weight
bridge and evaluation loader against the JAX package's; import hygiene.

float32: fakes to atol 1e-4, scored errors to rtol 1e-4.  bfloat16: see
``test_inference_bf16`` for its measured tolerance."""
import ast
import dataclasses
import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.pix2pix import Pix2Pix as JPix2Pix
from seg2eye_tpu.ops import image as jimage
from seg2eye_tpu.ops import metrics as jmetrics
from seg2eye_tpu_torch.eval import tester as port_tester
from seg2eye_tpu_torch.models.pix2pix import Pix2Pix, build_networks
from seg2eye_tpu_torch.ops import spade_style as K
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.utils.weights import from_jax_variables

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SCORE_RTOL = 1e-4
# aspect 0.8 at crop 128: a 5x4 latent, H != W at every level.  At crop 32
# the 0.8 latent rounds to 1x1, so the fake (32x32) is smaller than the
# 40x32 label map, in both packages alike.
GEOMETRIES = {"square": dict(crop_size=32, aspect_ratio=1.0),
              "aspect0.8": dict(crop_size=128, aspect_ratio=0.8),
              "aspect0.8-crop32": dict(crop_size=32, aspect_ratio=0.8)}
CASES = {
    "square-mean-batchstats": ("square", "mean", False),
    "square-max-batchstats": ("square", "max", False),
    "square-mean-runningstats": ("square", "mean", True),
    "aspect0.8-mean-batchstats": ("aspect0.8", "mean", False),
    "aspect0.8-crop32-mean-batchstats": ("aspect0.8-crop32", "mean", False),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_opt(**kw):
    base = dict(ngf=4, crop_size=32, w_dim=8, input_ns=2,
                compute_dtype="float32", isTrain=False)
    return Options(**{**base, **kw}).finalize()


def make_batch(opt, b=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w = opt.image_height, opt.image_width
    return {
        "label": rng.integers(0, opt.label_nc, (b, h, w)).astype(np.int32),
        "style_image": rng.integers(0, 256, (b, opt.input_ns, h, w, 1),
                                    dtype=np.uint8),
        "target_original": rng.integers(0, 256, (b, 640, 400, 1),
                                        dtype=np.uint8),
    }


def with_running_stats(variables, seed=0):
    rng = np.random.default_rng(seed)
    bs = jax.tree_util.tree_map(np.asarray, variables["G"]["batch_stats"])
    for blk in bs.values():
        for norm in blk.values():
            norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(np.float32)
            norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(np.float32)
    return {**variables, "G": {**variables["G"], "batch_stats": bs}}


def port_model(opt, variables, device="cpu"):
    nets = build_networks(opt)
    for name, sd in from_jax_variables(variables).items():
        nets[name].load_state_dict(sd, strict=True)
    return Pix2Pix(opt, nets, device)


def jax_scores(opt, variables, batch):
    """JAX inference, then its to_255resized + mse_for_images."""
    jm = JPix2Pix(opt)

    @jax.jit
    def fn(v, label, style, target):
        fake = jm.inference(v, {"label": label, "style_image": style})
        resized = jimage.to_255resized(fake, w=400, h=640)
        return fake, jmetrics.mse_for_images(resized, target.astype(np.float32))

    fake, errors = fn(variables, batch["label"], batch["style_image"],
                      batch["target_original"])
    return np.asarray(fake), np.asarray(errors)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX-initialised variables per (geometry, dtype), as numpy."""
    cache = {}

    def get(geometry, dtype="float32"):
        if (geometry, dtype) not in cache:
            opt = tiny_opt(compute_dtype=dtype, **GEOMETRIES[geometry])
            v = JPix2Pix(opt).init_variables(jax.random.PRNGKey(0),
                                             with_disc=False)
            cache[geometry, dtype] = with_running_stats(jax.device_get(v))
        return cache[geometry, dtype]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_inference_matches_jax(jax_variables, case):
    geometry, aggr, running = CASES[case]
    opt = tiny_opt(style_aggr_method=aggr, eval_use_running_stats=running,
                   **GEOMETRIES[geometry])
    variables = jax_variables(geometry)
    batch = make_batch(opt)
    want_fake, want_err = jax_scores(opt, variables, batch)

    model = port_model(opt, variables)
    errors, fake = port_tester.Tester(opt).score_batch(model, batch)
    assert fake.shape == want_fake.shape
    sh, sw = model.netG.latent_size
    assert fake.shape == (2, 32 * sh, 32 * sw, 1)
    assert fake.dtype == np.float32
    np.testing.assert_allclose(fake, want_fake, atol=ATOL, rtol=0)
    np.testing.assert_allclose(errors, want_err, rtol=SCORE_RTOL)


# bfloat16: both sides round conv outputs and norm outputs to bf16, but at
# different places (XLA once per fusion, PyTorch once per op) and after
# convolutions that sum in different orders.  Readings at this config, 8
# batches over both geometries, output range 0.05-0.09:
#   port bf16 vs JAX bf16: fakes max 1.3e-3..2.4e-3, scores 3.6e-6..1.0e-5
#   port f32  vs JAX bf16: fakes max 1.4e-3..5.6e-3, scores 3.5e-6..1.6e-5
# So after 20 layers bf16 noise is as large between two bf16 runs as
# between bf16 and f32, and no limit on these distances tells the two
# precisions apart.  What does: the port's generator ends in a bf16 tanh,
# so its bf16 fake holds only bf16 values, and its f32 fake (the control
# below) does not.  (XLA keeps that last tanh in f32, so JAX's bf16 fake is
# off the bf16 grid: one more rounding on the port's side, at most 2^-9 of
# |fake|.)  Block by block, where the noise has not built up, the port's
# bf16 matches JAX's bf16 to one bf16 ulp
# (``test_torch_models.py::test_spade_style_block_bf16``).  The limits on
# the distances keep about 2x and 10x of headroom on the readings above.
BF16_ATOL = 5e-3
BF16_SCORE_RTOL = 1e-4


def bf16_exact(a):
    return np.array_equal(a, torch.tensor(a).bfloat16().float().numpy())


def test_inference_bf16(jax_variables):
    opt = tiny_opt(compute_dtype="bfloat16", **GEOMETRIES["aspect0.8"])
    variables = jax_variables("aspect0.8", "bfloat16")
    batch = make_batch(opt, seed=1)
    want_fake, want_err = jax_scores(opt, variables, batch)
    model = port_model(opt, variables)
    errors, fake = port_tester.Tester(opt).score_batch(model, batch)
    assert np.isfinite(fake).all()
    assert bf16_exact(fake)
    np.testing.assert_allclose(fake, want_fake, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(errors, want_err, rtol=BF16_SCORE_RTOL)
    # control: the same weights and batch in float32 fail the bf16 check
    opt32 = opt.replace(compute_dtype="float32")
    assert not bf16_exact(port_model(opt32, variables).inference(batch).numpy())


def test_latent_style_and_encode_only(jax_variables):
    """``encode_only`` gives the w that ``inference`` uses; passing it back
    as ``latent_style`` reproduces the same fake."""
    opt = tiny_opt(**GEOMETRIES["square"])
    model = port_model(opt, jax_variables("square"))
    batch = make_batch(opt)
    w = model.encode_only(batch)
    assert tuple(w.shape) == (2, opt.w_dim)
    np.testing.assert_array_equal(model.inference(batch, latent_style=w),
                                  model.inference(batch))


@pytest.mark.parametrize("dtype,tf32", [("float32", False),
                                        ("bfloat16", True)])
def test_float32_model_keeps_convolutions_out_of_tf32(jax_variables,
                                                      monkeypatch, dtype,
                                                      tf32):
    """With PyTorch's default flags (cuDNN may use TF32), every convolution
    of a float32 ``inference`` and ``encode_only`` runs with both TF32
    flags off, and the flags are back on after each; a bfloat16 model
    leaves them as they are."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv2d)
    opt = tiny_opt(compute_dtype=dtype, **GEOMETRIES["square"])
    model = port_model(opt, jax_variables("square"))
    batch = make_batch(opt)
    for run in (model.inference, model.encode_only):
        seen.clear()
        run(batch)
        assert seen and set(seen) == {(tf32, tf32)}, run.__name__
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)


def test_cpu_slice_launches_no_kernel(jax_variables, monkeypatch):
    monkeypatch.setattr(K.spade_style, "launches", 0)
    opt = tiny_opt(**GEOMETRIES["square"])
    port_model(opt, jax_variables("square")).inference(make_batch(opt))
    assert K.spade_style.launches == 0


def _run_cli(args):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "seg2eye_tpu_torch.test", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_cli_scores_equal_in_process(jax_variables, tmp_path):
    """``python -m seg2eye_tpu_torch.test --device cpu`` on a synthetic H5
    set with .pth files written from the weight bridge prints the scores
    the in-process Tester computes, and writes the same .npy files."""
    from seg2eye_tpu.data import schema
    from seg2eye_tpu_torch.test import make_dataloader

    data = schema.write_synthetic_h5(str(tmp_path / "data.h5"), h=64, w=40)
    ckpt = tmp_path / "ckpt"
    opt = tiny_opt(dataroot=data, name="exp", checkpoints_dir=str(ckpt),
                   batchSize=2, **GEOMETRIES["square"])
    variables = jax_variables("square")
    os.makedirs(opt.expr_dir)
    for net, sd in from_jax_variables(variables).items():
        torch.save(sd, os.path.join(opt.expr_dir, f"latest_net_{net}.pth"))
    flags = ["--device", "cpu", "--dataroot", data, "--name", "exp",
             "--checkpoints_dir", str(ckpt), "--ngf", "4", "--crop_size", "32",
             "--aspect_ratio", "1.0", "--w_dim", "8", "--input_ns", "2",
             "--batchSize", "2", "--compute_dtype", "float32"]

    out = _run_cli(flags + ["--dataset_key", "validation"])
    printed = float(re.search(r"mse/validation/full/relative, ([0-9.]+)",
                              out).group(1))
    model = port_model(opt, variables)
    vopt = opt.replace(dataset_key="validation", serial_batches=True,
                       no_flip=True)
    tester = port_tester.Tester(opt, "validation",
                                make_dataloader(vopt, "validation"))
    stats = tester.run(model, mode="full")
    assert printed == pytest.approx(
        stats["mse/validation/full/relative"], abs=0.006)

    _run_cli(flags + ["--dataset_key", "test", "--results_dir", "cli/"])
    topt = opt.replace(dataset_key="test", serial_batches=True, no_flip=True,
                       results_dir="inproc/")
    manifest = port_tester.Tester(
        topt, "test", make_dataloader(topt, "test")).run_test(model)
    mine = [ln for ln in open(manifest).read().splitlines() if ln]
    assert mine
    for path in mine:
        cli_path = path.replace(os.sep + "inproc" + os.sep,
                                os.sep + "cli" + os.sep)
        arr = np.load(cli_path)
        assert arr.dtype == np.uint8 and arr.shape == (640, 400)
        np.testing.assert_array_equal(arr, np.load(path))


def test_options_mirror_jax_options():
    """The port's Options has the JAX package's fields, types and defaults."""
    from seg2eye_tpu import options as jopts
    from seg2eye_tpu_torch import options as topts

    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(topts.Options) == fields(jopts.Options)
    opt = topts.Options(crop_size=128, aspect_ratio=0.8).finalize()
    jopt = jopts.Options(crop_size=128, aspect_ratio=0.8).finalize()
    for prop in ("image_height", "image_width", "expr_dir",
                 "per_sample_encode_enabled"):
        assert getattr(opt, prop) == getattr(jopt, prop), prop


@pytest.mark.parametrize("argv,is_train", [
    ([], False),
    (["--ngf", "8", "--no_flip", "--compute_dtype", "float32",
      "--aspect_ratio", "1.0", "--no_device_normalize"], False),
    (["--name", "exp", "--batchSize", "4", "--no_vgg_loss",
      "--style_aggr_method", "max", "--how_many", "3"], True)],
    ids=["test-defaults", "test-flags", "train-flags"])
def test_parse_options_matches_jax(argv, is_train, capsys):
    from seg2eye_tpu import options as jopts
    from seg2eye_tpu_torch import options as topts

    got = topts.parse_options(argv, is_train=is_train, save=False)
    want = jopts.parse_options(argv, is_train=is_train, save=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    printed = capsys.readouterr().out.split("----------------- End")
    assert printed[0] == printed[1].split("\n", 1)[1]


def port_import_run(blocked):
    """Import every module of the port in a fresh interpreter with
    ``blocked`` made unimportable -> (the modules of jax, flax, msgpack,
    optax or the JAX package it imported, the count of the port's
    modules)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {tuple(blocked)!r}:\n"
        "    sys.modules[m] = None\n"
        "import seg2eye_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'seg2eye_tpu', 'msgpack', 'optax')\n"
        f"       and m not in {tuple(blocked)!r}]\n"
        "print(repr(bad))\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bad, count = proc.stdout.strip().split("\n")[-2:]
    return ast.literal_eval(bad), int(count)


def test_port_imports_no_jax():
    """Every module of the port imports with PIL, h5py, cv2 and imageio
    blocked, as on the card's machine, which has none of them, and with
    jax, flax, msgpack and optax importable imports none of them nor
    anything of the JAX package; all 84 of them (the flax msgpack codec,
    the optimizer-state mapping, the host data modules, the style ranking,
    the native batch assembly, the data-parallel ``parallel`` package,
    ``parallel/{mesh,tensor_parallel,spatial}.py`` and
    ``utils/roofline.py`` included)."""
    bad, count = port_import_run(("PIL", "h5py", "cv2", "imageio"))
    assert not bad, bad
    assert count >= 84


def test_port_imports_on_a_machine_without_jax():
    """Every module of the port imports with jax, flax, optax and msgpack
    blocked as well, as on the card's machine, which has none of them."""
    bad, count = port_import_run(("jax", "flax", "optax", "msgpack", "PIL",
                                  "h5py", "cv2", "imageio"))
    assert not bad, bad
    assert count >= 84


def imports_of_jax_package(path):
    """(line, module) of every import of ``seg2eye_tpu`` or a submodule of
    it in the file, at any depth (inside functions too)."""
    tree = ast.parse(open(path).read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "seg2eye_tpu" or n.startswith("seg2eye_tpu.")]
    return found


def test_port_source_never_imports_jax_package(tmp_path):
    """No file of the port, nor chip_smoke.py or the port's card tools, has an
    ``import seg2eye_tpu...`` or ``from seg2eye_tpu... import`` anywhere,
    lazy imports included."""
    files = sorted(glob.glob(os.path.join(REPO, "seg2eye_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tools", "profile_torch_slice.py"),
              os.path.join(REPO, "tools", "profile_torch_train.py"),
              os.path.join(REPO, "tools", "profile_torch_refinenet.py"),
              os.path.join(REPO, "tools", "tf32_flush_study.py"),
              os.path.join(REPO, "tools", "time_torch_slice.py"),
              os.path.join(REPO, "tools", "time_torch_options.py"),
              os.path.join(REPO, "tools", "bench_torch_serving.py"),
              os.path.join(REPO, "tools", "time_torch_convs.py"),
              os.path.join(REPO, "tools", "profile_torch_segtrain.py"),
              os.path.join(REPO, "tools", "convert_checkpoint_torch.py"),
              os.path.join(REPO, "tools", "build_style_ranking_torch.py")]
    assert len(files) >= 20
    bad = {os.path.relpath(f, REPO): imports_of_jax_package(f) for f in files}
    assert not {f: v for f, v in bad.items() if v}
    # the checker itself finds both forms, nested in a function
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import seg2eye_tpu.data as d\n"
                     "    from seg2eye_tpu.utils import torch_export\n"
                     "    import seg2eye_tpu_torch\n")
    assert [m for _, m in imports_of_jax_package(str(probe))] == [
        "seg2eye_tpu.data", "seg2eye_tpu.utils"]


@pytest.mark.parametrize("geometry", ["square", "aspect0.8"])
def test_weight_bridge_matches_torch_export(jax_variables, geometry):
    """The port's own export equals the JAX package's torch_export bit for
    bit: the same keys, dtypes, shapes and bytes."""
    from seg2eye_tpu.utils import torch_export
    from seg2eye_tpu_torch.utils import weights

    variables = jax_variables(geometry)
    for net, export in (("G", "export_generator"), ("E", "export_encoder")):
        want = getattr(torch_export, export)(variables[net])
        got = getattr(weights, export)(variables[net])
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def assert_same_batch(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("method,key", [
    ("random", "validation"), ("first", "validation"), ("random", "test"),
    ("ref_first", "validation"), ("ref_random3", "test")])
def test_eval_loader_matches_jax_loader(tmp_path, method, key):
    """The port's evaluation loader yields the JAX package's batches byte
    for byte (serial batches, no flip, uint8 transport), over two passes,
    and the same single samples and index lists."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.data import openeds as jopeneds
    from seg2eye_tpu.data import schema
    from seg2eye_tpu_torch.data import openeds

    data = schema.write_synthetic_h5(str(tmp_path / "d.h5"), n_ss=3,
                                     n_gen=5, n_seq=2, h=64, w=40)
    ref = schema.write_synthetic_style_ref(str(tmp_path / "r.h5"), data,
                                           use_subsets=True)
    opt = tiny_opt(dataroot=data, style_ref=ref, style_sample_method=method,
                   serial_batches=True, no_flip=True, seed=3,
                   **GEOMETRIES["aspect0.8"])
    want_loader = jloader.DataLoader(
        jopeneds.OpenEDSDataset(opt, dataset_key=key), batch_size=4,
        shuffle=False, drop_last=False, seed=opt.seed, prefetch=0)
    got_loader = openeds.DataLoader(
        openeds.OpenEDSDataset(opt, dataset_key=key), batch_size=4,
        seed=opt.seed)
    assert len(got_loader) == len(want_loader) == 2
    for _ in range(2):
        batches = list(zip(got_loader, want_loader, strict=True))
        for got, want in batches:
            assert_same_batch(got, want)
    assert batches[0][0]["style_image"].shape == (4, 2, 160, 128, 1)
    for idx in (0, 5):
        assert_same_batch(got_loader.get_particular(idx),
                          want_loader.get_particular(idx))
    got_ds, want_ds = got_loader.dataset, want_loader.dataset
    assert got_ds.N == want_ds.N == 6
    assert got_ds.get_validation_indices() == want_ds.get_validation_indices()
    assert (got_ds.get_random_indices(3, np.random.default_rng(1))
            == want_ds.get_random_indices(3, np.random.default_rng(1)))


def test_profile_groups_follow_kernel_symbols():
    """tools/profile_torch_slice.py files each spade_style kernel under its
    own group, before the cuDNN group's "conv" can take it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "profile_torch_slice",
        os.path.join(REPO, "tools", "profile_torch_slice.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    assert prof.group_of(
        "void (anonymous namespace)::spade_style_sm90_kernel<256>("
        "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const*)"
    ).endswith("(bf16)")
    assert prof.group_of(
        "(anonymous namespace)::spade_style_3xtf32_sm90_kernel("
        "CUtensorMap_st, CUtensorMap_st, float const*)").endswith("(f32)")
    assert prof.group_of("sm90_xmma_fprop_implicit_gemm_bf16").startswith(
        "cuDNN")
    assert prof.group_of("void at::native::vectorized_elementwise_kernel"
                         ).startswith("other")
