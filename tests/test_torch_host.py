"""PyTorch port, the host options of the Seg2Eye main path against the JAX
package: the loader's preprocess modes and float transport, the side-by-side
visualisation, the Tester's error-log H5, TensorBoard logging, the
profiler window and the source snapshot of the training loop, and the
train -> test CLI chain with all of them on.  Synthetic OpenEDS H5 files,
the tiny config of ``test_torch_train.py``, CPU."""
import os
import re
import struct
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from seg2eye_tpu_torch.data import openeds
from seg2eye_tpu_torch.eval.tester import Tester
from seg2eye_tpu_torch.options import Options
from seg2eye_tpu_torch.train.loop import train
from seg2eye_tpu_torch.utils import visualizer as vis
from test_torch_train import jax_opt, port_model
from test_torch_train_loop import assert_same_batch

pytestmark = pytest.mark.filterwarnings("ignore:encoder final grid")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ngf=4, ndf=4, crop_size=32, aspect_ratio=1.0, w_dim=8,
            input_ns=2, batchSize=2, compute_dtype="float32", seed=0,
            prefetch=0)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    from seg2eye_tpu.data import schema

    d = tmp_path_factory.mktemp("host")
    return d, schema.write_synthetic_h5(str(d / "data.h5"), h=64, w=40)


# ----------------------------------------------------------------- loader
MODES = [("resize_and_crop", True), ("crop", True), ("scale_width", True),
         ("scale_width_and_crop", True), ("scale_shortside", True),
         ("scale_shortside_and_crop", True), ("none", True),
         ("fixed", False), ("scale_width_and_crop", False)]


@pytest.mark.parametrize("mode,device_normalize", MODES)
def test_preprocess_modes_match_jax_loader(h5, mode, device_normalize):
    """Training batches (shuffle, flips) of every preprocess_mode, and
    float32 transport (--no_device_normalize), byte for byte as the JAX
    DataLoader gives them, over two epochs."""
    from seg2eye_tpu.data import loader as jloader
    from seg2eye_tpu.data import openeds as jopeneds

    _, data = h5
    opt = Options(dataroot=data, preprocess_mode=mode, load_size=48,
                  device_normalize=device_normalize, isTrain=True,
                  **{**TINY, "batchSize": 3, "aspect_ratio": 0.8,
                     "seed": 4}).finalize()
    want_loader = jloader.DataLoader(
        jopeneds.OpenEDSDataset(opt, dataset_key="train"), batch_size=3,
        shuffle=True, drop_last=True, seed=opt.seed, prefetch=0)
    got_loader = openeds.create_dataloader(opt)
    for epoch in (1, 2):
        for loader in (got_loader, want_loader):
            loader.set_epoch(epoch)
        for got, want in zip(got_loader, want_loader, strict=True):
            assert_same_batch(got, want)
            dtype = np.uint8 if device_normalize else np.float32
            assert got["target"].dtype == got["style_image"].dtype == dtype
            assert got["target_original"].dtype == (
                np.uint8 if device_normalize else np.int32)
    if mode in ("crop", "resize_and_crop"):
        assert got["label"].shape[1:] == (32, 32)


# ------------------------------------------------------------ visualiser
def panel_batch(n=2, k=3, h=40, w=32, seed=0):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 4, (n, h, w)).astype(np.uint8)
    label[:, 10:14, 10:14] = 3                       # a pupil to mark
    return {"label": label,
            "style_image": rng.integers(0, 256, (n, k, h, w, 1), np.uint8),
            "target": rng.integers(0, 256, (n, h, w, 1), np.uint8),
            "fake": np.tanh(rng.normal(size=(n, h, w, 1))).astype(np.float32),
            "user": [f"U00{i}" for i in range(n)],
            "filename": [f"{i:013d}" for i in range(n)]}


def test_visualize_sidebyside_matches_jax():
    """The panels (style grid | mask | target | fake | error) with their
    footers, and the pupil marker, equal the JAX package's exactly."""
    from seg2eye_tpu.utils import visualizer as jvis

    batch = panel_batch()
    errors = np.array([0.25, 0.5])
    want = jvis.visualize_sidebyside(batch, error_list=errors)
    got = vis.visualize_sidebyside(batch, error_list=errors)
    assert list(got) == list(want) == ["U000/0000000000000",
                                       "U001/0000000000001"]
    for k in want:
        assert got[k].shape == (1, 380, 1000)
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    img = vis._to_img01(batch["fake"][0])
    marked = vis.annotate_pupil(img, batch["label"][0])
    assert np.array_equal(marked, jvis.annotate_pupil(img, batch["label"][0]))
    assert not np.array_equal(marked, img)


def read_events(log_dir):
    """(scalar tags, image tags) of every event file under ``log_dir``: the
    TFRecord framing (u64 length, u32 crc, payload, u32 crc) read by hand."""
    from tensorboardX.proto import event_pb2

    scalars, images = set(), set()
    for name in os.listdir(log_dir):
        raw = open(os.path.join(log_dir, name), "rb").read()
        pos = 0
        while pos < len(raw):
            (n,) = struct.unpack("<Q", raw[pos:pos + 8])
            event = event_pb2.Event.FromString(raw[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in event.summary.value:
                (images if v.HasField("image") else scalars).add(v.tag)
    return scalars, images


def test_tf_log_writes_scalar_and_image_events(tmp_path):
    """--tf_log: a SummaryWriter under checkpoints/<name>/logs takes the
    scalars and the side-by-side images."""
    opt = Options(checkpoints_dir=str(tmp_path), name="tb", tf_log=True,
                  isTrain=True).finalize()
    v = vis.Visualizer(opt)
    v.plot_current_errors({"GAN": 0.5, "D/real": 1.0}, 3)
    v.display_current_results(vis.visualize_sidebyside(panel_batch()), 1, 3)
    v.close()
    scalars, images = read_events(tmp_path / "tb" / "logs")
    assert scalars == {"GAN", "D/real"}
    assert images == {"U000_0000000000000", "U001_0000000000001"}
    # without --tf_log no writer, and the Tester's visualiser writes nothing
    quiet = vis.Visualizer(opt.replace(tf_log=False, name="quiet"))
    quiet.plot_current_errors({"GAN": 0.5}, 3)
    assert quiet.writer is None
    assert not os.path.exists(tmp_path / "quiet" / "logs")


# --------------------------------------------------------- error-log H5
@pytest.mark.parametrize("mode", ["full", "rand"])
def test_error_log_matches_jax_tester(h5, tmp_path, mode, monkeypatch):
    """write_error_log: the H5 of a 'full' and of a 'rand' run equals the
    JAX Tester's field for field (error, user, filename, the uint8
    visualisation, byte for byte), rows at the running sample count.  The
    JAX Tester scores each batch with the port's model, so that the two
    files differ only by how they are written."""
    import h5py

    from seg2eye_tpu.eval.tester import Tester as JTester

    _, data = h5
    opt = Options(dataroot=data, checkpoints_dir=str(tmp_path), isTrain=True,
                  name="port", **TINY).finalize()
    model = port_model(opt)
    topt = opt.replace(serial_batches=True, no_flip=True, isTrain=False,
                       dataset_key="validation")
    tester = Tester(opt, "validation",
                    openeds.create_dataloader(topt, "validation"))
    jtester = JTester(jax_opt(opt.replace(name="jax")), "validation")
    monkeypatch.setattr(
        jtester, "run_batch", lambda batch, m, v, need_fake=True:
        tester.score_batch(model, batch, need_fake))
    limit = 3 if mode == "rand" else -1
    got = tester.run(model, mode=mode, limit=limit, write_error_log=True)
    want = jtester.run(None, None, mode=mode, limit=limit,
                       write_error_log=True)
    assert got == want
    paths = [os.path.join(str(tmp_path), name, "results", "validation",
                          "error_log_validation.h5")
             for name in ("port", "jax")]
    with h5py.File(paths[0], "r") as a, h5py.File(paths[1], "r") as b:
        assert sorted(a) == sorted(b) == ["error", "filename", "user",
                                          "visualisation"]
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k][()].tobytes() == b[k][()].tobytes(), k
        n = 3 if mode == "rand" else tester.N
        assert np.count_nonzero(a["error"][()]) == n
        assert a["visualisation"][:n].any()


def test_visual_validation_sends_panels(h5, tmp_path):
    """run_partial_modes with visualize_images: the 'rand' statistics to
    the loss log and 4 side-by-side panels to the visualiser."""
    _, data = h5
    opt = Options(dataroot=data, checkpoints_dir=str(tmp_path), isTrain=True,
                  name="visual", **TINY).finalize()
    shown = []

    class Recorder(vis.Visualizer):
        def display_current_results(self, visuals, epoch, step):
            shown.append((sorted(visuals), epoch, step))

    topt = opt.replace(serial_batches=True, no_flip=True, isTrain=False,
                       dataset_key="train")
    tester = Tester(opt, "train", openeds.create_dataloader(topt, "train"),
                    visualizer=Recorder(opt))
    out = tester.run_partial_modes(port_model(opt), epoch=1, n_steps=7,
                                   limit=2, log=True, visualize_images=True)
    assert set(out) == {"rand"}
    assert len(shown) == 1 and len(shown[0][0]) <= 4 and shown[0][1:] == (1, 7)
    log = open(os.path.join(opt.expr_dir, "loss_log.txt")).read()
    assert "mse/train/rand/relative" in log


# ------------------------------------------------------------------ loop
def test_loop_profiles_and_snapshots_source(h5, tmp_path):
    """--profile_steps 1: a chrome trace of iteration 3 in
    expr_dir/profile; src.zip holds every .py file of the port package;
    with --remat, batch sub-norms and per-sample encoding on."""
    _, data = h5
    opt = Options(dataroot=data, checkpoints_dir=str(tmp_path), name="prof",
                  isTrain=True, profile_steps=1, remat=True,
                  norm_E="spectralbatch", norm_D="spectralbatch",
                  print_freq=2, save_latest_freq=10 ** 9,
                  display_freq=10 ** 9, full_val_freq=10 ** 9, niter=2,
                  niter_decay=0, **TINY).finalize()
    result = train(opt, max_steps=4, device="cpu")
    assert result["steps"] == 4
    trace = os.path.join(opt.expr_dir, "profile", "trace.json")
    text = open(trace).read()
    assert '"traceEvents"' in text and "aten::convolution" in text
    with zipfile.ZipFile(os.path.join(opt.expr_dir, "src.zip")) as z:
        names = set(z.namelist())
    package = {os.path.relpath(os.path.join(root, f), REPO)
               for root, _, files in os.walk(
                   os.path.join(REPO, "seg2eye_tpu_torch"))
               for f in files if f.endswith(".py")}
    assert package and package <= names
    assert "chip_smoke.py" in names
    assert not any(n.startswith(("build/", ".git/")) for n in names)


def _run(module, args):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_cli_chain_with_host_options(h5):
    """The tiny CLI chain with batch sub-norms, remat, the error log,
    TensorBoard and the profiler on: training writes the trace, the
    events, src.zip and, at its full validation, both error logs; then
    the test CLI scores the latest checkpoint."""
    d, data = h5
    flags = ["--device", "cpu", "--dataroot", data, "--name", "chain",
             "--checkpoints_dir", str(d / "ckpt"), "--ngf", "4", "--ndf", "4",
             "--crop_size", "32", "--aspect_ratio", "1.0", "--w_dim", "8",
             "--input_ns", "2", "--batchSize", "2", "--compute_dtype",
             "float32", "--norm_E", "spectralbatch", "--norm_D",
             "spectralbatch"]
    out = _run("seg2eye_tpu_torch.train",
               flags + ["--niter", "1", "--niter_decay", "0", "--max_steps",
                        "3", "--print_freq", "2", "--display_freq", "4",
                        "--full_val_freq", "6", "--remat",
                        "--write_error_log", "--tf_log", "--profile_steps",
                        "1"])
    assert "Training was successfully finished." in out
    expr = d / "ckpt" / "chain"
    assert (expr / "profile" / "trace.json").exists()
    assert (expr / "src.zip").exists()
    for key in ("train", "validation"):
        assert (expr / "results" / key / f"error_log_{key}.h5").exists()
    scalars, images = read_events(expr / "logs")
    assert "GAN" in scalars and "mse/validation/full/relative" in scalars
    assert images                      # the partial validation's panels
    log = expr / "results" / "validation" / "error_log_validation.h5"
    log.unlink()
    out = _run("seg2eye_tpu_torch.test", flags + ["--dataset_key",
                                                  "validation",
                                                  "--write_error_log"])
    score = float(re.search(r"mse/validation/full/relative, ([0-9.]+)",
                            out).group(1))
    assert np.isfinite(score) and score > 0
    assert log.exists()


def test_port_imports_without_host_packages():
    """Every module of the port imports with h5py, cv2, PIL and
    tensorboardX blocked, as on the card's machine; the modules of this
    slice among them."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'cv2', 'PIL', 'tensorboardX'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil\n"
        "import seg2eye_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "new = {'models.vgg', 'data.transforms', 'utils.files',\n"
        "       'utils.visualizer', 'eval.tester'}\n"
        "assert {p.__name__ + '.' + n for n in new} <= set(names)\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
