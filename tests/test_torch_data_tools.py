"""PyTorch port, the host modules against the JAX package's on the CPU:
gaze math and the gaze losses (float32, within 1e-6), the colormaps,
pre/post-processing and augmentation (byte for byte, the augmenter from
the same seed), the OpenEDS schema, its synthetic writers and the
raw-tree -> H5 preparator (dataset by dataset: bytes, dtypes, shapes)."""
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.data import augment as jaugment
from seg2eye_tpu.data import prepare_openeds as jprepare
from seg2eye_tpu.data import preprocessor as jpre
from seg2eye_tpu.data import schema as jschema
from seg2eye_tpu.refinenet import losses as jlosses
from seg2eye_tpu.utils import colormap as jcolormap
from seg2eye_tpu.utils import gaze as jgaze
from seg2eye_tpu_torch.data import augment, openeds, prepare_openeds
from seg2eye_tpu_torch.data import preprocessor as pre
from seg2eye_tpu_torch.data import schema
from seg2eye_tpu_torch.refinenet import losses
from seg2eye_tpu_torch.utils import colormap, gaze

# float32; angular errors, which the functions give in degrees, are held to
# it in radians (measured: 2e-7 rad, 1.1e-5 degrees, three float32 ulps
# at 30 degrees)
GAZE_ATOL = 1e-6
RAD = np.pi / 180


def assert_bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------------- gaze
def pitchyaws(n=64, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, (n, 2)).astype(dtype)


@pytest.mark.parametrize("fn", ["pitchyaw_to_vector", "vector_to_pitchyaw",
                                "angular_error"])
def test_gaze_numpy_matches_jax(fn):
    a, b = pitchyaws(seed=1), pitchyaws(seed=2)
    if fn == "pitchyaw_to_vector":
        args = (a,)
    elif fn == "vector_to_pitchyaw":
        args = (jgaze.pitchyaw_to_vector(a) * 3.0,)
    else:
        args = (a, b)
    assert_bytes_equal(getattr(gaze, fn)(*args), getattr(jgaze, fn)(*args))


def test_angular_error_torch_matches_jax():
    a, b = pitchyaws(seed=3), pitchyaws(seed=4)
    got = gaze.angular_error_torch(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jgaze.angular_error_jax(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy() * RAD, want * RAD, atol=GAZE_ATOL,
                               rtol=0)


def loss_inputs(fn, seed):
    rng = np.random.default_rng(seed)
    if fn.startswith("experts"):
        return (rng.uniform(-0.8, 0.8, (5, 3, 2)).astype(np.float32),
                rng.uniform(-0.8, 0.8, (5, 2)).astype(np.float32))
    return (rng.uniform(-0.8, 0.8, (7, 2)).astype(np.float32),
            rng.normal(size=(7, 3)).astype(np.float32))


@pytest.mark.parametrize("fn", ["angular_error", "gaze_mse_error",
                                "experts_angular_error",
                                "experts_gaze_mse_error"])
def test_gaze_losses_match_jax(fn):
    """Each loss against the JAX package's (the angular errors in
    radians), pitchyaw against vectors and experts."""
    a, b = loss_inputs(fn, 5)
    got = getattr(losses, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    scale = RAD if "angular" in fn else 1.0
    np.testing.assert_allclose(got.numpy() * scale, want * scale,
                               atol=GAZE_ATOL, rtol=0)


@pytest.mark.parametrize("width", [2, 3])
def test_to_vector_matches_jax(width):
    x = np.random.default_rng(6).normal(size=(4, 6, width)).astype(
        np.float32)
    np.testing.assert_allclose(
        losses.to_vector(torch.from_numpy(x)).numpy(),
        np.asarray(jlosses.to_vector(jnp.asarray(x))), atol=GAZE_ATOL,
        rtol=0)


def test_to_vector_refuses_other_widths():
    with pytest.raises(ValueError, match="convert"):
        losses.to_vector(torch.zeros(3, 4))


# --------------------------------------------------------------- colormap
@pytest.mark.parametrize("n", [4, 20, 35, 256])
def test_colormaps_match_jax(n):
    assert_bytes_equal(colormap.label_colormap(n), jcolormap.label_colormap(n))
    labels = np.random.default_rng(n).integers(-2, n + 3, (3, 9, 7))
    assert_bytes_equal(colormap.colorize_labels(labels, n),
                       jcolormap.colorize_labels(labels, n))
    assert colormap.uint82bin(n) == jcolormap.uint82bin(n)


# ---------------------------------------------------------- preprocessor
def images(seed=0):
    rng = np.random.default_rng(seed)
    return {"gray": rng.integers(0, 256, (36, 60), dtype=np.uint8),
            "gray1": rng.integers(0, 256, (30, 50, 1), dtype=np.uint8),
            "rgb": rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)}


@pytest.mark.parametrize("kind", ["gray", "gray1", "rgb"])
def test_preprocessor_matches_jax(kind):
    """Every function of the module, on a uint8 image, its [-1, 1] and
    [0, 1] floats and a label map."""
    img = images()[kind]
    f = img.astype(np.float32) / 127.5 - 1.0
    for fn, args in (("as_batch", (img,)), ("unnormalize", (f,)),
                     ("unnormalize", (img.astype(np.float64),)),
                     ("unnormalize", (img % 4,)), ("normalize", (img,)),
                     ("normalize", (f,)), ("equalize", (img,)),
                     ("to_range01", (f,)), ("preprocess_eye", (img,)),
                     ("get_error_map", (f, f[::-1].copy()))):
        assert_bytes_equal(getattr(pre, fn)(*args), getattr(jpre, fn)(*args))
    if kind == "rgb":
        unit = img.astype(np.float32) / 255.0
        assert_bytes_equal(pre.vgg_normalize(unit), jpre.vgg_normalize(unit))
        assert_bytes_equal(pre.rgb2gray(img), jpre.rgb2gray(img))
    if kind == "gray":
        assert_bytes_equal(pre.gray2rgb(img), jpre.gray2rgb(img))
    with pytest.raises(ValueError):
        pre.unnormalize(np.asarray([-5.0, 300.0]))


# --------------------------------------------------------------- augment
@pytest.mark.parametrize("difficulty", [0.0, 0.5, 1.0])
def test_augmenter_matches_jax_from_the_same_seed(difficulty):
    """Five augmentations of each image from one seeded generator on each
    side: every output byte for byte."""
    shape = (72, 120)
    rng = np.random.default_rng(7)
    eyes = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(5)]
    ours = augment.Augmenter(True, shape, difficulty,
                             rng=np.random.default_rng(11))
    theirs = jaugment.Augmenter(True, shape, difficulty,
                                rng=np.random.default_rng(11))
    for eye in eyes:
        assert_bytes_equal(ours(eye), theirs(eye))
    for kind in augment.AUGMENTATION_RANGES:
        assert ours.value_from_type(kind) == theirs.value_from_type(kind)
    assert_bytes_equal(augment.Augmenter.headpose_to_radians((350, 170, 0)),
                       jaugment.Augmenter.headpose_to_radians((350, 170, 0)))
    off = augment.Augmenter(False, shape)
    assert off(eyes[0]) is eyes[0]


# ---------------------------------------------------------------- schema
def assert_same_h5(got_path, want_path):
    """Every group and dataset of two H5 files, dataset by dataset: the
    same names, dtypes, shapes and bytes."""
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        names = []
        want.visit(names.append)
        seen = []
        got.visit(seen.append)
        assert sorted(seen) == sorted(names)
        for name in names:
            if isinstance(want[name], h5py.Dataset):
                assert_bytes_equal(got[name][()], want[name][()])
        assert len(names) > 10


@pytest.mark.parametrize("key", ["train", "validation", "test"])
def test_split_keys_match_jax(key):
    assert schema.split_keys(key) == jschema.split_keys(key)
    assert openeds.split_keys is schema.split_keys
    assert (schema.TRAIN_KEYS, schema.TEST_KEYS, schema.NATIVE_H,
            schema.NATIVE_W) == (jschema.TRAIN_KEYS, jschema.TEST_KEYS,
                                 jschema.NATIVE_H, jschema.NATIVE_W)


@pytest.mark.parametrize("learnable", [False, True])
def test_synthetic_h5_and_style_ref_match_jax(learnable, tmp_path):
    kw = dict(h=24, w=16, seed=3, learnable=learnable)
    got = schema.write_synthetic_h5(str(tmp_path / "p.h5"), **kw)
    want = jschema.write_synthetic_h5(str(tmp_path / "j.h5"), **kw)
    assert_same_h5(got, want)
    for subsets in (False, True):
        assert_same_h5(
            schema.write_synthetic_style_ref(str(tmp_path / "pr.h5"), got,
                                             use_subsets=subsets, seed=4),
            jschema.write_synthetic_style_ref(str(tmp_path / "jr.h5"), want,
                                              use_subsets=subsets, seed=4))


def tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("learnable", [False, True])
def test_raw_tree_and_prepare_openeds_match_jax(learnable, tmp_path):
    """The port's raw-tree writer writes the JAX package's files byte for
    byte; the port's preparator (through its ``python -m`` entry point's
    ``main``) packs it into the H5 the JAX preparator packs, with
    ``--limit``'s off-by-one."""
    kw = dict(users=("U001", "U002", "U003"), n_ss=2, n_gen=3, n_seq=2,
              h=20, w=12, seed=5, learnable=learnable)
    ours = schema.write_synthetic_raw_tree(str(tmp_path / "p"), **kw)
    theirs = jschema.write_synthetic_raw_tree(str(tmp_path / "j"), **kw)
    a, b = tree_files(ours), tree_files(theirs)
    assert sorted(a) == sorted(b) and a == b
    for limit in (-1, 1):
        name = f"out{limit}.h5"
        prepare_openeds.main(["--base_path", ours, "--limit", str(limit),
                              "--n_jobs", "2", "--out_filename", name])
        jprepare.OpenEDSPreparator(theirs, limit, n_jobs=2,
                                   out_filename=name).run()
        assert_same_h5(os.path.join(ours, name), os.path.join(theirs, name))
