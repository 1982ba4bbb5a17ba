"""PyTorch port, image ops and metric: the same numpy inputs through
seg2eye_tpu.ops and seg2eye_tpu_torch.ops (CPU, float32, atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.ops import image as jimage
from seg2eye_tpu.ops import metrics as jmetrics
from seg2eye_tpu_torch.ops import image as timage
from seg2eye_tpu_torch.ops import metrics as tmetrics

ATOL = 1e-5


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def assert_truncated_equal(got, ref, floats, tol=1e-4):
    """Truncated ints agree, except by at most 1 where the float before
    truncation lies within ``tol`` of an integer (the two frameworks may
    round such a value to either side of it)."""
    got, ref, floats = _np(got), _np(ref), _np(floats)
    diff = np.abs(got - ref)
    near_int = np.abs(floats - np.round(floats)) < tol
    assert diff.max() <= 1
    assert np.all(near_int[diff > 0]), "off-by-one away from an integer"


@pytest.mark.parametrize("shape", [(2, 5, 7), (2, 5, 7, 1)])
def test_one_hot_label(shape):
    label = np.random.default_rng(0).integers(0, 4, shape)
    ref = jimage.one_hot_label(jnp.asarray(label), 4)
    got = timage.one_hot_label(torch.from_numpy(label), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("out_hw", [(20, 16), (5, 4), (7, 9), (10, 8)])
def test_resize_nearest(out_hw):
    x = np.random.default_rng(1).normal(size=(2, 10, 8, 3)).astype(np.float32)
    ref = jimage.resize_nearest(jnp.asarray(x), *out_hw)
    got = timage.resize_nearest(torch.from_numpy(x), *out_hw)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("out_hw", [(256, 256), (640, 400)],
                         ids=["down_320x256_to_256", "up_320x256_to_640x400"])
def test_resize_bilinear(out_hw):
    x = np.random.default_rng(2).uniform(
        -1, 1, size=(2, 320, 256, 1)).astype(np.float32)
    ref = jimage.resize_bilinear(jnp.asarray(x), *out_hw)
    got = timage.resize_bilinear(torch.from_numpy(x), *out_hw)
    assert tuple(got.shape) == (2, *out_hw, 1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("in_hw", [(32, 32), (40, 32)])
def test_to_255resized(in_hw):
    x = np.random.default_rng(3).uniform(
        -1, 1, size=(2, *in_hw, 1)).astype(np.float32)
    ref = jimage.to_255resized(jnp.asarray(x))
    got = timage.to_255resized(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 640, 400, 1)
    floats = (timage.resize_bilinear(torch.from_numpy(x), 640, 400)
              + 1.0) * 255.0 / 2.0
    assert_truncated_equal(got, ref, floats)


def test_to_255_truncates_toward_zero():
    x = np.array([-1.0, -0.99999, 0.0, 0.5, 0.99999, 1.0], np.float32)
    ref = jimage.to_255(jnp.asarray(x))
    got = timage.to_255(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_mse_for_images():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (3, 640, 400, 1)).astype(np.float32)
    b = rng.integers(0, 256, (3, 640, 400, 1)).astype(np.float32)
    ref = jmetrics.mse_for_images(jnp.asarray(a), jnp.asarray(b))
    got = tmetrics.mse_for_images(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=ATOL)
    with pytest.raises(ValueError):
        tmetrics.mse_for_images(torch.from_numpy(a), torch.from_numpy(b[:2]))


def test_error_statistics():
    errors = np.random.default_rng(5).uniform(0, 1, 7)
    for mode, key in (("full", "validation"), ("rand", "train")):
        assert (tmetrics.error_statistics(errors, mode, key)
                == jmetrics.error_statistics(errors, mode, key))
