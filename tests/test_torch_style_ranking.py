"""PyTorch port, the style-ranking builder against the JAX tool
(``tools/build_style_ranking.py``, loaded by path) on the CPU: the mask
distances bit for bit wherever JAX's float32 sum is exact (below 2**24),
the orders with their ties, the H5 that ``main`` writes (index, subset and
distance datasets, generative and sequence candidates, three splits,
``--top_k``, short file names), and the style references that the port's
loader picks from a port-built ranking."""
import importlib.util
import os

import h5py
import numpy as np
import pytest
import torch

from seg2eye_tpu_torch.data import style_ranking as sr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# above 2**24 JAX's float32 sum rounds as it goes: n * 2**-24 bounds the
# relative error of a float32 sum of n = 4096 non-negative terms
ABOVE_2_24_RTOL = 4096 * 2.0 ** -24


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "build_style_ranking",
        os.path.join(REPO, "tools", "build_style_ranking.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eye_masks(rng, n, h, w):
    """Nested jittered ellipses (sclera, iris, pupil) on background."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        cy, cx = h * rng.uniform(0.35, 0.65), w * rng.uniform(0.35, 0.65)
        r = min(h, w) * rng.uniform(0.25, 0.45)
        d = np.hypot((yy - cy) / rng.uniform(1.0, 1.6), xx - cx)
        for cls, frac in ((1, 1.0), (2, 0.55), (3, 0.25)):
            out[i][d < r * frac] = cls
    return out


def jax_distances(jax_tool, targets, candidates):
    return np.stack([np.asarray(jax_tool._mask_distances(t, candidates))
                     for t in targets])


@pytest.mark.parametrize("hw", [(640, 400), (96, 60), (64, 64), (40, 24)])
def test_mask_distances_match_jax_bit_for_bit(jax_tool, hw):
    """Distances (every sum below 2**24) the same bits as JAX's, and stable
    orders the same, ties included (candidates repeated on purpose)."""
    rng = np.random.default_rng(sum(hw))
    targets = eye_masks(rng, 3, *hw)
    cands = eye_masks(rng, 9, *hw)
    cands = np.concatenate([cands, cands[[4, 1]], targets[:1]])
    want = jax_distances(jax_tool, targets, cands)
    got = sr.mask_distances(torch.from_numpy(targets),
                            torch.from_numpy(cands)).numpy()
    assert (want * 4096).max() < 2 ** 24
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    orders = sr.rank(torch.from_numpy(got)).numpy()
    assert np.array_equal(orders, np.argsort(want, axis=1, kind="stable"))
    assert (want == 0).any()                    # the target among them
    assert len(np.unique(want[0])) < want.shape[1]   # and ties


def test_mask_distances_above_2_24(jax_tool):
    """A sum above 2**24: the port's distance is the exact integer sum
    rounded once to float32, over 4096; JAX's within ABOVE_2_24_RTOL."""
    rng = np.random.default_rng(7)
    target = np.zeros((1, 64, 64), np.uint8)                  # 125 each
    cands = np.where(rng.random((3, 64, 64)) < 0.8, 3, 2).astype(np.uint8)
    exact = ((np.asarray(sr.CLASS_MEANS)[cands].astype(np.int64) - 125) ** 2
             ).reshape(3, -1).sum(1)
    assert (exact > 2 ** 24).all()
    got = sr.mask_distances(torch.from_numpy(target),
                            torch.from_numpy(cands)).numpy()[0]
    assert np.array_equal(got, exact.astype(np.float32) / np.float32(4096))
    want = jax_distances(jax_tool, target, cands)[0]
    np.testing.assert_allclose(got, want, rtol=ABOVE_2_24_RTOL, atol=0)


def write_inputs(tmp_path, rng, h=48, w=30):
    """A data H5 with three splits (short labels_*_filenames that differ
    from images_ss_filenames), and generative and sequence segmentation
    H5s; U002 has no sequence masks, U003 no masks at all."""
    data, gen, seq = (str(tmp_path / f) for f in ("d.h5", "g.h5", "s.h5"))
    with h5py.File(data, "w") as fd, h5py.File(gen, "w") as fg, \
            h5py.File(seq, "w") as fs:
        for split in ("train", "validation", "test"):
            lab = "labels_gen" if split == "test" else "labels_ss"
            for u, user in enumerate(("U001", "U002", "U003")):
                g = fd.create_group(f"{split}/{user}")
                n = 2 + u
                g.create_dataset(lab, data=eye_masks(rng, n, h, w))
                g.create_dataset(f"{lab}_filenames", data=np.array(
                    [f"{u}{i}.{split[:2]}.png".encode() for i in range(n)],
                    dtype="S13"))
                g.create_dataset("images_ss_filenames", data=np.array(
                    [b"x%d" % i for i in range(n)], dtype="S13"))
                if user != "U003":
                    fg.create_dataset(f"{split}/{user}",
                                      data=eye_masks(rng, 5 + u, h, w))
                if user == "U001":
                    fs.create_dataset(f"{split}/{user}",
                                      data=eye_masks(rng, 4, h, w))
    return data, gen, seq


def read_ranking(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("top_k", [0, 3])
def test_main_writes_the_jax_tools_ranking(jax_tool, tmp_path, top_k):
    data, gen, seq = write_inputs(tmp_path, np.random.default_rng(top_k))
    args = ["--dataroot", data, "--segmentations_generative", gen,
            "--segmentations_sequence", seq,
            "--splits", "train,validation,test"]
    args += ["--top_k", str(top_k)] if top_k else []
    sr.main(args + ["--out", str(tmp_path / "port.h5"), "--device", "cpu"])
    jax_tool.main(args + ["--out", str(tmp_path / "jax.h5")])
    got, want = (read_ranking(str(tmp_path / f)) for f in ("port.h5",
                                                           "jax.h5"))
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert got[name].dtype == v.dtype and got[name].shape == v.shape
        assert got[name].tobytes() == v.tobytes(), name
    n = 3 * (2 * 3 + 3 * 3)         # datasets: 3 splits, U001 2 and U002 3
    assert len(got) == n
    assert got["test/U001/00tepng/index"].shape == ((top_k or 9),)
    if not top_k:
        assert set(got["train/U001/00trpng/subset"]) == {b"g", b"s"}
    assert set(got["train/U002/11trpng/subset"]) == {b"g"}


def test_main_refuses_a_missing_card(monkeypatch, tmp_path):
    """``--device cuda`` (the default) without a card exits; it does not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sr.main(["--dataroot", "d", "--segmentations_generative", "g",
                 "--out", str(tmp_path / "o.h5")])
    assert not (tmp_path / "o.h5").exists()


@pytest.mark.parametrize("method", ["ref_first", "ref_random3"])
def test_loader_reads_a_port_built_ranking_as_the_jax_built_one(
        jax_tool, tmp_path, method):
    """The port's OpenEDSDataset picks the same references from the ranking
    the port built as from the one the JAX tool built, in every split."""
    from seg2eye_tpu_torch.data import openeds, schema
    from seg2eye_tpu_torch.options import Options

    rng = np.random.default_rng(11)
    n_gen, n_seq = 4, 3
    data = schema.write_synthetic_h5(str(tmp_path / "d.h5"), n_ss=2,
                                     n_gen=n_gen, n_seq=n_seq, h=48, w=30)
    gen, seq = str(tmp_path / "g.h5"), str(tmp_path / "s.h5")
    with h5py.File(gen, "w") as fg, h5py.File(seq, "w") as fs:
        for split in ("train", "validation", "test"):
            for user in ("U001", "U002"):
                fg.create_dataset(f"{split}/{user}",
                                  data=eye_masks(rng, n_gen, 48, 30))
                fs.create_dataset(f"{split}/{user}",
                                  data=eye_masks(rng, n_seq, 48, 30))
    args = ["--dataroot", data, "--segmentations_generative", gen,
            "--segmentations_sequence", seq]
    sr.main(args + ["--out", str(tmp_path / "port.h5"), "--device", "cpu"])
    jax_tool.main(args + ["--out", str(tmp_path / "jax.h5")])
    for key in ("train", "validation", "test"):
        items = []
        for ref in ("port.h5", "jax.h5"):
            opt = Options(dataroot=data, style_ref=str(tmp_path / ref),
                          style_sample_method=method, crop_size=32,
                          aspect_ratio=1.0, input_ns=3, isTrain=False,
                          no_flip=True).finalize()
            ds = openeds.OpenEDSDataset(opt, dataset_key=key)
            items.append([ds.__getitem__(i, np.random.default_rng(i))
                          ["style_image"] for i in range(len(ds))])
            ds.close()
        assert len(items[0]) == 4
        for a, b in zip(*items):
            assert a.tobytes() == b.tobytes()
