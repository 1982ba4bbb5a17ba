"""PyTorch port, the generic DeepLabV3+ trainer (``seg2eye_tpu_torch.
segtrain``) against the JAX package's ``seg2eye_tpu.segtrain`` on the CPU:
the losses and their gradients, the confusion matrix and the evaluator,
the LR schedule, the data pipeline byte for byte, the class weights, the
Saver's tree, the image grids, one and three train steps and the eval
step against JAX's own ``SegTrainer`` steps, bfloat16 within JAX's own
gap, and the CLI with resume and ``--ft``.

Tiny sizes: ResNet-14 (one block a stage), 21 classes, crop 32 and 33,
batch 2.  The train steps are held as ``test_torch_refinenet_train.py``
holds RefineNet's: each step from the same state on both sides (the
port's weights, running statistics and momentum), in float64 (JAX under
``jax.enable_x64``, whose loss stays float32),
and float32 within JAX's own float32-vs-float64 distance.  JAX's dropout
is intercepted off (``flax.linen.intercept_methods``) and the port's step
runs with no generator.
"""
import functools
import math
import os
import subprocess
import sys
import types

import flax.linen as nn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seg2eye_tpu.models.deeplab import DeepLab as JDeepLab
from seg2eye_tpu.segtrain import colormap as jcolormap
from seg2eye_tpu.segtrain import datasets as jdatasets
from seg2eye_tpu.segtrain import losses as jlosses
from seg2eye_tpu.segtrain import lr_scheduler as jlr
from seg2eye_tpu.segtrain import metrics as jmetrics
from seg2eye_tpu.segtrain import saver as jsaver
from seg2eye_tpu.segtrain import summaries as jsummaries
from seg2eye_tpu.segtrain import trainer as jtrainer
from seg2eye_tpu.segtrain import weights as jweights
from seg2eye_tpu_torch.models.deeplab import RESNET_LAYERS
from seg2eye_tpu_torch.segtrain import colormap, datasets, losses, \
    lr_scheduler, metrics, saver, summaries, trainer, weights
from test_segtrain import Args, make_cityscapes, make_coco, make_sbd, make_voc
from test_torch_refinenet import GAP_RATIO, free_disk  # noqa: F401
from test_torch_refinenet_train import (BF16_SCALAR_ATOL, POOL_RTOL,
                                        QUIET_RTOL, STEP_ATOL, as_port,
                                        distances, jax_variables, snapshot)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCLASS = 21
STEP_HW = 33                  # odd, as the CLI's crop 513
STEP_LR = 1e-4                # the backbone's; the head runs at 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while this module runs (see
    test_torch_refinenet.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_args(**kw):
    """The tests' segtrain args (ResNet-14, crop 32, batch 2) on the CPU,
    float32."""
    return Args(**{"no_cuda": True, "precision": "float32", **kw})


# --------------------------------------------------------------- losses
def loss_inputs(dtype, seed=0):
    """NHWC logits and labels with 255 and out-of-range values (-1, 21,
    100), and class weights."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 5, 7, NCLASS)).astype(dtype) * 2
    target = rng.integers(0, NCLASS, (2, 5, 7)).astype(np.float32)
    target[0, 0, :] = 255
    target[1, 1, :3] = (-1, NCLASS, 100)
    weight = rng.uniform(0.5, 3.0, NCLASS)
    return logits, target, weight


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode,weighted", [("ce", False), ("ce", True),
                                           ("focal", False)],
                         ids=["ce", "weighted-ce", "focal"])
def test_losses_match_jax(mode, weighted, dtype):
    """CE, weighted CE and focal on NCHW logits against the JAX package's
    on NHWC ones: the value and the logits' gradient to 2e-6 relative
    (float32 rounding: the JAX package computes in float32 also from
    float64 logits, the port in float64 there; measured at most 1.4e-7).
    The port's loss is float32 from float32 logits, float64 from float64."""
    logits, target, weight = loss_inputs(dtype)
    w = weight if weighted else None
    with jax.enable_x64(dtype == np.float64):
        jfn = jlosses.SegmentationLosses(weight=w).build_loss(mode)
        jval, jgrad = jax.value_and_grad(
            lambda x: jfn(x, jnp.asarray(target)))(jnp.asarray(logits))
        jval, jgrad = float(jval), np.asarray(jgrad)
    x = torch.from_numpy(np.moveaxis(logits, -1, 1).copy()).requires_grad_()
    val = losses.SegmentationLosses(weight=w).build_loss(mode)(
        x, torch.from_numpy(target))
    val.backward()
    assert val.dtype == x.dtype == x.grad.dtype
    assert abs(val.item() - jval) <= 2e-6 * abs(jval)
    grad = np.moveaxis(x.grad.numpy(), 1, -1)
    assert np.abs(grad - jgrad).max() <= 2e-6 * np.abs(jgrad).max()
    # the dropped pixels get no gradient
    assert not grad[0, 0].any() and not grad[1, 1, :3].any()
    with pytest.raises(NotImplementedError):
        losses.SegmentationLosses().build_loss("dice")


# -------------------------------------------------------------- metrics
def test_confusion_matrix_and_evaluator_match_jax():
    """The confusion matrix is JAX's as integers (labels 255, -1 and 21
    dropped); over three batches the evaluator's float64 matrix and its
    four metrics equal JAX's, under both method names, through
    add_batch and add_matrix."""
    rng = np.random.default_rng(3)
    ev, jev = metrics.Evaluator(NCLASS), jmetrics.Evaluator(NCLASS)
    for b in range(3):
        gt = rng.integers(0, NCLASS - 2, (2, 17, 13))
        gt[gt == 3] = 255
        gt[0, 0, :3] = (-1, NCLASS, 255)
        pred = rng.integers(0, NCLASS, (2, 17, 13))
        conf = metrics.confusion_matrix(torch.from_numpy(gt),
                                        torch.from_numpy(pred), NCLASS)
        jconf = np.asarray(jmetrics.confusion_matrix(
            jnp.asarray(gt), jnp.asarray(pred), NCLASS))
        assert conf.dtype == torch.int64
        np.testing.assert_array_equal(conf.numpy(), jconf)
        if b == 1:
            ev.add_matrix(conf)
        else:
            ev.add_batch(gt, pred)
        jev.add_batch(gt, pred)
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    for name in ("Pixel_Accuracy", "Pixel_Accuracy_Class",
                 "Mean_Intersection_over_Union",
                 "Frequency_Weighted_Intersection_over_Union",
                 "pixel_accuracy", "mean_intersection_over_union"):
        assert getattr(ev, name)() == getattr(jev, name)(), name
    ev.reset()
    assert ev.confusion.sum() == 0


# ----------------------------------------------------------- schedule
@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("mode", ["poly", "cos", "step"])
def test_lr_scheduler_matches_jax_bit_for_bit(mode, warmup):
    """Every (i, epoch) of 6 epochs of 7 iterations; 'step' without
    lr_step raises as JAX's does."""
    kw = dict(iters_per_epoch=7, warmup_epochs=warmup,
              lr_step=2 if mode == "step" else 0)
    ours = lr_scheduler.LRScheduler(mode, 0.007, 6, **kw)
    ref = jlr.LRScheduler(mode, 0.007, 6, **kw)
    for epoch in range(6):
        for i in range(7):
            assert ours(i, epoch) == ref(i, epoch), (i, epoch)
    if mode == "step":
        for cls in (lr_scheduler.LRScheduler, jlr.LRScheduler):
            with pytest.raises(AssertionError):
                cls("step", 0.007, 6, iters_per_epoch=7)


# ----------------------------------------------------------------- data
def assert_same_batch(got, want):
    assert sorted(got) == sorted(want) == ["image", "label"]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def dataset_tree(name, root):
    """A synthetic tree of ``name`` under ``root`` and the args that read
    it (crop 33, batch 2)."""
    if name == "pascal-sbd":
        make_voc(root, ["a", "b", "c", "d", "e"], ["c", "v", "w"])
        make_sbd(root, ["b", "f", "g"])
        return Args(data_root=root, base_size=40, crop_size=33,
                    use_sbd=True, workers=0)
    if name == "cityscapes":
        make_cityscapes(root, n=3)
        return Args(data_root=root, dataset="cityscapes", base_size=48,
                    crop_size=33, workers=0)
    make_coco(root, n=3)
    return Args(data_root=root, dataset="coco", base_size=48, crop_size=33,
                workers=0)


@pytest.mark.parametrize("name", ["pascal-sbd", "cityscapes", "coco"])
def test_make_data_loader_matches_jax_byte_for_byte(name, tmp_path):
    """make_data_loader's loaders yield the JAX package's batches byte for
    byte from one seed: two shuffled training passes (random flip, scale
    crop and blur; VOC with SBD through CombineDBs, VOC's val id excluded)
    and every val and test batch, the tail batch included.  Each package
    reads a tree of its own from the same makers (COCO writes its id cache
    into it: the caches must agree too).  Then the class weights over the
    train set, and their cache file."""
    ours_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    args = dataset_tree(name, ours_root)
    jargs = dataset_tree(name, jax_root)
    ours = datasets.make_data_loader(args, seed=5)
    ref = jdatasets.make_data_loader(jargs, seed=5)
    assert ours[3] == ref[3] and (ours[2] is None) == (ref[2] is None)
    if name == "pascal-sbd":
        assert ours[0].dataset.im_ids == ["a", "b", "d", "e", "f", "g"]
    for passes, got, want in ((2, ours[0], ref[0]), (1, ours[1], ref[1]),
                              (1, ours[2], ref[2])):
        if want is None:
            continue
        assert len(got) == len(want)
        for _ in range(passes):
            gots, wants = list(got), list(want)
            assert len(gots) == len(wants) == len(want)
            for g, w in zip(gots, wants):
                assert_same_batch(g, w)
    if name == "coco":
        ids = "coco/annotations/train_ids_2017.npy"
        assert np.array_equal(np.load(os.path.join(ours_root, ids)),
                              np.load(os.path.join(jax_root, ids)))
    full = [datasets.DataLoader(ours[0].dataset, batch_size=2),
            jdatasets.DataLoader(ref[0].dataset, batch_size=2,
                                 shuffle=False, drop_last=False, prefetch=0)]
    w = weights.calculate_weights_labels(ours_root, name, full[0], ours[3])
    jw = jweights.calculate_weights_labels(jax_root, name, full[1], ref[3])
    assert w.dtype == np.float64 and w.tobytes() == jw.tobytes()
    cache = name + "_classes_weights.npy"
    with open(os.path.join(ours_root, cache), "rb") as f, \
            open(os.path.join(jax_root, cache), "rb") as g:
        assert f.read() == g.read()


def rle_string(counts):
    """The cocoapi's compressed-RLE string of run counts."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not c & 0x10 or x == -1 and c & 0x10)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def test_coco_decoders_match_jax():
    """Compressed and uncompressed RLE and polygons (one layer each) decode
    to the JAX package's masks."""
    counts = [5, 300, 2, 61, 8, 100, 3, 1057]
    for seg in ({"size": [24, 64], "counts": rle_string(counts)},
                {"size": [24, 64], "counts": counts},
                [[2.0, 3.0, 50.0, 4.0, 40.0, 20.0], [0.0, 0.0, 9.0, 0.5],
                 [10.0, 10.0, 30.0, 10.0, 30.0, 22.0, 10.0, 22.0]]):
        got = datasets._decode_segmentation(seg, 24, 64)
        want = jdatasets._decode_segmentation(seg, 24, 64)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes() and got.any()
    assert datasets._rle_counts_from_string(rle_string(counts)) == counts


def test_colormap_and_image_grids_match_jax():
    """decode/encode_segmap are JAX's; visualize_image's three grids equal
    JAX's from NCHW logits (JAX: NHWC) and the same host images."""
    rng = np.random.default_rng(4)
    lab = rng.integers(0, NCLASS, (3, 10, 12))
    lab[0, 0] = 255
    for ds in ("pascal", "cityscapes"):
        np.testing.assert_array_equal(colormap.decode_segmap(lab, ds),
                                      jcolormap.decode_segmap(lab, ds))
    rgb = (jcolormap.decode_segmap(lab[1], "pascal") * 255).round()
    np.testing.assert_array_equal(colormap.encode_segmap(rgb),
                                  jcolormap.encode_segmap(rgb))

    class Writer:
        def __init__(self):
            self.images = {}

        def update_current_step(self, step):
            self.step = step

        def add_image(self, tag, img):
            self.images[tag] = (self.step, np.asarray(img))

    image = rng.normal(size=(4, 10, 12, 3)).astype(np.float32)
    logits = rng.normal(size=(4, NCLASS, 10, 12)).astype(np.float32)
    target = lab.astype(np.float32)
    ours, ref = Writer(), Writer()
    summaries.TensorboardSummary(None).visualize_image(
        ours, "pascal", image, target, torch.from_numpy(logits), 7)
    jsummaries.TensorboardSummary(None).visualize_image(
        ref, "pascal", image, target, np.moveaxis(logits, 1, -1), 7)
    assert sorted(ours.images) == sorted(ref.images) and len(ref.images) == 3
    for tag, (step, img) in ref.images.items():
        assert ours.images[tag][0] == step == 7
        assert ours.images[tag][1].tobytes() == img.tobytes(), tag


# ---------------------------------------------------------------- saver
def saver_tree(pkg, root, monkeypatch):
    """Three runs of ``pkg``'s Saver under ``root`` (best mIoU 0.5, then
    0.4, then 0.3 and 0.6), then eight empty experiment directories and a
    fifth Saver (the lexicographic id).  -> (the files, parameters.txt,
    best_pred of model_best.ckpt after each run, the fifth's directory)."""
    monkeypatch.chdir(root)
    args = Args(checkname="deeplab-test", lr=0.007)
    promoted = []

    def state(best):
        if pkg is saver:
            return {"epoch": 1, "best_pred": best,
                    "state_dict": {"w": torch.tensor([best])},
                    "optimizer": {}}
        return {"epoch": 1, "best_pred": best, "params": {"w": np.array(
            [best], np.float32)}}

    def best_of_model_best():
        path = os.path.join("run", "pascal", "deeplab-test", "model_best.ckpt")
        if pkg is saver:
            return float(torch.load(path, weights_only=True)["best_pred"])
        with open(path, "rb") as f:
            return float(flax.serialization.msgpack_restore(
                f.read())["best_pred"])

    for bests in ((0.5,), (0.4,), (0.3, 0.6)):
        s = pkg.Saver(args)
        s.save_experiment_config()
        s.save_checkpoint(state(0.1), is_best=False)
        for best in bests:
            s.save_checkpoint(state(best), is_best=True)
            promoted.append(best_of_model_best())
    for i in range(3, 11):
        os.makedirs(os.path.join("run", "pascal", "deeplab-test",
                                 f"experiment_{i}"), exist_ok=True)
    fifth = pkg.Saver(args).experiment_dir
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs
                   if not f.startswith("events."))
    with open(os.path.join(root, "run", "pascal", "deeplab-test",
                           "experiment_0", "parameters.txt")) as f:
        text = f.read()
    return files, text, promoted, fifth


def test_saver_matches_jax(tmp_path, monkeypatch):
    """The same run directories, files and parameters.txt text (the
    'datset' key), best_pred.txt promotion to model_best.ckpt only over
    every earlier run's best, and experiment_10 again after eleven runs
    (the lexicographic sort)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = saver_tree(saver, tmp_path / "port", monkeypatch)
    ref = saver_tree(jsaver, tmp_path / "jax", monkeypatch)
    assert ours == ref
    assert ours[1].startswith("datset:pascal\nbackbone:resnet\n")
    assert ours[2] == [0.5, 0.5, 0.5, 0.6]
    assert ours[3].endswith("experiment_10")


# ------------------------------------------------- steps against JAX
def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every nn.Dropout returns its input."""
    if isinstance(context.module, nn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


class JaxSegSteps:
    """JAX's own SegTrainer train and eval steps, built by its
    ``_build_train_step``/``_build_eval_step`` on a SegTrainer that holds
    only what they read (args, model, criterion, tx, nclass), traced and
    run with dropout intercepted off, from a port trainer's state.  Modes:
    "f32", "bf16" (``--precision bfloat16``) and "f64" (the compute dtype
    float64 under ``jax.enable_x64``)."""

    def __init__(self, args, weight=None):
        self.args, self.weight = args, weight
        self.model = JDeepLab(backbone="resnet", output_stride=16,
                              num_classes=NCLASS,
                              resnet_layers=RESNET_LAYERS[14])
        self.shapes = jax.eval_shape(
            functools.partial(self.model.init, train=False),
            jax.random.PRNGKey(0), jnp.zeros((1, STEP_HW, STEP_HW, 3)))
        self.trainers = {}

    def trainer(self, mode):
        if mode not in self.trainers:
            args = types.SimpleNamespace(**{
                **vars(self.args),
                "precision": "bfloat16" if mode == "bf16" else "float32"})
            t = jtrainer.SegTrainer.__new__(jtrainer.SegTrainer)
            t.args, t.nclass, t.model = args, NCLASS, self.model
            t.criterion = jlosses.SegmentationLosses(
                weight=self.weight).build_loss(args.loss_type)
            t.tx = jtrainer.make_optimizer(args)
            if mode == "f64":
                t._compute_dtype = lambda: jnp.float64
            t.train_fn, t.eval_fn = t._build_train_step(), \
                t._build_eval_step()
            self.trainers[mode] = t
        return self.trainers[mode]

    def variables(self, port, dtype, momentum=False):
        """The port trainer's weights and running statistics (or, with
        ``momentum``, its momentum buffers in the parameters' places) as
        JAX variables."""
        sd = {k: v.detach().cpu().numpy().astype(dtype)
              for k, v in port.net.state_dict().items()}
        if momentum:
            opt = port.optimizer
            sd.update({n: opt.state[p]["momentum_buffer"].cpu().numpy()
                       .astype(dtype)
                       for n, p in port.net.named_parameters()
                       if p in opt.state})
        return jax_variables(sd, self.shapes, "resnet", dtype)

    def train_step(self, port, image, target, lr, mode):
        """One JAX step from ``port``'s state -> ({"loss"}, variables,
        trace, logits NHWC)."""
        dtype = np.float64 if mode == "f64" else np.float32
        t = self.trainer(mode)
        variables = self.variables(port, dtype)
        with jax.enable_x64(mode == "f64"):
            # tx.init's state, built from its shapes (no eager op)
            opt = jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, a.dtype),
                jax.eval_shape(t.tx.init, variables["params"]))
            if port.optimizer.state:
                trace = self.variables(port, dtype, momentum=True)["params"]
                opt = opt._replace(inner_state=tuple(
                    s._replace(trace=trace) if hasattr(s, "trace") else s
                    for s in opt.inner_state))
            with nn.intercept_methods(no_dropout):
                new, loss, logits = t.train_fn(
                    {**variables, "opt": opt}, image.astype(dtype), target,
                    jnp.asarray(lr, dtype), jax.random.PRNGKey(0))
            trace = next(s for s in new["opt"].inner_state
                         if hasattr(s, "trace")).trace
            return jax.device_get(({"loss": loss},
                                   {"params": new["params"],
                                    "batch_stats": new["batch_stats"]},
                                   trace, logits))

    def eval_step(self, port, image, target):
        variables = self.variables(port, np.float32)
        with nn.intercept_methods(no_dropout):
            return jax.device_get(self.trainer("f32").eval_fn(
                variables["params"], variables["batch_stats"], image,
                target))


def step_batches(n, seed=0):
    """``n`` normalised NHWC batches of 2 at 33x33 and float32 labels in
    0..20 with 255s and out-of-range values, as the loader gives them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image = rng.normal(size=(2, STEP_HW, STEP_HW, 3)).astype(np.float32)
        label = rng.integers(0, NCLASS, (2, STEP_HW, STEP_HW))
        label[:, :3] = 255
        label[1, 5, :4] = (NCLASS, 30, 100, -1)
        out.append((image, label.astype(np.float32)))
    return out


def port_trainer(tmp_path, monkeypatch, **kw):
    """A port SegTrainer at ResNet-14 (seed 1) on the CPU, its run
    directory under ``tmp_path``; stand-in loaders of 3 and 1 batches."""
    monkeypatch.chdir(tmp_path)
    args = port_args(data_root=str(tmp_path), lr=STEP_LR, **kw)
    return trainer.SegTrainer(args, loaders=([None] * 3, [None], None,
                                             NCLASS))


def port_step(t, image, label, lr):
    """One port step -> (({"loss"}, state_dict, momentum, gradients),
    logits NHWC)."""
    loss, logits = t.train_step(torch.from_numpy(image),
                                torch.from_numpy(label), lr)
    net, opt = t.net, t.optimizer
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    mom = {n: opt.state[p]["momentum_buffer"].clone()
           for n, p in net.named_parameters()}
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return (({"loss": float(loss)}, sd, mom, grads),
            logits.permute(0, 2, 3, 1).double().numpy())


def trainer_state(t):
    """The view of a port SegTrainer that snapshot() reads."""
    return types.SimpleNamespace(model=types.SimpleNamespace(net=t.net),
                                 optimizer=t.optimizer)


def logits_gap(got, want):
    return float(np.abs(got - want).max() / (1 + np.abs(want).max()))


STEP_CASES = {"ce": {},
              "freeze-bn": {"freeze_bn": True, "nesterov": True},
              "focal-balanced": {"loss_type": "focal", "nesterov": True,
                                 "use_balanced_weights": True}}
# float64 steps compared: (steps with the ASPP global pool live, steps
# from a state with its conv zeroed)
STEP_COUNTS = {"ce": (3, 1), "freeze-bn": (2, 0), "focal-balanced": (1, 1)}


@pytest.fixture(scope="module")
def ce_steps():
    """JAX's steps for the CLI's defaults (CE, no Nesterov), shared by the
    tests that run them: each program is compiled once."""
    return JaxSegSteps(port_args(lr=STEP_LR))


def f64_steps(t, jx, state, batches, lrs, pool_zeroed=False):
    """Float64 steps of the port trainer ``t`` from ``state`` (a fresh
    optimizer; the ASPP global pool's conv zeroed when ``pool_zeroed``),
    each against JAX's from the port's state -> (distances, JAX's
    result) of each."""
    if pool_zeroed:
        pool = "aspp.global_avg_pool.1.weight"
        state = {**state, pool: torch.zeros_like(state[pool])}
    t.net.load_state_dict(state)
    t.optimizer = trainer.make_optimizer(t.net, t.args)
    wd, mom = t.args.weight_decay, t.args.momentum
    out = []
    for (image, label), lr in zip(batches, lrs):
        before = snapshot(trainer_state(t))
        stats = {k: v.clone() for k, v in t.net.state_dict().items()
                 if "running" in k}
        want = jx.train_step(t, image, label, lr, "f64")
        got, logits = port_step(t, image, label, lr)
        assert [g["lr"] for g in t.optimizer.param_groups] == [lr, 10 * lr]
        d = distances(got, want[:3], before, wd, mom)
        d["logits"] = logits_gap(logits, want[3])
        if t.args.freeze_bn:             # running statistics untouched
            assert all(torch.equal(t.net.state_dict()[k], v)
                       for k, v in stats.items())
        out.append((d, want))
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case, tmp_path, monkeypatch, ce_steps):
    """Float64 train steps of the port's SegTrainer against JAX's
    SegTrainer.train_step, each from the port's state on both sides (the
    head at 10x the backbone's lr, weight decay 5e-4 on every parameter):
    the loss, the logits, the parameters and running statistics to
    STEP_ATOL; the gradients (read off JAX's trace) and the momentum per
    tensor (NET_FLOOR) to QUIET_RTOL in a first step with the ASPP global
    pool's conv zeroed, and within POOL_RTOL over three steps (``ce``) or
    one (``focal-balanced``) with it live: its BN normalises over the
    batch's two samples and amplifies the float32 rounding of JAX's loss
    into every gradient upstream (measured 3.8e-8 to 1.2e-6 zeroed, 9.6e-6
    to 2.5e-4 live).  ``freeze-bn``
    (Nesterov) has no train-mode BN: its two steps are held to
    QUIET_RTOL (measured at most 1.3e-7) and leave the running statistics
    bit for bit.  ``focal-balanced`` (Nesterov) reads its class weights
    from the cache file.  For ``ce`` also the float32 eval step (the loss
    to 1e-5, the confusion matrix equal as integers) and a float32 train
    step no further from JAX's float64 step than GAP_RATIO times JAX's
    own float32 step (measured ratios 0.22-1.6)."""
    kw = STEP_CASES[case]
    weight = None
    if kw.get("use_balanced_weights"):
        weight = np.random.default_rng(9).uniform(0.5, 3.0, NCLASS)
        root = datasets.db_root_dir("pascal", str(tmp_path))
        os.makedirs(root)
        np.save(os.path.join(root, "pascal_classes_weights.npy"), weight)
    t = port_trainer(tmp_path, monkeypatch, **kw)
    jx = ce_steps if case == "ce" else JaxSegSteps(t.args, weight)
    init = {k: v.clone() for k, v in t.net.state_dict().items()}
    batches = step_batches(3, seed=len(case))
    lrs = [t.scheduler(i, 0) for i in range(3)]
    assert lrs[0] == STEP_LR
    wd, mom = t.args.weight_decay, t.args.momentum

    if case == "ce":
        image, label = batches[0]
        loss, conf = t.eval_step(torch.from_numpy(image),
                                 torch.from_numpy(label))
        jloss, jconf = jx.eval_step(t, image, label)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        np.testing.assert_array_equal(conf.numpy(), jconf)
        assert conf.sum() == (label[label < NCLASS] >= 0).sum()
        before = snapshot(trainer_state(t))
        want32 = jx.train_step(t, image, label, lrs[0], "f32")
        got32, logits32 = port_step(t, image, label, lrs[0])

    t.net.double()
    t.dtype = torch.float64
    live, zeroed = STEP_COUNTS[case]
    runs = [(f64_steps(t, jx, init, batches[:live], lrs),
             QUIET_RTOL if kw.get("freeze_bn") else POOL_RTOL)]
    if zeroed:
        runs.append((f64_steps(t, jx, init, batches[:zeroed], lrs,
                               pool_zeroed=True), QUIET_RTOL))
    for steps, rtol in runs:
        for step, (d, _) in enumerate(steps):
            for k, v in d.items():
                assert v <= (rtol if k in ("grads", "momentum")
                             else STEP_ATOL), (step, d)

    if case == "ce":                     # float32 against JAX's own gap
        want64 = runs[0][0][0][1]        # the first live step, from init
        d = distances(got32, want64[:3], before, wd, mom)
        d["logits"] = logits_gap(logits32, want64[3])
        gap = distances(as_port(want32[:3], before, wd, mom), want64[:3],
                        before, wd, mom)
        gap["logits"] = logits_gap(want32[3], want64[3])
        for k, v in d.items():
            assert v <= max(GAP_RATIO * gap[k],
                            STEP_ATOL if k == "params" else 0.0), (k, d, gap)


def test_bf16_train_step_within_jax_bf16_gap(tmp_path, monkeypatch,
                                             ce_steps):
    """A ``--precision bfloat16`` step (bfloat16 compute, float32 weights,
    running statistics, momentum and loss) is no further from JAX's
    float32 step than JAX's own bfloat16 step, from the same state: the
    loss, the parameters, the running statistics, the momentum and the
    gradients each within GAP_RATIO times JAX's distance (measured ratios
    0.14-1.53), the loss (a scalar either side may round either way) at
    least to BF16_SCALAR_ATOL."""
    t = port_trainer(tmp_path, monkeypatch, precision="bfloat16")
    assert t.dtype == torch.bfloat16
    image, label = step_batches(1, seed=7)[0]
    wd, mom = t.args.weight_decay, t.args.momentum
    before = snapshot(trainer_state(t))
    want32 = ce_steps.train_step(t, image, label, STEP_LR, "f32")
    want16 = ce_steps.train_step(t, image, label, STEP_LR, "bf16")
    got, _ = port_step(t, image, label, STEP_LR)
    assert all(p.dtype == torch.float32 for p in t.net.parameters())
    d = distances(got, want32[:3], before, wd, mom)
    gap = distances(as_port(want16[:3], before, wd, mom), want32[:3], before,
                    wd, mom)
    assert gap["grads"] > 0 and all(np.isfinite(v) for v in d.values())
    for k, v in d.items():
        assert v <= max(GAP_RATIO * gap[k],
                        BF16_SCALAR_ATOL if k == "scalars" else 0.0), \
            (k, d, gap)


# ------------------------------------------------- trainer and CLI
@pytest.mark.parametrize("dataset", ["pascal", "cityscapes", "coco"])
def test_finalize_args_match_jax(dataset, monkeypatch):
    """Every default of the port's CLI is the JAX CLI's on one device, for
    each dataset, also with --batch-size 16 (the lr scales with it)."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for extra in ([], ["--batch-size", "16", "--backbone", "mobilenet"]):
        argv = ["--dataset", dataset, *extra]
        ours = trainer.finalize_args(trainer.build_argparser().parse_args(
            argv))
        ref = jtrainer.finalize_args(jtrainer.build_argparser().parse_args(
            argv))
        assert vars(ours) == vars(ref)
    if dataset == "pascal":
        ours = trainer.finalize_args(trainer.build_argparser().parse_args([]))
        assert (ours.batch_size, ours.lr, ours.epochs, ours.crop_size) == \
            (4, 0.007, 50, 513)


def test_trainer_needs_a_card_unless_no_cuda(tmp_path, monkeypatch):
    """Without --no-cuda the trainer runs on the card; with none it refuses
    before it writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.SegTrainer(port_args(no_cuda=False),
                           loaders=([None], [None], None, NCLASS))
    assert not os.path.exists("run")


def voc_tree(tmp_path):
    root = str(tmp_path / "data")
    make_voc(root, ["a", "b", "c", "d"], ["v1", "v2", "v3"], h=40, w=40)
    make_sbd(root, ["b", "e"], h=40, w=40)
    return root


def test_cli_trains_two_epochs(tmp_path):
    """``python -m seg2eye_tpu_torch.segtrain --no-cuda`` (MobileNet, crop
    32, batch 2) trains 2 epochs over a synthetic VOC + SBD tree: finite
    losses, mIoU in [0, 1], the reference's run files."""
    root = voc_tree(tmp_path)
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "seg2eye_tpu_torch.segtrain", "--no-cuda",
         "--data-root", root, "--backbone", "mobilenet", "--crop-size", "32",
         "--base-size", "40", "--batch-size", "2", "--epochs", "2",
         "--workers", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    loss = [float(l.split(":")[1]) for l in out.splitlines()
            if l.startswith("Loss:")]
    miou = [float(l.split("mIoU:")[1].split(",")[0])
            for l in out.splitlines() if "mIoU:" in l]
    assert len(loss) == 4 and all(math.isfinite(v) for v in loss), out
    assert len(miou) == 2 and all(0.0 <= v <= 1.0 for v in miou), out
    assert "Combined number of images: 5" in out
    run = tmp_path / "run" / "pascal" / "deeplab-mobilenet"
    exp = run / "experiment_0"
    for f in ("parameters.txt", "best_pred.txt", "checkpoint.ckpt"):
        assert (exp / f).is_file(), f
    assert (run / "model_best.ckpt").is_file()
    ckpt = torch.load(exp / "checkpoint.ckpt", weights_only=True)
    assert sorted(ckpt) == ["best_pred", "epoch", "optimizer", "state_dict"]
    assert float((exp / "best_pred.txt").read_text()) == ckpt["best_pred"]


def test_trainer_resume_ft_no_val_and_weights(tmp_path, monkeypatch):
    """SegTrainer over a synthetic VOC tree (MobileNet, crop 32, batch 2):
    an epoch and a validation write the checkpoint; a resumed trainer has
    its epoch, best_pred, weights, running statistics and momentum bit for
    bit and evaluates to the same loss and matrix; ``--ft`` starts at
    epoch 0 with no momentum.  --no-val checkpoints each epoch and writes
    no best_pred.txt; --use-balanced-weights computes and caches the class
    weights over the whole train set."""
    root = voc_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    kw = dict(data_root=root, base_size=40, crop_size=32, use_sbd=False,
              epochs=2, lr=0.01, backbone="mobilenet")
    t = trainer.SegTrainer(port_args(**kw))
    steps = []
    loss = t.training(0, step_hook=lambda i, v: steps.append((i, v)))
    miou = t.validation(0)
    assert [i for i, _ in steps] == [0, 1] and math.isfinite(loss)
    assert 0.0 <= miou <= 1.0 and t.best_pred == miou
    path = os.path.join(t.saver.experiment_dir, "checkpoint.ckpt")

    r = trainer.SegTrainer(port_args(resume=path, **kw))
    assert r.args.start_epoch == 1 and r.best_pred == t.best_pred
    for k, v in t.net.state_dict().items():
        assert torch.equal(r.net.state_dict()[k], v), k
    for p, q in zip(t.net.parameters(), r.net.parameters()):
        assert torch.equal(t.optimizer.state[p]["momentum_buffer"],
                           r.optimizer.state[q]["momentum_buffer"])
    batch = next(iter(t.val_loader))
    x, y = torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"])
    for a, b in zip(t.eval_step(x, y), r.eval_step(x, y)):
        assert torch.equal(a, b)

    f = trainer.SegTrainer(port_args(resume=path, ft=True, **kw))
    assert f.args.start_epoch == 0 and not f.optimizer.state
    assert all(torch.equal(f.net.state_dict()[k], v)
               for k, v in t.net.state_dict().items())

    n = trainer.SegTrainer(port_args(no_val=True, use_balanced_weights=True,
                                     checkname="deeplab-noval", **kw))
    cache = os.path.join(root, "VOCdevkit", "VOC2012",
                         "pascal_classes_weights.npy")
    w = np.load(cache)
    assert w.shape == (NCLASS,) and (w > 0).all()
    np.testing.assert_array_equal(n.criterion.__self__.weight.numpy(),
                                  w.astype(np.float32))
    n.training(0)
    assert os.path.isfile(os.path.join(n.saver.experiment_dir,
                                       "checkpoint.ckpt"))
    assert not os.path.exists(os.path.join(n.saver.experiment_dir,
                                           "best_pred.txt"))
