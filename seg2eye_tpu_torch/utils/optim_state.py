"""Optimizer states between ``torch.optim`` and the JAX package's optax
states, as flax writes them (``utils.flax_msgpack``).

Each JAX optimizer is an ``optax.inject_hyperparams`` state
{count, hyperparams: {learning_rate}, hyperparams_states: {},
inner_state} around a chain, whose states are maps indexed "0", "1", ...
and whose stateless members (``EmptyState``) are empty maps:

  * Seg2Eye (``seg2eye_tpu/train/state.py``): adam, or with weight decay
    add_decayed_weights -> scale_by_adam -> scale_by_learning_rate; the G
    optimizer wrapped in ``optax.masked`` with netE's ``fc_var`` dead
    (a ``MaskedNode``, an empty map, in mu and nu).  scale_by_adam's
    {count, mu, nu} are ``torch.optim.Adam``'s step, exp_avg and
    exp_avg_sq of each parameter, in the parameter's JAX layout; a dead
    leaf has no torch state, and the reverse.
  * RefineNet (``seg2eye_tpu/refinenet/training.py``): [clip] -> [decay]
    -> trace(nesterov) -> scale(-lr); segtrain (``seg2eye_tpu/segtrain/
    trainer.py``): [decay] -> trace -> masked(scale(10)) -> scale(-lr).
    The trace is ``torch.optim.SGD``'s momentum_buffer (both start at
    zero and take g + momentum * trace).

The moments take the layout steps of their parameters: each tree is built
by the network's importer (``utils.weights``) over its state_dict with
every parameter replaced by its moment, and read back by its exporter.
The injected learning rate is written as the optimizer's current one and
checked on load (``check_lr``), never taken: the port sets its own from
its schedule.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from seg2eye_tpu_torch.utils import weights

EMPTY: Dict = {}     # optax.EmptyState and MaskedNode, as flax writes them


def inject(count: int, lr: float, inner: Dict) -> Dict:
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def chain(*states) -> Dict:
    return {str(i): s for i, s in enumerate(states)}


def check_lr(tree: Dict, want: float, where: str) -> None:
    """The injected learning rate of a JAX optimizer state must be the one
    the port's schedule gives at that point (float32)."""
    got = float(tree["hyperparams"]["learning_rate"])
    if not np.isclose(np.float32(got), np.float32(want), rtol=1e-6, atol=0):
        raise ValueError(f"{where}: the checkpoint's learning rate {got!r} "
                         f"is not the port's schedule's {want!r} there: "
                         "another lr, schedule or data size")


def _param_names(net: nn.Module) -> Dict[torch.nn.Parameter, str]:
    return {p: name for name, p in net.named_parameters()}


def moment_tree(optimizer: torch.optim.Optimizer, net: nn.Module,
                importer: Callable, key: str):
    """The JAX 'params' tree of ``optimizer``'s ``key`` state of ``net``'s
    parameters (zeros where a parameter has none)."""
    sd = weights.numpy_state_dict(net)
    for p, name in _param_names(net).items():
        state = optimizer.state.get(p, {})
        sd[name] = (state[key].detach().cpu().numpy() if key in state
                    else np.zeros(tuple(p.shape), sd[name].dtype))
    return importer(sd)["params"]


def load_moments(optimizer: torch.optim.Optimizer, net: nn.Module,
                 importer: Callable, exporter: Callable,
                 trees: Dict[str, Dict], extra: Dict,
                 live: Callable[[str], bool] = lambda name: True) -> None:
    """Set ``optimizer.state`` of each live parameter of ``net`` to
    ``extra`` and, for each key of ``trees``, that 'params' tree's entry in
    torch layout."""
    variables = importer(weights.numpy_state_dict(net))
    sds = {key: exporter({**variables, "params": tree})
           for key, tree in trees.items()}
    for p, name in _param_names(net).items():
        optimizer.state.pop(p, None)
        if live(name):
            optimizer.state[p] = {**{k: v.clone() for k, v in extra.items()},
                                  **{key: torch.from_numpy(np.array(sd[name]))
                                     .to(device=p.device, dtype=p.dtype)
                                     for key, sd in sds.items()}}


# ------------------------------------------------------------- Seg2Eye Adam
def _dead_fc_var(name: str) -> bool:
    return name.startswith("fc_var.")


def _mask(tree: Dict) -> Dict:
    """netE's fc_var leaves as MaskedNodes (``train.state.ge_live_mask``)."""
    return {k: ({n: EMPTY for n in v} if k == "fc_var" else v)
            for k, v in tree.items()}


def _unmask(tree: Dict, like: Dict) -> Dict:
    return {k: ({n: np.zeros_like(like[k][n]) for n in v}
                if k == "fc_var" else v) for k, v in tree.items()}


def _adam_count(optimizer: torch.optim.Adam) -> int:
    steps = {int(s["step"]) for s in optimizer.state.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters are at different steps {steps}: "
                         "the JAX package's Adam has one count")
    return steps.pop() if steps else 0


def adam_to_jax(optimizer: torch.optim.Adam, nets: Dict[str, nn.Module],
                weight_decay: float, masked: bool) -> Dict:
    """A Seg2Eye ``torch.optim.Adam`` over ``nets`` ({"G", "E"}: opt_g,
    with the fc_var mask; {"D"}: opt_d) -> its optax state."""
    count = _adam_count(optimizer)
    trees = {}
    for key in ("exp_avg", "exp_avg_sq"):
        t = {name: moment_tree(optimizer, net, weights.IMPORTERS[name], key)
             for name, net in nets.items()}
        if "E" in t and masked:
            t["E"] = _mask(t["E"])
        trees[key] = t if len(t) > 1 else t[next(iter(t))]
    adam = {"count": np.asarray(count, np.int32), "mu": trees["exp_avg"],
            "nu": trees["exp_avg_sq"]}
    inner = (chain(EMPTY, adam, EMPTY) if weight_decay
             else chain(adam, EMPTY))
    if masked:
        inner = {"inner_state": inner}
    return inject(count, optimizer.param_groups[0]["lr"], inner)


def adam_from_jax(optimizer: torch.optim.Adam, nets: Dict[str, nn.Module],
                  tree: Dict, weight_decay: float, masked: bool) -> None:
    """The reverse of ``adam_to_jax``, into ``optimizer.state`` (the
    structure is checked by the caller)."""
    inner = tree["inner_state"]["inner_state"] if masked else tree["inner_state"]
    adam = inner["1" if weight_decay else "0"]
    count = int(adam["count"])
    for name, net in nets.items():
        mu, nu = adam["mu"], adam["nu"]
        if len(nets) > 1:
            mu, nu = mu[name], nu[name]
        if name == "E" and masked:
            like = weights.IMPORTERS["E"](weights.numpy_state_dict(net))
            mu, nu = (_unmask(t, like["params"]) for t in (mu, nu))
        if count == 0:
            for p in net.parameters():
                optimizer.state.pop(p, None)
            continue
        load_moments(optimizer, net, weights.IMPORTERS[name],
                     lambda v, n=name: weights.export_network(n, v),
                     {"exp_avg": mu, "exp_avg_sq": nu},
                     {"step": torch.tensor(float(count))},
                     (lambda n: not _dead_fc_var(n)) if name == "E" and masked
                     else (lambda n: True))


# ------------------------------------------------------ DeepLab SGD (trace)
def trace_tree(optimizer: torch.optim.SGD, net: nn.Module,
               backbone: str) -> Dict:
    return moment_tree(optimizer, net,
                       lambda sd: weights.import_deeplab(sd, backbone),
                       "momentum_buffer")


def load_trace(optimizer: torch.optim.SGD, net: nn.Module, backbone: str,
               trace: Dict, count: int) -> None:
    """The trace -> every parameter's momentum_buffer; no state at all
    before the first step (count 0), as a fresh SGD."""
    if count == 0:
        optimizer.state.clear()
        return
    load_moments(optimizer, net,
                 lambda sd: weights.import_deeplab(sd, backbone),
                 lambda v: weights.export_deeplab(v, backbone),
                 {"momentum_buffer": trace}, {})


def _trace_of(tree: Dict) -> Dict:
    inner = tree["inner_state"]
    (trace,) = [s["trace"] for s in inner.values() if "trace" in s]
    return trace


def refinenet_sgd_to_jax(optimizer: torch.optim.SGD, net: nn.Module, cfg,
                         count: int) -> Dict:
    """RefineNet/SegNet: [clip] -> [add_decayed_weights] -> trace ->
    scale(-lr)."""
    states = [EMPTY] * ((cfg.gradient_norm_clip > 0.0)
                        + bool(cfg.weight_decay))
    return inject(count, optimizer.param_groups[0]["lr"], chain(
        *states, {"trace": trace_tree(optimizer, net, cfg.backbone)}, EMPTY))


def segtrain_sgd_to_jax(optimizer: torch.optim.SGD, net: nn.Module, args,
                        count: int) -> Dict:
    """segtrain: [add_decayed_weights] -> trace -> masked(scale(10)) ->
    scale(-lr); the backbone group's lr is the injected one."""
    states = [EMPTY] * bool(args.weight_decay)
    return inject(count, optimizer.param_groups[0]["lr"], chain(
        *states, {"trace": trace_tree(optimizer, net, args.backbone)},
        {"inner_state": EMPTY}, EMPTY))


def sgd_from_jax(optimizer: torch.optim.SGD, net: nn.Module, backbone: str,
                 tree: Dict) -> None:
    load_trace(optimizer, net, backbone, _trace_of(tree), int(tree["count"]))
