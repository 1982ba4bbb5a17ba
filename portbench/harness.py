"""One run of one cell: discovery by name, set-up, the measured window,
the traced slice, the check against the reference, and the result line.

Everything that belongs to one cell, configuration or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives:

  * ``workloads/<cell>.json``: the configuration, the driver, the traffic
    (sizes, arrays, ring), the compute dtype, the chips, the steps traced,
    and the limits of the check;
  * ``configs/<config>.json``: the model's sizes, its source and cuts;
  * ``drivers/<driver>.py``: the program's objects and timed step;
  * ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

The window is closed-loop with one batch in flight: step i starts when
step i - 1 has returned, and a serving step returns with its outputs on
the host.  It runs from the first step after set-up until the first step
that would start after ``seconds``, and ends when the device has finished
every step started; rates are taken over all its steps and all its time.
"""
from __future__ import annotations

import functools
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "seg2eye_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Optional[Dict]:
    path = ROOT / "BENCHMARK.json"
    return load_json(path) if path.exists() else None


def find_cell(name: str, bench: Optional[Dict] = None,
              root: Path = HERE) -> Dict:
    """``workloads/<name>.json`` under ``root``, checked against its entry
    in ``BENCHMARK.json`` where that names it."""
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell {name!r} ({path} is missing)")
    cell = {**load_json(path), "name": name}
    for entry in (bench or {}).get("workloads", []):
        if entry["name"] == name:
            for key in ("config", "traffic", "chips"):
                if entry[key] != cell[key]:
                    raise ValueError(f"cell {name}: BENCHMARK.json says "
                                     f"{key}={entry[key]!r}, its file "
                                     f"{cell[key]!r}")
    return cell


def find_config(name: str, root: Path = HERE) -> Dict:
    return load_json(root / "configs" / f"{name}.json")


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, root: Path = HERE):
    if root == HERE:
        return importlib.import_module(f"portbench.drivers.{name}").Driver
    return _load_file(root / "drivers" / f"{name}.py",
                      f"portbench_driver_{name}").Driver


def load_reader(metric: str, root: Path = HERE):
    """``metrics/<metric>.py``'s ``read`` (a metric name may hold dots)."""
    return _load_file(root / "metrics" / f"{metric}.py", "portbench_metric_"
                      + metric.replace(".", "_").replace("-", "_")).read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones (a metric without ``workloads`` in every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in mine
                             else [])]


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are in ``FORBIDDEN``,
    compared whole (``seg2eye_tpu_torch`` is not ``seg2eye_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name(device) -> str:
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(torch.device(device))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


@dataclass
class Run:
    """What the readers read."""
    cell: Dict
    cfg: Dict
    card: str
    setup_s: float
    steps: int                      # steps of the window
    seconds: float                  # the window's length
    latencies: List[float]          # each step's host seconds
    peak_bytes: int
    trace: object = None            # trace.Slice of a --trace 1 run
    driver: object = field(default=None, repr=False)

    @property
    def images(self) -> int:
        return self.steps * int(self.cell["sizes"]["batch"])

    @functools.cached_property
    def model_flops(self) -> float:
        """FLOPs of one step, counted on the reference (on ``meta``)."""
        return self.driver.model_flops()


def window(driver, seconds: float) -> Dict:
    i = driver.start
    latencies = []
    driver.sampling = True
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        driver.step(i)
        latencies.append(time.perf_counter() - t)
        i += 1
    driver.sync()
    t_end = time.perf_counter()
    driver.sampling = False
    return {"steps": len(latencies), "seconds": t_end - t_start,
            "latencies": latencies, "next": i}


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device, t0: float, bench: Dict, cfg: Optional[Dict] = None,
             root: Path = HERE) -> Dict:
    """One run -> the result dict (``checks`` last).  ``cfg``: the
    configuration, by default ``configs/<cell's config>.json``; ``root``:
    the folder the cell's files are found in."""
    import torch

    from portbench import trace as tr
    from portbench.driver import correct

    cfg = cfg or find_config(cell["config"], root)
    driver = load_driver(cell["driver"], root)(cell, cfg, seed, device)
    driver.setup()
    driver.sync()
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    w = window(driver, seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card = card_name(device)
    run = Run(cell=cell, cfg=cfg, card=card, setup_s=setup_s,
              steps=w["steps"],
              seconds=w["seconds"], latencies=w["latencies"],
              peak_bytes=peak, driver=driver)
    if trace:
        events, span = tr.profile_slice(driver.step, w["next"],
                                        int(cell["trace_steps"]), driver.sync)
        run.trace = tr.make_slice(events, span, int(cell["trace_steps"]))
        del events
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check()
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = load_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct(numbers), "attempted": w["steps"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.wall_s
        result["breakdown"] = tr.breakdown(run.trace)
    result["card"] = {"power_limit": power_limit() if cuda else "n/a",
                      "window_s": w["seconds"], "setup_s": setup_s}
    result["checks"] = {n["name"]: {"value": _finite(n["value"]),
                                    "limit": n["limit"]} for n in numbers}
    return result


def _finite(x: float):
    """A JSON-safe reading: a non-finite one as its name."""
    return x if math.isfinite(x) else str(x)


def format_checks(result: Dict) -> List[str]:
    def ok(v):
        return isinstance(v["value"], float) and v["value"] <= v["limit"]

    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            + ("" if ok(v) else "  FAILED")
            for k, v in result["checks"].items()]
