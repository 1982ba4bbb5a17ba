"""The harness finds every piece by name, and takes a new cell, traffic mix,
configuration or metric from new files alone."""
import json
import re
import shutil
import time

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_every_cell_config_and_metric_has_its_file(bench):
    for cell in bench["workloads"]:
        found = harness.find_cell(cell["name"], bench)
        harness.find_config(found["config"])
        assert harness.load_driver(found["driver"]) is not None
        assert set(found["limits"]), "a cell states the limits of its check"
    for config in bench["configs"]:
        assert (harness.ROOT / config["file"]).exists()
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(metric["name"]))


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert len(harness.cell_metrics(bench, cell, False)) >= 2
        assert harness.cell_metrics(bench, cell, True)
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def _copy_tree(tmp_path):
    root = tmp_path / "bench"
    for sub in ("workloads", "configs", "metrics", "drivers"):
        shutil.copytree(harness.HERE / sub, root / sub)
    return root


def test_a_new_cell_and_metric_are_files_alone(bench, tmp_path, tiny):
    """A cell of a new traffic mix and a new per-layer metric, each one new
    file (and their entries in BENCHMARK.json), run with no other edit."""
    root = _copy_tree(tmp_path)
    cell, cfg = tiny("seg2eye-score-bs32-bf16")
    new = {k: v for k, v in cell.items() if k != "name"}
    new.update(traffic="score-bs2-f32", sample=1, warmup=1)
    (root / "workloads" / "seg2eye-score-tiny.json").write_text(
        json.dumps(new))
    (root / "configs" / "seg2eye-tiny.json").write_text(json.dumps(cfg))
    (root / "metrics" / "steps_done.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(run):\n'
        '    return run.steps\n')
    new_bench = json.loads(json.dumps(bench))
    new_bench["workloads"].append(
        {"name": "seg2eye-score-tiny", "config": "seg2eye-default",
         "traffic": "score-bs2-f32", "chips": 1, "why": "a test cell"})
    for m in new_bench["end_to_end"]:
        if m["name"] == "infer_img_s":
            m["workloads"].append("seg2eye-score-tiny")
    new_bench["end_to_end"].append(
        {"name": "steps_done", "unit": "steps", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["seg2eye-score-tiny"]})
    found = harness.find_cell("seg2eye-score-tiny", new_bench, root)
    assert found["traffic"] == "score-bs2-f32"
    names = [m["name"] for m in
             harness.cell_metrics(new_bench, "seg2eye-score-tiny", False)]
    assert names == ["infer_img_s", "setup_s", "steps_done"]
    result = harness.run_cell(found, 2 ** 31 + 77, 0.5, False, "cpu",
                              time.perf_counter(), new_bench,
                              cfg=harness.find_config("seg2eye-tiny", root),
                              root=root)
    assert result["correct"] is True
    assert result["metrics"]["steps_done"]["value"] == result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_per_layer_metrics_without_workloads_follow_what_they_move(bench):
    b = json.loads(json.dumps(bench))
    b["per_layer"].append({"name": "x.train", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "step",
                           "moves": "train_img_s"})
    train = [w["name"] for w in b["workloads"]
             if "x.train" in [m["name"] for m in
                              harness.cell_metrics(b, w["name"], True)]]
    assert sorted(train) == sorted(
        next(m for m in b["end_to_end"]
             if m["name"] == "train_img_s")["workloads"])
