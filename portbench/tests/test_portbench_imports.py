"""What a run may import: no JAX, no JAX package (top-level names compared
whole), and a reference that imports nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("names, found", [
    (["seg2eye_tpu_torch", "seg2eye_tpu_torch.ops"], []),
    (["seg2eye_tpu_torchx", "jaxtyping", "flax_like"], []),
    (["seg2eye_tpu.models"], ["seg2eye_tpu"]),
    (["jax._src.core", "optax"], ["jax", "optax"]),
])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, names,
                                                         found):
    for name in names:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == found


def test_reference_and_yardstick_import_nothing_of_the_program():
    files = list((BENCH / "reference").glob("*.py")) + [
        BENCH / f for f in ("roofline.py", "traffic.py", "trace.py",
                            "readers.py")]
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("seg2eye_tpu_torch", "seg2eye_tpu", "jax",
                               "flax", "optax", "jaxlib"), (path, name)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_a_cpu_run_of_a_cell_leaves_no_jax(tiny):
    import time

    cell, cfg = tiny("refinenet-serve-bs32-bf16")
    cell.update(sample=1, warmup=1)
    harness.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter(),
                     harness.benchmark(), cfg=cfg)
    assert harness.forbidden_modules() == []
