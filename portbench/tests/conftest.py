"""CPU tests of the port's benchmark: ``python -m pytest portbench/tests``
from the root of the repository.  They import the port and the harness,
never JAX; torch keeps two threads per process."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def tiny_cell(name, dtype="float32"):
    """(cell, cfg) of a cell at CPU-test sizes: the same files, widths cut."""
    from portbench import harness

    cell = harness.find_cell(name, harness.benchmark())
    cfg = harness.find_config(cell["config"])
    sizes = cell["sizes"]
    if cfg.get("ngf"):
        cfg.update(ngf=4, ndf=4, crop_size=64, aspect_ratio=1.0, w_dim=8,
                   input_ns=2)
        sizes.update(batch=4, height=64, width=64, k=2)
        if "native_height" in sizes:
            sizes.update(native_height=64, native_width=40)
    else:
        cfg.update(input_height=64, input_width=40)
        sizes.update(batch=4, height=64, width=40)
        if "calibrate" in cell:
            cell["calibrate"] = 4
    cell.update(ring=3, dtype=dtype)
    return cell, cfg


@pytest.fixture
def tiny():
    return tiny_cell
