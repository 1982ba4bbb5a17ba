"""Source snapshot (counterpart of ``seg2eye_tpu/utils/files.py``): every
``.py`` file of the checkout into ``checkpoints/<name>/src.zip`` when
training starts (reference util/files.py:54-73)."""
from __future__ import annotations

import os
import zipfile

# directories never snapshotted: VCS, caches, checkpoints and build output
SKIP_DIRS = (".git", "__pycache__", "checkpoints", ".jax_cache",
             ".pytest_cache", "build")


def project_root() -> str:
    """The checkout that holds the ``seg2eye_tpu_torch`` package, whatever
    the CLI's working directory."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def copy_src(path_from: str, path_to: str) -> str:
    """Zip every ``.py`` file under ``path_from`` (paths relative to it)
    into ``path_to/src.zip``; -> the zip's path."""
    os.makedirs(path_to, exist_ok=True)
    out = os.path.join(path_to, "src.zip")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path_from):
            dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
            for fn in sorted(files):
                if fn.endswith(".py"):
                    full = os.path.join(root, fn)
                    z.write(full, os.path.relpath(full, path_from))
    return out
