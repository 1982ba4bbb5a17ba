"""Observability of the RefineNet trainer (counterpart of
``seg2eye_tpu/refinenet/loggers.py``).

  * ``Tensorboard`` keeps a current step (refinenet/core/tensorboard.py:
    8-48) and writes through tensorboardX when it is installed; without it,
    or with ``output_dir=None``, every call does nothing.
  * ``GoogleSheetLogger`` records the identifier, the full config and a
    row per test; with no sheet credentials (refinenet/core/
    gsheet_logger.py:50-63) the rows go to ``gsheet_rows.jsonl`` in the run
    directory.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class Tensorboard:
    def __init__(self, output_dir: Optional[str]):
        self.writer = None
        if output_dir is not None:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(output_dir)
            except Exception:
                self.writer = None
        self.step = 0

    def update_current_step(self, step: int):
        self.step = step

    def add_scalar(self, tag: str, value):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(np.asarray(value)), self.step)

    def add_image(self, tag: str, img):
        if self.writer is not None:
            self.writer.add_image(tag, np.asarray(img), self.step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class GoogleSheetLogger:
    """Experiment rows, appended to ``output_dir/gsheet_rows.jsonl``."""

    def __init__(self, identifier: str, config_json: str, output_dir: str):
        self.identifier = identifier
        self.path = os.path.join(output_dir, "gsheet_rows.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self.update_or_append_row({"Identifier": identifier,
                                   "Config": config_json,
                                   "Start": time.strftime("%c")})

    def update_or_append_row(self, row: Dict) -> None:
        row = {k: (float(np.asarray(v)) if isinstance(
            v, (np.ndarray, np.floating, np.integer)) else v)
            for k, v in row.items()}
        row.setdefault("Identifier", self.identifier)
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:
            pass                                 # as the reference: silent
