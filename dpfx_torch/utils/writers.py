"""Scalar metric writer (counterpart of ``dpfx/utils/writers.py``):
``metrics.jsonl``, one JSON record per log event, always; with
``train.tensorboard: true`` also TensorBoard event files under
``<run>/tb`` through ``torch.utils.tensorboard.SummaryWriter``, each
numeric scalar tagged ``{kind}/{key}`` at ``step``. The SummaryWriter is
imported only then: it needs the ``tensorboard`` package."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class ScalarWriter:
    def __init__(self, directory: str, tensorboard: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.jsonl_path = os.path.join(self.directory, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError("train.tensorboard: true needs the tensorboard package "
                                  "(train.tensorboard: false writes metrics.jsonl alone)") from e
            self.tb_dir = os.path.join(self.directory, "tb")
            self._tb = SummaryWriter(self.tb_dir)

    def write(self, record: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is None:
            return
        step, kind = int(record.get("step", 0)), record.get("kind", "train")
        for k, v in record.items():
            if k not in ("step", "kind") and isinstance(v, (int, float)):
                self._tb.add_scalar(f"{kind}/{k}", float(v), step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
