"""Scalar metric writer (counterpart of ``dpfx/utils/writers.py``):
``metrics.jsonl``, one JSON record per log event. TensorBoard event files
(``train.tensorboard: true``) are not ported yet."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class ScalarWriter:
    def __init__(self, directory: str, tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError("train.tensorboard: TensorBoard writing is not ported "
                                      "yet (ROADMAP Queue 1 #5); metrics.jsonl is written")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.jsonl_path = os.path.join(self.directory, "metrics.jsonl")

    def write(self, record: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
