"""Run loggers: a text file, a JSONL scalar stream and the console.

The port's own copy of ``difffacto_tpu/utils/loggers.py``: ``RunLogger`` is
the HOOKS-registered composite the runner builds from ``cfg.logger``;
``TextLogger`` writes ``log.txt`` and ``ScalarLogger`` one JSON record a call
to ``scalars.jsonl`` (registered also as ``TensorboardLogger``, the name the
reference configs use).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from .registry import HOOKS


def current_time() -> str:
    return time.asctime(time.localtime(time.time()))


class TextLogger:
    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "log.txt")

    def log(self, data: Dict, step: Optional[int] = None):
        with open(self.path, "a") as f:
            parts = [f"{k}={v}" for k, v in data.items()]
            f.write(f"[{current_time()}] step={step} " + " ".join(parts) + "\n")

    def print_log(self, msg: str):
        with open(self.path, "a") as f:
            f.write(f"[{current_time()}] {msg}\n")


class ScalarLogger:
    """JSONL scalar stream, one record per log call."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "scalars.jsonl")

    def log(self, data: Dict, step: Optional[int] = None):
        rec = {"step": step, "time": time.time()}
        for k, v in data.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@HOOKS.register_module()
class RunLogger:
    """Text + scalar + console logger."""

    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        self.text = TextLogger(work_dir)
        self.scalars = ScalarLogger(work_dir)
        self._t0 = time.time()

    def log(self, data: Dict, step: Optional[int] = None, total_steps: Optional[int] = None):
        self.text.log(data, step)
        self.scalars.log(data, step)
        eta = ""
        if total_steps and step:
            per = (time.time() - self._t0) / max(step, 1)
            eta = f" eta={per * (total_steps - step) / 3600:.2f}h"
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in data.items()
        )
        print(f"[{current_time()}] [{step}/{total_steps}]{eta} {parts}", flush=True)

    def print_log(self, msg: str):
        self.text.print_log(msg)
        print(f"[{current_time()}] {msg}", flush=True)


HOOKS.register_module(name="TextLogger", module=TextLogger)
HOOKS.register_module(name="TensorboardLogger", module=ScalarLogger)
