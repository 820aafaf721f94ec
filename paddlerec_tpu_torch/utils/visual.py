"""Scalar training telemetry: the VisualDL hook analog.

A copy of ``paddlerec_tpu/utils/visual.py`` (the same ``scalars.jsonl``
records).  As in the reference's tools/trainer.py, when
``runner.use_visual`` is set, per-step scalars (loss, auc, ips) are
logged for a dashboard.  Here scalars append to a JSONL file (and, when
TensorBoard is importable, also to a tfevents dir) so any plotting stack
can consume them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.jsonl")
        self._f = open(self._path, "a")
        self._tb = None
        try:  # pragma: no cover - optional dep
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}
        ) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def flush(self) -> None:
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
