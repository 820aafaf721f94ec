"""Inference benchmark reporter (``paddlerec_tpu/utils/benchmark.py``).

A structured report of environment, model info, data info and performance
(latency percentiles, QPS), logged in the section layout of the
reference's ``PaddleInferBenchmark``.  The environment names the device the
calls ran on: the card's name from ``torch.cuda.get_device_name``, or the
CPU.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import torch

from paddlerec_tpu_torch.core.device import resolve_device
from paddlerec_tpu_torch.parallel.mesh import world_size


class InferBenchmark:
    def __init__(self, config: Optional[Dict] = None,
                 model_info: Optional[Dict] = None,
                 data_info: Optional[Dict] = None,
                 perf_info: Optional[Dict] = None, device=None):
        self.config = config or {}
        self.model_info = model_info or {}
        self.data_info = data_info or {}
        self.device = resolve_device(device)
        perf_info = perf_info or {}
        self.latencies: List[float] = list(perf_info.get("latencies", []))
        self.logger = logging.getLogger("paddlerec_tpu_torch.benchmark")
        if not self.logger.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(h)
            self.logger.setLevel(logging.INFO)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- measurement ------------------------------------------------------------
    def time_fn(self, fn, batches, warmup: int = 3):
        """Run fn over batches, recording each call's wall latency (s), the
        card synchronized before each time is read.  ``batches`` is
        materialized once so that a generator is not partly consumed; the
        warm-up replays the first batches untimed."""
        batches = list(batches)
        for b in batches[:warmup]:
            fn(b)
        self._sync()
        for b in batches:
            t0 = time.perf_counter()
            fn(b)
            self._sync()
            self.latencies.append(time.perf_counter() - t0)
        return self

    def stats(self) -> Dict[str, float]:
        if not self.latencies:
            return {}
        xs = sorted(self.latencies)
        n = len(xs)

        def pct(p):
            return xs[min(int(n * p), n - 1)] * 1000.0

        return {
            "count": n,
            "avg_ms": sum(xs) / n * 1000.0,
            "p50_ms": pct(0.50),
            "p90_ms": pct(0.90),
            "p99_ms": pct(0.99),
            "max_ms": xs[-1] * 1000.0,
            "qps": n / max(sum(xs), 1e-9),
        }

    # -- report (benchmark_utils.py:129-275 layout) -----------------------------
    def report(self, identifier: Optional[str] = None) -> Dict:
        identifier = f"[{identifier}]" if identifier else ""
        env = {
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "process_count": world_size(),
            "pid": os.getpid(),
        }
        s = self.stats()
        log = self.logger.info
        log(f"{identifier} ---------------------- Env info ----------------------")
        for k, v in env.items():
            log(f"{identifier} {k}: {v}")
        log(f"{identifier} ---------------------- Model info ----------------------")
        for k, v in self.model_info.items():
            log(f"{identifier} {k}: {v}")
        log(f"{identifier} ---------------------- Data info ----------------------")
        for k, v in self.data_info.items():
            log(f"{identifier} {k}: {v}")
        log(f"{identifier} ---------------------- Perf info ----------------------")
        for k, v in s.items():
            log(f"{identifier} {k}: {v:.4f}" if isinstance(v, float)
                else f"{identifier} {k}: {v}")
        return {"env": env, "model": self.model_info,
                "data": self.data_info, "perf": s}

    def __call__(self, identifier=None):
        return self.report(identifier)
