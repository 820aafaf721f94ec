"""The harness: find a cell's files by name, run its driver, read its
metrics, decide ``correct`` and print the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files:

* ``configs/<config>.json``: the configuration (the port's config keys,
  ``slot_cardinalities``, ``source``, ``reduced``, ``assumed``);
* ``traffic/<traffic>.json``: the traffic mix, which names its driver;
* ``drivers/<driver>.py``: ``run(cell) -> Outcome``, one per traffic kind;
* ``models/<runner.model>.py``: the plain reference of the model and its
  operation counts;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: ``read(outcome) -> float | None``, one per
  per-layer metric of ``BENCHMARK.json``.

A metric's name may end in a scope (``train_mfu.dlrm``, ``device_idle.score``)
that gives a quantity its own cells and bound: the reader is the file of the
longest leading part of the name that has one (``metrics/train_mfu.py``),
and a driver reports an end-to-end metric under the longest leading part of
its name that it knows (``train_examples_per_s``).

Nothing here imports the port; the drivers import it inside ``run``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "paddlerec_tpu")


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file_module(path: str):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    name = "recbench_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def by_scope(name: str, found) -> Any:
    """``found(part)`` for the longest leading part of the dotted ``name``
    (``a.b.c``, then ``a.b``, then ``a``) for which it is not None."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        hit = found(".".join(parts[:n]))
        if hit is not None:
            return hit
    raise KeyError(f"nothing serves the metric {name!r}")


def metric_reader(name: str):
    def found(part):
        path = os.path.join(HERE, "metrics", part + ".py")
        return load_file_module(path) if os.path.exists(path) else None
    return by_scope(name, found)


def model_module(config: Dict[str, Any]):
    return load_file_module(os.path.join(HERE, "models", config["runner"]["model"] + ".py"))


@dataclasses.dataclass
class Cell:
    """What a driver gets: the cell's files, the run's arguments, the device."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    t_start: float


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    end_to_end: Dict[str, float]
    counts: Dict[str, Any]
    compared: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None


class Benchmark:
    def __init__(self, root: str = ROOT):
        self.spec = load_json(root, "BENCHMARK.json")
        self.workloads = {w["name"]: w for w in self.spec["workloads"]}

    def metrics_for(self, section: str, workload: str) -> List[Dict[str, Any]]:
        """The metrics of ``section`` that ``workload`` reports."""
        out = []
        for m in self.spec[section]:
            cells = m.get("workloads")
            if cells is None or workload in cells:
                out.append(m)
        return out

    def cell(self, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[Dict[str, Any]] = None) -> Cell:
        w = self.workloads[workload]
        config = load_json(HERE, "configs", w["config"] + ".json")
        traffic = load_json(HERE, "traffic", w["traffic"] + ".json")
        for key, value in (overrides or {}).items():
            section, _, name = key.partition(".")
            target = {"config": config, "hyper": config["hyper_parameters"],
                      "traffic": traffic}[section]
            target[name] = value
        return Cell(workload, int(seed), float(seconds), bool(trace), device, config,
                    traffic, load_json(HERE, "limits", workload + ".json"), t_start)


def run_cell(bench: Benchmark, cell: Cell) -> Dict[str, Any]:
    """Run the cell's driver and build the result line's object."""
    import torch

    driver = load_file_module(os.path.join(HERE, "drivers", cell.traffic["driver"] + ".py"))
    out: Outcome = driver.run(cell)
    if cell.trace:
        metrics = {}
        for m in bench.metrics_for("per_layer", cell.name):
            value = metric_reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": by_scope(m["name"], out.end_to_end.get),
                               "unit": m["unit"]}
                   for m in bench.metrics_for("end_to_end", cell.name)}
    correct = out.failed == 0 and all(
        math.isfinite(v) and v <= cell.limits[k] for k, v in out.compared.items())
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    power = power_limit_w() if cell.device.type == "cuda" else None
    if power is not None:
        device["power_limit_w"] = power
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = out.trace["breakdown"]
    result["compared"] = {k: {"value": v, "limit": cell.limits[k]}
                          for k, v in out.compared.items()}
    return result


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None."""
    import subprocess

    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(text.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def print_result(result: Dict[str, Any]) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
