"""TIPC: the train-infer certification harness of the port
(``paddlerec_tpu/tools/tipc.py``).

It reads the same per-model parameter files, ``test_tipc/configs/<model>/
train_infer_python.txt`` (``key:modeA=v1|modeB=v2``; read only), runs the
train → export → infer chain of a mode through the port's ``RankModel`` and
records "Run successfully / Run failed" per step in
``<output_dir>/results_python_<mode>.log``, line for line as the JAX tool.

``benchmark_train`` is the perf-CI matrix: ips per batch size × device
count, diffed against the last record of the same backend, a drop of more
than 20% failing the run.  A device count above the world size (one card:
every count above 1) is skipped and recorded with its reason.  The backend
of a record is the device: the card's name (``cuda:<name>``), or ``cpu``,
whose records are tagged ``.cpu``.  The port's records live in
``test_tipc/benchmark_records_torch/`` (``--record_dir``), never beside the
JAX package's in ``test_tipc/benchmark_records/``.

``write_criteo_fixture(root)`` writes the criteo rows the rank configs read
(``test_tipc/data/train``: 2 files of 256 rows, vocab 10,000), as the JAX
package's ``test_tipc/prepare.py criteo`` does.

Usage:
    python -m paddlerec_tpu_torch.tools.tipc \
        test_tipc/configs/dnn/train_infer_python.txt lite_train_lite_infer \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

MODES = (
    "lite_train_lite_infer",
    "lite_train_whole_infer",
    "whole_train_whole_infer",
    "whole_infer",
    "benchmark_train",
)
REGRESSION_TOLERANCE = 0.20  # CI fails on >20% ips drop vs last record
RECORD_DIR = "test_tipc/benchmark_records_torch"  # tracked: the port's baselines
WARMUP = 3


def write_criteo_fixture(root: str = "test_tipc/data") -> str:
    """The criteo rows of the rank configs under ``<root>/train``."""
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample

    out = os.path.join(root, "train")
    write_criteo_sample(out, num_lines=256, num_files=2, vocab=10000)
    return out


def parse_config_txt(path: str, mode: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "=")) or line == "##":
                continue
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if not key or value in ("null", ""):
                continue
            if "=" in value and "|" in value or "=" in value and any(
                value.startswith(m + "=") for m in MODES
            ):
                chosen = None
                for part in value.split("|"):
                    m, _, v = part.partition("=")
                    if m == mode:
                        chosen = v
                if chosen is None:
                    continue
                value = chosen
            out[key] = value
    return out


def run_mode(config_txt: str, mode: str, output_dir: str = "test_tipc/output",
             device=None) -> bool:
    from paddlerec_tpu_torch.core.config import coerce_value
    from paddlerec_tpu_torch.uapi import RankModel

    spec = parse_config_txt(config_txt, mode)
    model_name = spec.pop("model_name", "model")
    overrides = {k: coerce_value(v) for k, v in spec.items() if "." in k}
    run_model = overrides.get("runner.model", f"rank.{model_name}")

    os.makedirs(output_dir, exist_ok=True)
    log_path = os.path.join(output_dir, f"results_python_{mode}.log")
    statuses = []

    def status(step: str, ok: bool, detail: str = ""):
        line = (f"Run successfully with command - {step}!" if ok
                else f"Run failed with command - {step}! {detail}")
        statuses.append((step, ok))
        with open(log_path, "a") as f:
            f.write(line + "\n")
        print(line)

    model = RankModel(run_model, config=overrides, device=device)
    save_dir = os.path.join(output_dir, f"{model_name}_{mode}_model")
    export_dir = os.path.join(output_dir, f"{model_name}_{mode}_export")
    infer_dir = os.path.join(output_dir, f"{model_name}_{mode}_infer")

    t0 = time.time()
    # train (skipped in whole_infer mode, matching the reference matrix)
    last_ckpt = None
    if mode != "whole_infer":
        try:
            metrics = model.train(save_dir=save_dir,
                                  config_overrides={"runner.use_auc": True})
            epochs = int(overrides.get("runner.epochs", 1))
            last_ckpt = os.path.join(save_dir, str(epochs - 1))
            status(f"train {model_name}", True)
            print(f"train metrics: {metrics}")
        except Exception as e:  # noqa: BLE001 - the harness records any failure
            status(f"train {model_name}", False, repr(e))
            traceback.print_exc()
    try:
        model.export(last_ckpt, export_dir)
        status(f"export {model_name}", True)
    except Exception as e:  # noqa: BLE001
        status(f"export {model_name}", False, repr(e))
        traceback.print_exc()
    # infer from the exported artifact
    try:
        data = overrides.get("runner.test_data_dir",
                             overrides.get("runner.train_data_dir"))
        out = model.infer(export_dir, data, infer_dir,
                          batch_size=int(overrides.get("runner.infer_batch_size", 16)))
        with open(out) as f:
            n = sum(1 for _ in f)
        status(f"infer {model_name}", n > 0, f"{n} predictions")
    except Exception as e:  # noqa: BLE001
        status(f"infer {model_name}", False, repr(e))
        traceback.print_exc()

    elapsed = time.time() - t0
    ok = all(s for _, s in statuses)
    print(f"TIPC {model_name} [{mode}] {'PASSED' if ok else 'FAILED'} "
          f"in {elapsed:.1f}s — log: {log_path}")
    return ok


def backend_of(device) -> str:
    """A record's backend: ``cpu`` or ``cuda:<the card's name>``."""
    import torch

    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _staged_batches(trainer, cfg, bs: int, steps: int) -> list:
    """The cell's device batches, staged once: up to ``steps`` from the data,
    else one example batch of the model (a deep cell exceeds the lite
    fixture's rows; step throughput is shape-driven)."""
    dataset = trainer.make_dataset(cfg.runner("train_data_dir"), bs)
    staged = []
    for batch in trainer._device_batches(dataset):
        staged.append(batch)
        if len(staged) >= steps:
            break
    if not staged:
        try:
            example = trainer.model_def.example_batch(bs)
        except NotImplementedError:
            return staged
        staged = list(trainer._device_batches(iter([example])))
    return staged


def run_benchmark(config_txt: str, output_dir: str = "test_tipc/output",
                  record_dir: str = RECORD_DIR,
                  matrix_override: Dict[str, str] | None = None,
                  rebaseline: bool = False, device=None) -> bool:
    """benchmark_train mode: the reference's perf-CI matrix (batch ×
    device_num, ips per cell, diffed round over round; a >20% drop against
    the last record of the same backend FAILS the run).

    Protocol: the cell's device batches are staged once, 3 warm-up steps
    run, then >= 50 steps are timed over the recycled batches, the loss read
    back (a synchronization) after each span.

    Config txt keys (pipe-separated sweeps):
        benchmark.batch_sizes:512|2048
        benchmark.device_nums:1|4        # ranks; above the world: skipped
        benchmark.steps:64               # measured steps per cell
    """
    from paddlerec_tpu_torch.core.config import Config, coerce_value
    from paddlerec_tpu_torch.core.device import resolve_device
    from paddlerec_tpu_torch.parallel.mesh import world_size
    from paddlerec_tpu_torch.train.trainer import Trainer

    device = resolve_device(device)
    backend = backend_of(device)
    on_cpu = device.type == "cpu"
    matrix_override = matrix_override or {}
    spec = parse_config_txt(config_txt, "benchmark_train")
    model_name = spec.pop("model_name", "model")
    overrides = {k: coerce_value(v) for k, v in spec.items() if "." in k}
    batch_sizes = [int(x) for x in str(
        matrix_override.get("batch_sizes")
        or spec.get("benchmark.batch_sizes", "64|256")).split("|")]
    device_nums = [int(x) for x in str(
        matrix_override.get("device_nums")
        or spec.get("benchmark.device_nums", "1|4")).split("|")]
    steps = max(int(spec.get("benchmark.steps", 64)), 50)
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(record_dir, exist_ok=True)
    # one tracked baseline PER BACKEND: a CPU record says nothing about the
    # card's ips and must never clobber its baseline
    backend_tag = ".cpu" if on_cpu else ""
    record_path = os.path.join(record_dir,
                               f"benchmark_train_{model_name}{backend_tag}.json")
    previous = None
    prev_backend = None
    if os.path.exists(record_path):
        try:
            with open(record_path) as f:
                prev_rec = json.load(f)
            prev_backend = prev_rec.get("backend")
            previous = {(r["batch"], r["devices"]): r["ips"]
                        for r in prev_rec["results"]}
        except Exception:  # noqa: BLE001 - an unreadable record is no baseline
            previous = None

    results = []
    regressions = []
    skipped = []
    avail = world_size()
    # containers misreport cores (cgroup limits vs os.cpu_count);
    # TIPC_ASSUME_CORES pins the value the gate-stability logic uses
    host_cores = (int(os.environ.get("TIPC_ASSUME_CORES", 0)) or os.cpu_count() or 1)
    for devices in device_nums:
        if devices > avail:
            print(f"skip device_num {devices} (only {avail} available)")
            skipped.append({"devices": devices, "reason": f"only {avail} devices"})
            continue
        for bs in batch_sizes:
            try:
                cfg = Config(dict(overrides, **{
                    "runner.train_batch_size": bs,
                    "runner.epochs": 1,
                    "runner.print_interval": 10_000_000,
                    "runner.model_save_path": None,
                }))
                trainer = Trainer(cfg, device=device)
                trainer.init_state()
                metric_state = trainer._init_metric_state()
                staged = _staged_batches(trainer, cfg, bs, steps)
                if not staged:
                    print(f"benchmark_train {model_name}: no data for "
                          f"batch {bs}; skipping cell")
                    continue
                loss = None
                for i in range(WARMUP):
                    metric_state, loss = trainer.train_step(staged[i % len(staged)],
                                                            metric_state)
                float(loss)  # warm-up fence
                t0 = time.time()
                for i in range(steps):
                    metric_state, loss = trainer.train_step(staged[i % len(staged)],
                                                            metric_state)
                float(loss)  # the card's queue drained
                el = max(time.time() - t0, 1e-9)
                ips = steps * bs / el
                delta = ""
                regressed = False
                # a host too small to isolate the measurement gives no
                # gate-stable CPU numbers: recorded ungated (advisory)
                gate_stable = not (on_cpu and host_cores < 2)
                if (gate_stable and previous and prev_backend == backend
                        and (bs, devices) in previous):
                    prev = previous[(bs, devices)]
                    rel = (ips - prev) / prev
                    delta = f" ({rel * 100.0:+.1f}% vs last)"
                    if rel < -REGRESSION_TOLERANCE:
                        regressed = True
                        regressions.append(
                            {"batch": bs, "devices": devices,
                             "ips": round(ips, 1), "prev_ips": prev,
                             "drop_pct": round(-rel * 100.0, 1)})
                print(f"benchmark_train {model_name}: batch {bs} x {devices} "
                      f"device(s) on {backend} -> {ips:.1f} ips over {steps} "
                      f"steps{delta}" + (" REGRESSION" if regressed else ""))
                results.append({"batch": bs, "devices": devices,
                                "ips": round(ips, 1), "steps": steps})
            except Exception as e:  # noqa: BLE001
                # a cell failure (OOM, unsupported shape) must not abort the
                # matrix: record it visibly and move on
                traceback.print_exc()
                skipped.append({"batch": bs, "devices": devices,
                                "reason": f"{type(e).__name__}: {e}"})
    record = {"model": model_name, "results": results,
              "regressions": regressions, "skipped": skipped,
              "warmup": WARMUP, "backend": backend, "ts": time.time()}
    # the run artifact always lands in output_dir for the summary tool; the
    # TRACKED baseline is updated only on a clean run (overwriting it with
    # regressed results would ratchet the gate down so it fires once)
    run_path = os.path.join(output_dir,
                            f"benchmark_train_{model_name}{backend_tag}.json")
    if regressions and rebaseline:
        # explicit operator action: accept this run as the new baseline, and
        # keep the list of the cells re-baselined downward
        record["rebaselined"] = regressions
        record["regressions"] = []
        print(f"benchmark_train {model_name}: REBASELINED "
              f"{len(regressions)} regressed cell(s) by operator request")
        regressions = []
    keep_baseline = not results and bool(previous)
    if not ((regressions or keep_baseline)
            and os.path.abspath(run_path) == os.path.abspath(record_path)):
        with open(run_path, "w") as f:
            json.dump(record, f)
    if regressions:
        print(f"benchmark record: {run_path} (baseline kept: {record_path})")
        print(f"benchmark_train {model_name} FAILED: {len(regressions)} "
              f"cell(s) regressed >{REGRESSION_TOLERANCE:.0%}")
        return False
    if keep_baseline:
        # an all-cells-failed run must never clobber a measured baseline
        print(f"benchmark_train {model_name}: no cells measured — keeping "
              f"existing baseline {record_path}")
        return False
    if os.path.abspath(record_path) != os.path.abspath(run_path):
        with open(record_path, "w") as f:
            json.dump(record, f)
    print(f"benchmark record: {record_path}")
    return bool(results)


def main(argv=None):
    parser = argparse.ArgumentParser(description="TIPC certification")
    parser.add_argument("config_txt")
    parser.add_argument("mode", nargs="?", default="lite_train_lite_infer",
                        choices=MODES)
    parser.add_argument("--output_dir", default="test_tipc/output")
    parser.add_argument("--record_dir", default=RECORD_DIR,
                        help="tracked dir holding the port's committed "
                        "benchmark_train_<model>.json baselines")
    parser.add_argument("--batch_sizes", default=None,
                        help="override the config's benchmark.batch_sizes "
                        "(pipe-separated), e.g. 512|2048")
    parser.add_argument("--device_nums", default=None,
                        help="override the config's benchmark.device_nums "
                        "(pipe-separated), e.g. 1|2")
    parser.add_argument("--rebaseline", action="store_true",
                        help="accept a run with regressed cells as the new "
                        "tracked baseline; the record keeps the list of "
                        "re-baselined cells")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mode == "benchmark_train":
        return 0 if run_benchmark(
            args.config_txt, args.output_dir, args.record_dir,
            matrix_override={"batch_sizes": args.batch_sizes,
                             "device_nums": args.device_nums},
            rebaseline=args.rebaseline, device=args.device,
        ) else 1
    return 0 if run_mode(args.config_txt, args.mode, args.output_dir,
                         device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
