"""Round-over-round summary of the port's ``benchmark_train`` records
(``paddlerec_tpu/tools/tipc_benchmark_summary.py``).

Collects every ``benchmark_train_<model>.json`` in a directory into ONE
summary record with the per-model ips matrix and the regression list; exits
non-zero when any model regressed >20% against its previous record, OR when
the directory holds no records at all (a gate that inspected no data must
not read as green).  Point it at ``test_tipc/output`` to aggregate a run's
artifacts (``run_benchmark`` always writes those, even on failure), or at
``test_tipc/benchmark_records_torch`` to summarize the port's committed
baselines.

usage: python -m paddlerec_tpu_torch.tools.tipc_benchmark_summary [dir]
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time


def summarize(output_dir: str = "test_tipc/output") -> dict:
    records = {}
    regressions = []
    for path in sorted(glob.glob(
        os.path.join(output_dir, "benchmark_train_*.json")
    )):
        with open(path) as f:
            rec = json.load(f)
        model = rec.get("model", os.path.basename(path))
        # CPU records (benchmark_train_<m>.cpu.json) live beside the card's:
        # key them separately, never collapse
        if path.endswith(".cpu.json"):
            model = f"{model}.cpu"
        records[model] = {
            "cells": rec.get("results", []),
            "skipped": rec.get("skipped", []),
            "backend": rec.get("backend"),
        }
        for r in rec.get("regressions", []):
            regressions.append(dict(r, model=model))
    summary = {
        "models": len(records),
        "cells": sum(len(r["cells"]) for r in records.values()),
        "skipped_cells": sum(
            len(r["skipped"]) for r in records.values()
        ),
        "regressions": regressions,
        "records": records,
        "ts": time.time(),
    }
    out = os.path.join(output_dir, "benchmark_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(
        f"benchmark summary: {summary['models']} models, "
        f"{summary['cells']} cells, "
        f"{len(regressions)} regression(s) -> {out}"
    )
    for r in regressions:
        print(
            f"  REGRESSION {r['model']} batch {r['batch']} x "
            f"{r['devices']}dev: {r['prev_ips']} -> {r['ips']} ips "
            f"(-{r['drop_pct']}%)"
        )
    return summary


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    output_dir = args[0] if args else "test_tipc/output"
    summary = summarize(output_dir)
    if not summary["models"]:
        print(f"benchmark summary: NO records under {output_dir} — "
              "nothing was gated")
        return 1
    return 1 if summary["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
