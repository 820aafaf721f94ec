"""On/off-line consistency diff: training dumps vs serving dumps.

A copy of ``paddlerec_tpu/utils/onoff_diff.py`` (the reference's
tools/onoff_diff/onoff_diff.py): compare
per-instance per-variable values dumped by training against values logged
by the serving side; report per-var max diff and per-instance diff, flag
instances above threshold.

Dump format here is JSONL (one dict per instance:
``{"ins_id": ..., "vars": {name: [floats]}}``) — the TPU trainer's
``dump_fields`` writer of either package emits it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple


def load_dump(path: str) -> Dict[str, Dict[str, List[float]]]:
    out: Dict[str, Dict[str, List[float]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out[str(rec["ins_id"])] = {
                k: [float(x) for x in v] for k, v in rec["vars"].items()
            }
    return out


def var_diff(
    online: Dict[str, Dict[str, List[float]]],
    offline: Dict[str, Dict[str, List[float]]],
    var_name: str,
) -> Tuple[float, str]:
    """Max |online − offline| for one variable over shared instances
    (onoff_var_diff, onoff_diff.py:98-130)."""
    max_diff, max_ins = 0.0, ""
    for ins, vars_on in online.items():
        if ins not in offline:
            continue
        a = vars_on.get(var_name)
        b = offline[ins].get(var_name)
        if a is None or b is None or len(a) != len(b):
            continue
        d = max((abs(x - y) for x, y in zip(a, b)), default=0.0)
        if d > max_diff:
            max_diff, max_ins = d, ins
    return max_diff, max_ins


def ins_diff(
    online: Dict[str, Dict[str, List[float]]],
    offline: Dict[str, Dict[str, List[float]]],
    threshold: float = 1e-5,
) -> Dict[str, float]:
    """Per-instance max diff across all shared vars; returns the
    instances above threshold (onoff_ins_diff analog)."""
    bad = {}
    for ins, vars_on in online.items():
        if ins not in offline:
            continue
        worst = 0.0
        for name, a in vars_on.items():
            b = offline[ins].get(name)
            if b is None or len(a) != len(b):
                continue
            worst = max(
                worst, max((abs(x - y) for x, y in zip(a, b)), default=0.0)
            )
        if worst > threshold:
            bad[ins] = worst
    return bad


def diff_report(online_path: str, offline_path: str,
                threshold: float = 1e-5) -> Dict:
    online = load_dump(online_path)
    offline = load_dump(offline_path)
    all_vars = sorted(
        {v for ins in online.values() for v in ins}
        & {v for ins in offline.values() for v in ins}
    )
    per_var = {}
    for v in all_vars:
        d, ins = var_diff(online, offline, v)
        per_var[v] = {"max_diff": d, "worst_ins": ins}
    bad = ins_diff(online, offline, threshold)
    return {
        "num_online": len(online),
        "num_offline": len(offline),
        "num_shared": len(set(online) & set(offline)),
        "per_var": per_var,
        "bad_instances": bad,
        "consistent": not bad,
    }


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: python -m paddlerec_tpu_torch.utils.onoff_diff "
              "<online.jsonl> <offline.jsonl> [threshold]")
        return 2
    threshold = float(argv[2]) if len(argv) > 2 else 1e-5
    rep = diff_report(argv[0], argv[1], threshold)
    print(json.dumps(rep, indent=2))
    return 0 if rep["consistent"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
