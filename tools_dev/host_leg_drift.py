"""How far two runs of ``chip_smoke.py``'s host-table leg (phase 37) drift
apart on the card.

Trains ``configs/rank/dnn/config_bigdata.yaml`` through the port's
``HostTableTrainer`` four times over phase 37's data: a RAM-only leg, a spill
leg, the RAM-only leg again, and the RAM-only leg with its float32 dense
parameters scaled by (1 + 2^-23) after init (about one ulp).  For each pair it
prints one JSON line: whether the rows' ids are equal, the values' largest
difference, how many elements differ and how many lie beyond rtol 2^-6 /
atol 1e-5, and the accumulators' largest relative difference, with the rows
beyond rtol 1e-3.

Run it on a machine with a CUDA card from the repository's root:
``python3 tools_dev/host_leg_drift.py`` (about 90 s on an H100; its data goes to a
temporary directory, removed at the end)."""
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from paddlerec_tpu_torch.train.host_loop import HostTableTrainer  # noqa: E402


def leg(cfg, seed, perturb):
    ht = HostTableTrainer(cfg)
    ht.trainer.init_state(seed=seed)
    if perturb:
        with torch.no_grad():
            for p in ht.trainer.state.module.parameters():
                if p.dtype == torch.float32:
                    p.mul_(1 + 2 ** -23)
    ht.train()
    return ht


def compare(a, b):
    ia, va = a.table.snapshot_rows()
    ib, vb = b.table.snapshot_rows()
    d = np.abs(va - vb)
    tolv = 1e-5 + 2 ** -6 * np.abs(va)
    rel = np.abs(a.host_acc - b.host_acc) / np.maximum(np.abs(a.host_acc), 1e-30)
    bad = rel > 1e-3
    return {
        "ids_equal": bool(np.array_equal(ia, ib)),
        "max_abs_err": float(d.max()), "elements_differing": int((va != vb).sum()),
        "values_beyond_tol": int((d > tolv).sum()),
        "values_max_ratio_to_tol": float((d / tolv).max()),
        "acc_max_rel_err": float(rel.max()), "acc_rows_beyond_1e-3": int(bad.sum()),
        "acc_of_those_rows": [float(x) for x in np.sort(np.abs(a.host_acc[bad]))[:5]],
        "acc_median_touched": float(np.median(a.host_acc[a.host_acc > 0])),
        "acc_rows_differing": int((a.host_acc != b.host_acc).sum()),
    }


def main():
    seed = 0
    work = tempfile.mkdtemp()
    try:
        data = os.path.join(work, "host_table")
        cs.write_host_table_data(data, 100000001, seed + 37)
        ram = leg(cs.host_config(data, seed), seed, False)
        spill_cfg = cs.host_config(data, seed, **{
            "runner.host_table_ram_rows": cs.HOST_RAM_ROWS,
            "runner.host_table_spill_dir": os.path.join(work, "spill")})
        spill = leg(spill_cfg, seed, False)
        print(json.dumps({"ram_vs_spill": compare(ram, spill)}), flush=True)
        del spill
        ram2 = leg(cs.host_config(data, seed), seed, False)
        print(json.dumps({"ram_vs_ram": compare(ram, ram2)}), flush=True)
        del ram2
        pert = leg(cs.host_config(data, seed), seed, True)
        print(json.dumps({"ram_vs_ram_dense_1ulp": compare(ram, pert)}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
