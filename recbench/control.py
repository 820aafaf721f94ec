#!/usr/bin/env python3
"""Readings that set the limits of ``correct``, on the card at a cell's own
size (the benchmark's own runs never run this).

    python3 recbench/control.py --workload <cell> --seeds 11 12 13 \
        [--program 21 22 ...] [--fault nearest|truncate --faulted 31 32 33]

For each ``--seeds`` seed: the control, the plain reference in TF32 put in
the program's place (the nearest precision below the float32 the
configurations state), against the float32 reference; for a training cell
also the fault "half of each batch left out, the mean over the rest",
planted in the reference put in the program's place (a step that leaves
its state unchanged reads 1 on ``change_gap`` by definition).  A training
cell's steps here are the whole corpus in order from the weights, then
``checked_steps`` batches of a seeded permutation from the float32
reference's state after them, as set-up's staging and replayed epochs.
For each ``--program`` seed: a whole run of the cell (``--seconds``), the
program's own numbers, in this one process; for each ``--faulted`` seed
the same with the fault ``--fault`` planted in the program's bfloat16
stochastic rounding (``nearest``: round to nearest; ``truncate``: toward
zero).  One JSON line each.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _steps(cell):
    """The cell's inputs and the steps the reference follows: a training
    cell's corpus and (order, checked); a score cell's sampled batches."""
    import numpy as np

    from recbench import traffic as gen

    tr, cfg = cell.traffic, cell.config
    batch = int(tr["batch_size"])
    if tr["driver"] == "train":
        n, stream = int(tr["batches"]), "corpus"
    else:
        n, stream = int(tr["pool_batches"]), "pool"
    data = gen.generate(cell.seed, stream, batch * n, cfg, tr, cell.device)
    host = {k: v.cpu().numpy() for k, v in data.items()}
    batches = [{k: v[i * batch:(i + 1) * batch].copy() for k, v in host.items()}
               for i in range(n)]
    if tr["driver"] != "train":
        return batches[:min(int(tr["sample_max"]), n)], None
    checked = int(tr["checked_steps"])
    replay = np.random.default_rng(gen.stream_seed(cell.seed, "replay")).permutation(n)
    return batches, (list(range(n)) + [int(i) for i in replay[:checked]], checked)


def _on_host(change):
    rows, d = change
    return rows.cpu(), d.double().cpu()


def control_readings(cell):
    from recbench import harness, reference

    model = harness.model_module(cell.config)
    batches, steps = _steps(cell)
    if steps is not None:
        order, checked = steps
        n = len(order) - checked
        staging = [batches[i] for i in order[:n]]
        replay = [batches[i] for i in order[n:]]
        cfg, seed, dev = cell.config, cell.seed, cell.device
        ref = reference.train_readings(model, cfg, seed, staging, checked, dev, end_state=True)
        start = ref.pop("state")
        ref_replay = reference.train_readings(model, cfg, seed, replay, checked, dev, start=start)
        out = {}
        for label, kw in (("control_tf32", {"tf32": True}), ("fault_half_batch", {"half": True})):
            got = reference.train_readings(model, cfg, seed, staging, checked, dev, **kw)
            got_replay = reference.train_readings(model, cfg, seed, replay, checked, dev,
                                                  start=start, **kw)
            sr = {"table_projection": reference.recipe(cfg["hyper_parameters"])["stochastic"]}
            got["table_change"] = _on_host(got["table_change"])
            got_replay["table_change"] = _on_host(got_replay["table_change"])
            out[label] = {**reference.compare_train(got, ref, **sr),
                          **reference.compare_train(got_replay, ref_replay, "replay_",
                                                    table_grad=False, **sr)}
        out["fault_unchanged"] = {"change_gap": 1.0, "replay_change_gap": 1.0}
        return out
    ref = reference.predictions(model, cell.config, cell.seed, batches, cell.device)
    got = reference.predictions(model, cell.config, cell.seed, batches, cell.device, tf32=True)
    return {"control_tf32": reference.compare_scores(got, ref)}


def biased_rounding(fault: str):
    """A float32 → bfloat16 rounding with the signature of the program's
    stochastic one that ignores its noise: ``nearest`` or ``truncate``
    (toward zero)."""
    import torch

    def nearest(x, noise):
        return x.to(torch.float32).to(torch.bfloat16)

    def truncate(x, noise):
        bits = x.to(torch.float32).contiguous().view(torch.int32) & -65536
        return bits.view(torch.float32).to(torch.bfloat16)

    return {"nearest": nearest, "truncate": truncate}[fault]


def plant(fault: str) -> None:
    """Replace the program's bfloat16 stochastic rounding by a biased one."""
    from paddlerec_tpu_torch.ops import sparse_update

    sparse_update.stochastic_round_bf16 = biased_rounding(fault)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--program", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--fault", choices=("nearest", "truncate"), default="nearest")
    parser.add_argument("--faulted", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from recbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.Benchmark(ROOT)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        cell = bench.cell(args.workload, seed, args.seconds, False, dev, time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control_readings(cell)}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.program:
        cell = bench.cell(args.workload, seed, args.seconds, False, dev, time.perf_counter())
        result = harness.run_cell(bench, cell)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": result}),
              flush=True)
        torch.cuda.empty_cache()
    if args.faulted:
        plant(args.fault)
    for seed in args.faulted:
        cell = bench.cell(args.workload, seed, args.seconds, False, dev, time.perf_counter())
        result = harness.run_cell(bench, cell)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          f"fault_{args.fault}": result}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
