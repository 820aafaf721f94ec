"""Small sizes of every cell, for runs of the whole harness on the CPU."""

import time

import torch

from recbench import harness

SMALL = {
    "dlrm_mlperf.train": {"hyper.sparse_feature_number": 5000, "traffic.batch_size": 64,
                          "traffic.batches": 8},
    "deepfm_1e8.train": {"hyper.sparse_feature_number": 20001, "traffic.batch_size": 64,
                         "traffic.batches": 8},
    "dlrm_mlperf.score": {"hyper.sparse_feature_number": 5000, "traffic.batch_size": 64,
                          "traffic.pool_batches": 4, "traffic.warmup_batches": 1,
                          "traffic.trace_batches": 2},
}


def run_small(workload, seed=7, trace=False, device="cpu"):
    bench = harness.Benchmark()
    cell = bench.cell(workload, seed, 0.2, trace, torch.device(device), time.perf_counter(),
                      overrides=SMALL[workload])
    return harness.run_cell(bench, cell)
