"""Scoring cells: a closed loop of batch scoring, the call ``tools/predict.py``
and ``serving/webserver.py`` make on each batch.

A pool of ``pool_batches`` seeded host batches (pageable numpy arrays, as a
reader hands them over) is drawn once; the module is the port's model with
the benchmark's weights written in, on the card.  Each iteration takes the
next pool batch: ``to_tensors`` (the copy to the card), ``infer_forward``
under ``infer_context(torch.inference_mode)``, and the predictions back on
the host.  ``score_batch_p95_ms`` is the 95th percentile of those
iterations' host-clock times over the whole window, ``score_examples_per_s``
every row scored over the window.  A seeded sample of the window's
iterations keeps its predictions, which the plain reference scores again
once the window has closed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from recbench import harness, kernels, reference, trace, weights
from recbench import traffic as gen
from recbench.peaks import F32_FLOPS


def run(cell: harness.Cell) -> harness.Outcome:
    from paddlerec_tpu_torch.core.config import Config, flatten_config
    from paddlerec_tpu_torch.core.device import full_float32_matmul, to_tensors
    from paddlerec_tpu_torch.core.registry import load_model_def

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    hp = cfg["hyper_parameters"]
    model = harness.model_module(cfg)
    batch, pool_n = int(tr["batch_size"]), int(tr["pool_batches"])
    vocab = int(hp["sparse_feature_number"])
    _, _, table_dtype, _ = reference.table_leaf(model, hp)
    _, width, pack = reference.layout(vocab, model.logical_dim(hp))

    data = gen.generate(cell.seed, "pool", batch * pool_n, cfg, tr, dev)
    bounds = [kernels.batch_bounds(data["sparse"][b * batch:(b + 1) * batch], vocab,
                                   table_dtype.itemsize, width, pack)[0] for b in range(pool_n)]
    host = {k: v.cpu().numpy() for k, v in data.items()}
    del data
    pool = [{k: v[i * batch:(i + 1) * batch].copy() for k, v in host.items()}
            for i in range(pool_n)]
    del host

    runner = dict(cfg["runner"], train_batch_size=batch, infer_batch_size=batch,
                  seed=cell.seed % (1 << 31))
    model_def = load_model_def(Config(flatten_config({"runner": runner,
                                                      "hyper_parameters": hp})))
    # as tools/export.py's load_exported: full float32 products
    full_float32_matmul()
    module = model_def.make_module(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(module.named_parameters())
    leaves = reference.all_leaves(model, hp)
    if sorted(params) != sorted(n for n, *_ in leaves):
        raise ValueError(f"the port's leaves {sorted(params)} are not the reference's")
    for name, shape, dtype, init in leaves:
        if tuple(params[name].shape) != tuple(shape) or params[name].dtype != dtype:
            raise ValueError(f"{name}: the port's {tuple(params[name].shape)}, "
                             f"the reference's {tuple(shape)}")
        weights.fill_(params[name].data, name, init, cell.seed)
    del params

    def score(i: int) -> np.ndarray:
        batch_t = to_tensors(pool[i % pool_n], dev)
        with model_def.infer_context(torch.inference_mode):
            aux = model_def.infer_forward(module, batch_t)
        return aux["predictions"].cpu().numpy()

    for i in range(int(tr["warmup_batches"])):
        score(i)
    sample = np.random.default_rng(gen.stream_seed(cell.seed, "sample"))
    kept, latencies, failed = [], [], 0
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    i = 0
    while True:
        start = time.perf_counter()
        preds = score(i)
        latencies.append(time.perf_counter() - start)
        if preds.shape != (batch,) or not np.all(np.isfinite(preds)):
            failed += 1
        if (i == 0 or sample.random() < float(tr["sample_share"])) and \
                len(kept) < int(tr["sample_max"]):
            kept.append((i % pool_n, preds.copy()))
        i += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    wall = time.perf_counter() - t0

    reduced, traced = None, int(tr["trace_batches"])
    if cell.trace:
        from torch.profiler import record_function

        def traced_loop():
            for j in range(i, i + traced):
                with record_function("recbench.score"):
                    score(j)
        reduced = trace.capture(traced_loop)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del module, model_def
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference.predictions(model, cfg, cell.seed, [pool[j] for j, _ in kept], dev)
    compared = reference.compare_scores([p for _, p in kept], ref)
    counts = {
        "driver": "score", "batches": i, "window_s": wall, "trace_steps": traced,
        "flops": model.flops(hp)["forward"] * batch * i, "peak_flops": F32_FLOPS,
        "k1_bound_s": sum(bounds[j % pool_n] for j in range(i, i + traced)),
    }
    return harness.Outcome(
        end_to_end={"score_examples_per_s": i * batch / wall,
                    "score_batch_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
                    "setup_s": setup_s},
        counts=counts, compared=compared, attempted=i, failed=failed,
        memory_peak_bytes=peak, trace=reduced)
