"""Training cells: the port's ``Trainer.train()``, the call ``tools/train.py``
makes, over a corpus of distinct seeded batches written as slotbin under
the run's temporary directory.

Set-up builds one trainer, writes the benchmark's weights into it, and runs
``warmup_epochs`` whole epochs through ``train()``: the first stages the
corpus (host dedup, wire encoding, superbatches kept on the card), the
others replay it from the card in the trainer's own reshuffled order, as
every epoch of the window does.  Every set-up step is matched to the corpus
batch it got by its labels (the benchmark does not copy the trainer's
shuffle): ``epoch_cover`` counts the corpus batches an epoch skipped or
repeated.  The first ``checked_steps`` steps of the first replayed epoch,
which run the window's path, are read as they happen: each step's loss;
at the first, every leaf's gradient as the optimizer got it (from Adam's
first moment and the table's row accumulator, before and after) and the
table rows it touched, before and after; after the last, every leaf's
change over the checked steps.  Once the window has closed and the trainer
is gone, the plain reference follows the same steps, from the weights
through the whole staging epoch to the last checked step.

The window is whole ``train()`` epochs back to back, each ending in the
trainer's own synchronisation and AUC read, until ``seconds`` have passed:
the cell's ``train_examples_per_s.*`` is every example they trained over
their wall time.  With tracing, ``trace_epochs`` more epochs run under the
profiler.
"""

from __future__ import annotations

import gc
import logging
import math
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from recbench import harness, kernels, reference, trace, weights
from recbench import traffic as gen
from recbench.peaks import F32_FLOPS

READER_COST = re.compile(r"avg_reader_cost: ([0-9.eE+-]+) sec")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _spans(trainer):
    """``recbench.*`` spans around the trainer's layers, for the trace."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def spanned(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return spanned

    feed = trainer._device_batches

    def device_batches(*a, **k):
        it = feed(*a, **k)
        while True:
            with record_function("recbench.feed"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    trainer.train_step = wrap("recbench.train_step", trainer.train_step)
    trainer._compute_metrics = wrap("recbench.epoch_metrics", trainer._compute_metrics)
    trainer._auc_str = wrap("recbench.log_auc", trainer._auc_str)
    trainer._device_batches = device_batches

    def restore():
        for attr in ("train_step", "_compute_metrics", "_auc_str", "_device_batches"):
            del trainer.__dict__[attr]
    return restore


class _Span:
    """What the program did over ``checked`` consecutive steps, read from
    its state as they happen: each step's loss; at the first, every leaf's
    gradient as the optimizer got it (from Adam's first moment, before and
    after, and the table's row accumulator) and the table rows it touched,
    before and after; over them all, every leaf's change; and the state
    before them that the steps touched (dense leaves, their moments; the
    table's rows and accumulator, each row as it was before the span first
    touched it), on the host."""

    def __init__(self, checked: int, b1: float):
        self.checked, self.b1 = checked, b1
        self.losses, self.grad, self.change = [], {}, {}
        self.seen, self.rows, self.accs = None, [], []
        self.n = 0

    @torch.no_grad()
    def before(self, k, state, params, dense, table_name, acc, ids):
        table = params[table_name]
        step_rows = torch.unique(ids)
        if self.n == 0:
            opt = state.opt_state
            self.p0 = {n: params[n].detach().clone() for n in dense}
            self.m0 = {n: opt["mu"][n].detach().clone() for n in dense}
            self.v0 = {n: opt["nu"][n].detach().to("cpu", copy=True) for n in dense}
            self.acc0 = acc.clone()
            self.step_rows, self.rows_before = step_rows, table[step_rows].cpu()
            fresh = step_rows
            self.seen = step_rows
        else:
            fresh = step_rows[~torch.isin(step_rows, self.seen)]
            self.seen = torch.cat([self.seen, fresh])
        self.rows.append(table[fresh].cpu())
        self.accs.append(acc[fresh].cpu())

    @torch.no_grad()
    def after(self, state, params, dense, table_name, acc):
        table = params[table_name]
        self.n += 1
        if self.n == 1:
            mu = state.opt_state["mu"]
            self.grad = {n: float(torch.linalg.vector_norm(
                (mu[n].double() - self.b1 * self.m0[n].double()) / (1.0 - self.b1)))
                for n in dense}
            self.grad[table_name] = math.sqrt(
                128.0 * float((acc.double() - self.acc0.double()).sum()))
            self.rows_after = table[self.step_rows].cpu()
            self.acc0 = None
        if self.n == self.checked:
            self.change = {n: float(torch.linalg.vector_norm(
                params[n].double() - self.p0[n].double())) for n in dense}
            d = table[self.seen].cpu().double() - torch.cat(self.rows).double()
            self.change[table_name] = float(torch.linalg.vector_norm(d))
            order = torch.argsort(self.seen)
            self.table_change = (self.seen[order].cpu(), d[order.cpu()])
            self.p0 = {n: t.cpu() for n, t in self.p0.items()}
            self.m0 = {n: t.cpu() for n, t in self.m0.items()}

    @property
    def done(self) -> bool:
        return self.n == self.checked

    def readings(self):
        return {"losses": self.losses, "grad": self.grad, "change": self.change,
                "table_change": self.table_change}

    def start_state(self, count: int):
        """The state before the span, in ``reference.train_readings``'s form."""
        order = torch.argsort(self.seen)
        return {"count": count, "rows": self.seen[order],
                "table": torch.cat(self.rows)[order.cpu()],
                "acc": torch.cat(self.accs)[order.cpu()],
                "params": self.p0, "m": self.m0, "v": self.v0}


def _print_pairs(label, prog, ref):
    for key in ("losses", "grad", "change"):
        pairs = (zip(prog[key], ref[key]) if key == "losses"
                 else ((n, prog[key].get(n), ref[key][n]) for n in ref[key]))
        print(f"{label} {key}: " + "; ".join(map(str, pairs)), file=sys.stderr)


def run(cell: harness.Cell) -> harness.Outcome:
    corpus = os.path.join(tempfile.gettempdir(), f"recbench-{cell.name}-{cell.seed}")
    shutil.rmtree(corpus, ignore_errors=True)
    os.makedirs(corpus)
    try:
        return _run(cell, corpus)
    finally:
        shutil.rmtree(corpus, ignore_errors=True)


def _run(cell: harness.Cell, corpus: str) -> harness.Outcome:
    from paddlerec_tpu_torch.core.config import Config, flatten_config
    from paddlerec_tpu_torch.train.trainer import Trainer

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    hp = cfg["hyper_parameters"]
    model = harness.model_module(cfg)
    batch, batches = int(tr["batch_size"]), int(tr["batches"])
    vocab = int(hp["sparse_feature_number"])
    table_name, _, table_dtype, table_init = reference.table_leaf(model, hp)
    _, width, pack = reference.layout(vocab, model.logical_dim(hp))

    rc = reference.recipe(hp)
    data = gen.generate(cell.seed, "corpus", batch * batches, cfg, tr, dev)
    bounds = [kernels.batch_bounds(data["sparse"][b * batch:(b + 1) * batch], vocab,
                                   table_dtype.itemsize, width, pack) for b in range(batches)]
    k1_epoch, k1b_epoch = (sum(x) for x in zip(*bounds))
    labels = data["label"].view(batches, batch).clone()
    phys = ((data["sparse"].long() % vocab) // pack).view(batches, -1)
    host = {k: v.cpu().numpy() for k, v in data.items()}
    del data
    gen.write_slotbin(os.path.join(corpus, "part-0.bin"), host["label"], host["sparse"],
                      host["dense"])
    corpus_batches = [{k: v[i * batch:(i + 1) * batch].copy() for k, v in host.items()}
                      for i in range(batches)]
    del host

    # the trainer seeds numpy's RandomState with runner.seed, which takes
    # 32 bits: the run's seed folded into 31
    runner = dict(cfg["runner"], train_data_dir=corpus, train_batch_size=batch,
                  infer_batch_size=batch, epochs=1, print_interval=batches,
                  seed=cell.seed % (1 << 31), use_auc=True, **tr["runner"])
    trainer = Trainer(Config(flatten_config({"runner": runner, "hyper_parameters": hp})),
                      device=dev)
    trainer.init_state(seed=0)
    params = dict(trainer.state.module.named_parameters())
    leaves = reference.all_leaves(model, hp)
    if sorted(params) != sorted(n for n, *_ in leaves):
        raise ValueError(f"the port's leaves {sorted(params)} are not the reference's")
    for name, shape, dtype, init in leaves:
        p = params[name]
        if tuple(p.shape) != tuple(shape) or p.dtype != dtype:
            raise ValueError(f"{name}: the port's {tuple(p.shape)} {p.dtype}, "
                             f"the reference's {tuple(shape)} {dtype}")
        weights.fill_(p.data, name, init, cell.seed)
    dense_names = [n for n, *_ in model.leaves(hp)]
    state = trainer.state
    acc = next(iter(state.extra.values())).acc
    checked = int(tr["checked_steps"])
    # the first steps of the staging epoch and of the first replayed one
    spans = {0: _Span(checked, rc["b1"]), batches: _Span(checked, rc["b1"])}
    seq = []

    def checked_step(b, metric_state):
        lab = b["label"].reshape(1, -1).to(torch.float32)
        hit = torch.nonzero((labels == lab).all(dim=1)).reshape(-1).tolist()
        seq.append(hit[0] if len(hit) == 1 else -1)
        k = len(seq) - 1
        span = next((sp for s0, sp in spans.items() if s0 <= k < s0 + checked), None)
        if span is not None and seq[-1] >= 0:
            span.before(k, state, params, dense_names, table_name, acc, phys[seq[-1]])
        out = Trainer.train_step(trainer, b, metric_state)
        if k < batches or span is not None:
            (spans[batches] if k >= batches else spans[0]).losses.append(float(out[1]))
        if span is not None and seq[-1] >= 0:
            span.after(state, params, dense_names, table_name, acc)
        return out

    trainer.train_step = checked_step
    warm = int(tr["warmup_epochs"])
    for _ in range(warm):
        trainer.train()
    del trainer.__dict__["train_step"]
    epoch_cover = float(abs(len(seq) - warm * batches) + sum(
        abs(seq[e * batches:(e + 1) * batches].count(i) - 1)
        for e in range(warm) for i in range(batches)))

    lines = _Lines()
    log = logging.getLogger("paddlerec_tpu_torch")
    log.addHandler(lines)
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    epochs = 0
    while True:
        trainer.train()
        epochs += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    wall = time.perf_counter() - t0
    log.removeHandler(lines)

    reduced = None
    trace_epochs = int(tr["trace_epochs"])
    if cell.trace:
        restore = _spans(trainer)
        reduced = trace.capture(lambda: [trainer.train() for _ in range(trace_epochs)])
        restore()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del trainer, state, params, acc, labels, phys
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared = {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                "replay_loss_gap": math.inf, "replay_grad_gap": math.inf,
                "replay_change_gap": math.inf}
    if rc["stochastic"]:
        compared["small_step_gap"] = math.inf
    stage, replay = spans[0], spans[batches]
    if min(seq[:batches + checked], default=-1) >= 0 and stage.done and replay.done:
        # the staging epoch from the benchmark's weights; the replayed
        # steps from the program's own state before them
        ref = reference.train_readings(model, cfg, cell.seed,
                                       [corpus_batches[i] for i in seq[:batches]], checked, dev)
        # a stochastically rounded table's change norm carries the rounding's
        # noise: its change is compared along the reference's
        sr = {"table_projection": rc["stochastic"]}
        compared.update(reference.compare_train(stage.readings(), ref, **sr))
        _print_pairs("staging", stage.readings(), ref)
        ref = reference.train_readings(
            model, cfg, cell.seed, [corpus_batches[i] for i in seq[batches:batches + checked]],
            checked, dev, start=replay.start_state(batches))
        # the table's gradient at a replayed step sums hot rows whose terms
        # cancel once the model has learned the base rate: its rounding is
        # the noise of that one leaf, and its update is held by the change
        compared.update(reference.compare_train(replay.readings(), ref, "replay_",
                                                table_grad=False, **sr))
        _print_pairs("replay", replay.readings(), ref)
        if rc["stochastic"]:
            rows, step = ref["row_step"]
            compared["small_step_gap"] = (reference.small_step_gap(
                replay.rows_before.to(dev), replay.rows_after.to(dev), step)
                if torch.equal(rows.cpu(), replay.step_rows.cpu()) else math.inf)
    compared["epoch_cover"] = epoch_cover
    print(f"steps matched to corpus batches: {seq}", file=sys.stderr)
    steps = epochs * batches
    counts = {
        "driver": "train", "steps": steps, "window_s": wall,
        "flops": model.flops(hp)["train"] * batch * steps, "peak_flops": F32_FLOPS,
        "reader_cost_s": [float(m.group(1)) for line in lines.lines
                          for m in [READER_COST.search(line)] if m],
        "trace_steps": trace_epochs * batches,
        "k1_bound_s": trace_epochs * k1_epoch, "k1b_bound_s": trace_epochs * k1b_epoch,
    }
    return harness.Outcome(
        end_to_end={"train_examples_per_s": epochs * batch * batches / wall,
                    "setup_s": setup_s},
        counts=counts, compared=compared, attempted=steps, failed=0,
        memory_peak_bytes=peak, trace=reduced)
