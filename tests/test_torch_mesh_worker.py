"""One rank of the mesh trainer's multi-process checks (no tests here).

``tests/test_torch_parallel_train.py`` and ``tests/test_torch_parallel_sparse.py``
launch this file through ``paddlerec_tpu_torch.tools.launch`` (gloo, on the
CPU) with a case directory holding ``case.pt``: the mesh, the lowered
``MIN_ROWS_TO_SHARD`` and a list of jobs.  Each rank runs every job in
order and writes ``rank<r>.pt``: by job, what the tests hold against the
JAX ``Trainer`` on the same ``(dp, mp)`` CPU mesh and against the other
ranks.  Kinds of job:

* ``steps``: a ``Trainer`` from the job's flat config, its parameters
  loaded from the job's state_dict (the JAX trainer's initial parameters,
  whole) cut to this rank's rows; then ``train_step`` on this rank's dp row
  of each global batch, with the global dedup of a sparse run (or the host
  dedup of one dp row) where the job asks for it.  Gives each step's loss and local state, the final
  optimizer and row state, the metric state (this rank's and the mesh's),
  the dedup arrays, and every K1 / K1b call of the steps (``double_sum``:
  the same with the sharded table's gradient in the dense dp sum as well);
* ``overflow``: a step on the job's skewed batch, a check, a second step
  and a second check; the overflow counter, the strikes and the error;
* ``train``: ``Trainer.train()`` over the job's data directory (file shards
  by dp row), its metrics, steps and final state; then a fresh ``Trainer``
  resumed from the epoch's checkpoint, its state, and one step of both on
  the job's extra batch.
"""

import os
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Launch:
    """``tools.launch`` of ``nproc`` gloo ranks of this file over a case
    directory, on a thread, so that the caller computes the JAX side while
    the ranks start; ``ranks()`` waits and returns each rank's results."""

    def __init__(self, case_dir, nproc: int, timeout: float = 300):
        from paddlerec_tpu_torch.tools import launch

        self.case_dir, self.nproc, self.rc = str(case_dir), nproc, None

        def go():
            self.rc = launch.launch(nproc, [sys.executable, os.path.abspath(__file__),
                                            self.case_dir], backend="gloo", timeout=timeout)

        self.thread = threading.Thread(target=go, daemon=True)
        self.thread.start()

    def ranks(self):
        import torch

        self.thread.join()
        assert self.rc == 0, f"the ranks exited with {self.rc}"
        return [torch.load(os.path.join(self.case_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.nproc)]


def _counting(fn, calls, name):
    def wrapper(*args, **kwargs):
        calls.append((name, tuple(args[0].shape), tuple(args[1].shape),
                      kwargs.get("mode", "clip")))
        return fn(*args, **kwargs)
    return wrapper


def _host(tree):
    """A tree of tensors (dicts, named tuples) with its tensors on the CPU."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().cpu()
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _row(batch, mesh):
    """This rank's dp row of a global numpy batch."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // mesh.dp
        out[k] = v[mesh.dp_index * b:(mesh.dp_index + 1) * b]
    return out


def _trainer(job):
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.train.trainer import Trainer

    trainer = Trainer(Config(dict(job["config"])), device="cpu")
    trainer.init_state()
    if "params" in job:
        trainer.state.module.load_state_dict(
            trainer._local(job["params"], trainer._sharded))
    return trainer


def run_steps(job, calls):
    import torch

    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import _count_uniq

    t = _trainer(job)
    if job.get("double_sum"):
        t._sharded = frozenset()  # the table's gradient joins the dense dp sum
    ms = t._init_metric_state()
    losses, states, dedups, step_calls = [], [], [], []
    for batch in job["batches"]:
        row = _row(batch, t.mesh)
        if job.get("global_dedup"):
            uniq, slot = t.model_def.global_dedup_arrays(row, t.mesh, torch.device("cpu"))
            dedups.append((uniq, slot))
            row = _count_uniq(dict(row, sparse_uniq=uniq, sparse_slot=slot))
        elif job.get("augment"):  # the feed's host dedup of a dp row (dp = 1)
            row = _count_uniq(t.model_def.augment_batch_host(row))
        calls.clear()
        ms, loss = t.train_step(to_tensors(row, t.device), ms)
        step_calls.append(list(calls))
        losses.append(float(loss))
        states.append(_host(t.state.module.state_dict()))
    return {"losses": losses, "states": states, "dedups": dedups, "calls": step_calls,
            "opt_state": _host(t.state.opt_state), "extra": _host(t.state.extra),
            "sharded": sorted(t._sharded), "metric_state": _host(ms),
            "global_metric_state": _host(t._global_metrics(ms)),
            "metrics": t._compute_metrics(ms)}


def run_overflow(job, calls):
    from paddlerec_tpu_torch.core.device import to_tensors

    t = _trainer(job)
    ms = t._init_metric_state()
    batch = to_tensors(_row(job["batch"], t.mesh), t.device)
    out = {"has_counter": "embedding_overflow" in ms}
    ms, _ = t.train_step(batch, ms)
    out["local"] = int(ms["embedding_overflow"])
    out["total"] = int(t._global_metrics(ms)["embedding_overflow"])
    t._check_overflow(ms)
    out["strikes"] = t._overflow_strikes
    ms, _ = t.train_step(batch, ms)
    try:
        t._check_overflow(ms)
        out["error"] = None
    except RuntimeError as e:
        out["error"] = str(e)
    out["metrics_total"] = t._compute_metrics(ms)["embedding_overflow"]
    return out


def run_train(job, calls):
    import torch

    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer

    cfg = dict(job["config"])
    t = Trainer(Config(cfg), device="cpu")
    steps = []
    step = t.train_step

    def counted(batch, ms):
        steps.append(1)
        return step(batch, ms)

    t.train_step = counted
    metrics = t.train()
    out = {"metrics": metrics, "steps": len(steps), "state": _host(t.state.module.state_dict()),
           "opt_state": _host(t.state.opt_state), "extra": _host(t.state.extra)}
    resumed = Trainer(Config(cfg), device="cpu")
    resumed.load_checkpoint(cfg["runner.model_save_path"], 0)
    out["resumed_state"] = _host(resumed.state.module.state_dict())
    out["resumed_opt_state"] = _host(resumed.state.opt_state)
    out["resumed_extra"] = _host(resumed.state.extra)
    batch = _row(job["next_batch"], t.mesh)
    for name, trainer in (("next_loss", t), ("resumed_next_loss", resumed)):
        _, loss = trainer.train_step(to_tensors(batch, trainer.device),
                                     trainer._init_metric_state())
        out[name] = float(loss)
    out["resumed_next_state"] = _host(resumed.state.module.state_dict())
    out["next_state"] = _host(t.state.module.state_dict())
    out["saved"] = sorted(os.listdir(cfg["runner.model_save_path"]))
    out["device"] = str(torch.device(t.device))
    return out


def run(case_dir: str) -> None:
    import torch

    from paddlerec_tpu_torch.ops import sparse_update
    from paddlerec_tpu_torch.parallel import embedding as emb
    from paddlerec_tpu_torch.parallel import sharding
    from paddlerec_tpu_torch.tools.launch import init_from_env

    torch.set_num_threads(1)
    device = init_from_env("cpu", timeout_s=300)
    case = torch.load(os.path.join(case_dir, "case.pt"), weights_only=False)
    sharding.MIN_ROWS_TO_SHARD = case["min_rows"]
    calls = []
    emb.gather_pool = _counting(emb.gather_pool, calls, "k1")
    emb.gather_pool_bwd = _counting(emb.gather_pool_bwd, calls, "k1b")
    sparse_update.gather_pool_bwd = _counting(sparse_update.gather_pool_bwd, calls, "merge")
    kinds = {"steps": run_steps, "overflow": run_overflow, "train": run_train}
    out = {"device": str(device)}
    for job in case["jobs"]:
        out[job["name"]] = kinds[job["kind"]](job, calls)
    torch.save(out, os.path.join(case_dir, f"rank{torch.distributed.get_rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    run(sys.argv[1])
