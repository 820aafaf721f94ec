"""Geo and FL across processes: the port's 2 gloo ranks on the CPU against the
JAX package's 2 ``jax.distributed`` processes (as ``tests/test_geo_mode.py``
and ``tests/test_fl_mode.py`` run them), on the same uneven file shards
(three files: worker 0 reads two, worker 1 one), ``rank.dnn`` at 9 slots of
width 8.  The JAX workers dump their initial parameters; the port's workers
load them (``convert.from_jax_params``) before they train.  Each package's
workers run geo (k = 2), then FL (3 rounds of 2 local epochs, half of the
clients a round), then the refusals; one launch of each package serves the
module's tests.

Held: the steps each worker took, the rendezvous bytes, the examples merged
into the metrics, FL's plan and weights, exactly; the final parameters within
``PARAM_ATOL`` (float32 sums in another order through a few lazy Adam steps,
then the same host sums of the diffs); each package's workers bitwise equal
to each other; the refusals' messages word for word."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.tools import launch as port_launch
from tests.test_multihost_sparse import _write_slot_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1_000_000
BASE = {
    "runner.model": "rank.dnn", "runner.train_batch_size": 32, "runner.epochs": 1,
    "runner.print_interval": 100, "runner.seed": 0,
    "hyper_parameters.sparse_inputs_slots": 9, "hyper_parameters.sparse_feature_number": VOCAB,
    "hyper_parameters.sparse_feature_dim": 8, "hyper_parameters.dense_input_dim": 4,
    "hyper_parameters.fc_sizes": [16, 8], "hyper_parameters.optimizer.learning_rate": 0.01,
}
MODES = {
    "geo": {**BASE, "runner.sync_mode": "geo", "runner.geo_k_steps": 2},
    "fl": {**BASE, "runner.sync_mode": "fl", "runner.fl_rounds": 3,
           "runner.fl_local_epochs": 2, "runner.fl_client_fraction": 0.5},
}
REFUSALS = {
    "adamw": {"hyper_parameters.optimizer.class": "AdamW"},
    "embedding_l2": {"hyper_parameters.embedding_l2": 1e-4},
    "embedding_l2 at run time": {"hyper_parameters.optimizer.runtime_inject": True},
}
# float32 sums in another order (XLA's against torch's CPU kernels), kept by
# lazy Adam's m / sqrt(v) as a relative error: the 1e-5 of the one-device and
# mesh parity tests.  Measured: 8.6e-7 (geo, 7 steps), 1.2e-6 (FL, 34 steps)
PARAM_ATOL = 1e-5
LAUNCH_TIMEOUT = 240

# Both workers: train each mode from the JAX workers' start, then write
# what the test compares; ``train`` and ``refuse`` differ by package.
COMMON = textwrap.dedent("""
    def run(train, refuse, out, data, rank):
        modes = json.load(open(os.path.join(out, "modes.json")))
        for mode, flat in modes.items():
            flat = dict(flat, **{"runner.train_data_dir": data})
            res = train(mode, flat)
            np.savez(os.path.join(out, f"{PKG}_{mode}_{rank}.npz"), **res.pop("params"))
            json.dump(res, open(os.path.join(out, f"{PKG}_{mode}_{rank}.json"), "w"))
        msgs = {}
        for name, extra in json.load(open(os.path.join(out, "refusals.json"))).items():
            try:
                refuse(dict(modes["geo"], **extra), name)
                msgs[name] = None
            except ValueError as e:
                msgs[name] = str(e)
        json.dump(msgs, open(os.path.join(out, f"{PKG}_refusals_{rank}.json"), "w"))
""")

JAX_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.environ["PADDLEREC_REPO"])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.distributed.initialize(
        coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
        num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(os.environ["JAX_PROCESS_ID"]))
    import numpy as np
    from paddlerec_tpu.core.config import Config
    from paddlerec_tpu.train.fl import FLTrainer
    from paddlerec_tpu.train.trainer import Trainer
    PKG = "jax"
    """) + COMMON + textwrap.dedent("""
    def flat_params(t):
        return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(t.state.params))[0]}

    def train(mode, flat):
        t = (FLTrainer if mode == "fl" else Trainer)(Config(flat))
        t.init_state()
        if jax.process_index() == 0:
            np.savez(os.path.join(out, f"jax_{mode}_init.npz"), **flat_params(t))
        t._train_step = t._build_train_step()
        step, steps, syncs = t._train_step, [0], []
        def counted(*a):
            steps[0] += 1
            return step(*a)
        t._train_step = counted
        sync = t._geo_sync
        def recorded(counts, weights=None):
            syncs.append([np.asarray(counts).tolist(),
                          None if weights is None else np.asarray(weights).tolist()])
            return sync(counts, weights)
        t._geo_sync = recorded
        metrics = t.train()
        plan = ([bool(t._selected(r)) for r in range(t.rounds)] if mode == "fl" else [])
        return {"params": flat_params(t), "steps": steps[0], "syncs": syncs,
                "max_sync_bytes": int(t._geo_max_sync_bytes),
                "total_ins": float(metrics["total_ins"]), "plan": plan}

    def refuse(flat, name):
        t = Trainer(Config(flat))
        if name.endswith("at run time"):
            t.init_state()
            t.set_hyperparams(embedding_l2=1e-4)

    out, data = sys.argv[1], sys.argv[2]
    run(train, refuse, out, data, jax.process_index())
""")

PORT_WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, os.environ["PADDLEREC_REPO"])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.tools.launch import init_from_env
    from paddlerec_tpu_torch.train.fl import FLTrainer
    from paddlerec_tpu_torch.train.trainer import Trainer
    PKG = "port"
    """) + COMMON + textwrap.dedent("""
    def flat_params(t):
        return {k: np.asarray(v) for k, v in flatten_tree(
            to_jax_params(t.state.module.state_dict())).items()}

    def train(mode, flat):
        t = (FLTrainer if mode == "fl" else Trainer)(Config(flat), device="cpu")
        t.init_state()
        init = os.path.join(out, f"jax_{mode}_init.npz")
        deadline = time.time() + 120
        while not os.path.exists(init + ".done") and time.time() < deadline:
            time.sleep(0.2)
        t.state.module.load_state_dict(from_jax_params(dict(np.load(init))))
        step, steps, syncs = t.train_step, [0], []
        def counted(*a):
            steps[0] += 1
            return step(*a)
        t.train_step = counted
        sync = t._geo_sync
        def recorded(counts, weights=None):
            syncs.append([np.asarray(counts).tolist(),
                          None if weights is None else np.asarray(weights).tolist()])
            return sync(counts, weights)
        t._geo_sync = recorded
        metrics = t.train()
        plan = ([bool(t._selected(r)) for r in range(t.rounds)] if mode == "fl" else [])
        full = [t.plan(r).tolist() for r in range(t.rounds)] if mode == "fl" else []
        return {"params": flat_params(t), "steps": steps[0], "syncs": syncs,
                "max_sync_bytes": int(t._geo_max_sync_bytes),
                "total_ins": float(metrics["total_ins"]), "plan": plan, "full_plan": full}

    def refuse(flat, name):
        t = Trainer(Config(flat), device="cpu")
        if name.endswith("at run time"):
            t.init_state()
            t.set_hyperparams(embedding_l2=1e-4)

    init_from_env("cpu", timeout_s=60)
    out, data = sys.argv[1], sys.argv[2]
    run(train, refuse, out, data, torch.distributed.get_rank())
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_jax(nproc: int, cmd, env_extra) -> list:
    """The JAX package's launcher's processes (``tools/launch.py``'s
    environment), started without waiting: the test waits with a timeout."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, **env_extra)
        env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "JAX_NUM_PROCESSES": str(nproc), "JAX_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return errs


def _mark_inits(out: str, procs) -> None:
    """``<init>.done`` beside each of the JAX workers' initial parameter files
    once it is written whole (the port's workers wait for it)."""
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    pending = [os.path.join(out, f"jax_{m}_init.npz") for m in MODES]
    while pending and time.monotonic() < deadline:
        if all(p.poll() not in (None, 0) for p in procs):
            return
        for f in list(pending):
            if os.path.exists(f):
                try:
                    np.load(f).files  # a whole zip
                except Exception:
                    continue
                open(f + ".done", "w").close()
                pending.remove(f)
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of each package: {package: {(mode, rank): result}}, plus
    the refusals by package and rank."""
    root = tmp_path_factory.mktemp("geo_fl")
    data, out = root / "data", root / "out"
    data.mkdir()
    out.mkdir()
    # round-robin shards: worker 0 reads part-0 and part-2 (96 + 64 rows), 1 part-1
    for i, rows in enumerate((96, 64, 64)):
        _write_slot_file(data / f"part-{i}", rows, 9, 4, VOCAB, seed=i + 1)
    json.dump(MODES, open(out / "modes.json", "w"))
    json.dump(REFUSALS, open(out / "refusals.json", "w"))
    (root / "jax_worker.py").write_text(JAX_WORKER)
    (root / "port_worker.py").write_text(PORT_WORKER)
    env = {"PADDLEREC_REPO": REPO}
    jax_procs = _spawn_jax(2, [sys.executable, str(root / "jax_worker.py"), str(out),
                               str(data)], env)
    import threading

    marker = threading.Thread(target=_mark_inits, args=(str(out), jax_procs), daemon=True)
    marker.start()
    os.environ["PADDLEREC_REPO"] = REPO
    rc = port_launch.launch(2, [sys.executable, str(root / "port_worker.py"), str(out),
                                str(data)], backend="gloo", timeout=LAUNCH_TIMEOUT)
    jax_errs = _wait(jax_procs, LAUNCH_TIMEOUT)
    marker.join(timeout=5)
    assert all(code == 0 for code, _ in jax_errs), jax_errs
    assert rc == 0, f"the port's ranks exited {rc}"
    res = {}
    for pkg in ("jax", "port"):
        for mode in MODES:
            for rank in range(2):
                r = json.load(open(out / f"{pkg}_{mode}_{rank}.json"))
                r["params"] = dict(np.load(out / f"{pkg}_{mode}_{rank}.npz"))
                res[pkg, mode, rank] = r
        for rank in range(2):
            res[pkg, "refusals", rank] = json.load(open(out / f"{pkg}_refusals_{rank}.json"))
    for mode in MODES:
        res["init", mode] = dict(np.load(out / f"jax_{mode}_init.npz"))
    # the packed rows the corpus touches: (id % vocab) // pack, pack 16 at width
    # 8, over the model's slots 1..8 (sparse_inputs_slots counts the dense one)
    slots = {str(s) for s in range(1, BASE["hyper_parameters.sparse_inputs_slots"])}
    ids = [int(tok.split(":")[1]) for f in sorted(data.iterdir()) for line in open(f)
           for tok in line.split() if tok.split(":")[0] in slots]
    res["touched_rows"] = np.unique((np.asarray(ids) % VOCAB) // 16)
    return res


@pytest.mark.parametrize("mode", list(MODES))
def test_final_params_match_jax(runs, mode):
    """Both packages' workers end with the same parameters, each package's
    two bitwise equal (the rendezvous writes one base everywhere); the table
    rows no worker touched keep their initial bits, the touched ones moved."""
    for pkg in ("jax", "port"):
        a, b = runs[pkg, mode, 0]["params"], runs[pkg, mode, 1]["params"]
        assert all(np.array_equal(a[k], b[k]) for k in a), (pkg, mode)
    want, got = runs["jax", mode, 0]["params"], runs["port", mode, 0]["params"]
    assert sorted(got) == sorted(want)
    err = max(float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in want)
    assert err <= PARAM_ATOL, (mode, err)
    init, table = runs["init", mode]["embedding/embedding"], got["embedding/embedding"]
    same = np.all(table == init, axis=1)
    touched = np.zeros(len(table), bool)
    touched[runs["touched_rows"]] = True
    assert np.array_equal(~same, touched), (int((~same).sum()), int(touched.sum()))


@pytest.mark.parametrize("mode", list(MODES))
def test_steps_bytes_and_examples_match_jax(runs, mode):
    """Each worker trained every batch of its shard (geo: 5 and 2; FL: its
    local epochs in the rounds it was chosen), the rendezvous shipped the
    same bytes (touched rows, far below the table's), and the merged metrics
    counted every worker's examples."""
    for rank in range(2):
        got, want = runs["port", mode, rank], runs["jax", mode, rank]
        assert got["steps"] == want["steps"], (mode, rank, got["steps"], want["steps"])
        assert got["max_sync_bytes"] == want["max_sync_bytes"] > 0
        assert got["total_ins"] == want["total_ins"]
        assert got["syncs"] == want["syncs"]
    if mode == "geo":
        assert [runs["port", "geo", r]["steps"] for r in range(2)] == [5, 2]
        assert runs["port", "geo", 0]["total_ins"] == 224.0
        table_bytes = -(-VOCAB // 16) * 128 * 4
        assert runs["port", "geo", 0]["max_sync_bytes"] < table_bytes / 50


def test_fl_plan_and_weights_match_jax(runs):
    """Every process computes the same plan, the coordinator's seeded draw
    (``RandomState(seed·9973 + round)``, at least one client a round), as the
    JAX package's processes do; the chosen clients trained their local
    epochs; the weights are their example counts over the sum."""
    plans = {pkg: [[runs[pkg, "fl", k]["plan"][rnd] for k in range(2)]
                   for rnd in range(MODES["fl"]["runner.fl_rounds"])]
             for pkg in ("jax", "port")}
    assert plans["port"] == plans["jax"]
    assert all(runs["port", "fl", k]["full_plan"] == plans["port"] for k in range(2))
    epochs, rows = MODES["fl"]["runner.fl_local_epochs"], (160, 64)
    syncs = runs["port", "fl", 0]["syncs"]
    assert len(syncs) == MODES["fl"]["runner.fl_rounds"]
    for rnd, (counts, weights) in enumerate(syncs):
        draws = np.random.RandomState(BASE["runner.seed"] * 9973 + rnd).rand(2)
        chosen = draws < MODES["fl"]["runner.fl_client_fraction"]
        if not chosen.any():
            chosen[int(np.argmin(draws))] = True
        assert plans["port"][rnd] == chosen.tolist()
        assert counts == [epochs * rows[k] * int(chosen[k]) for k in range(2)], (rnd, counts)
        assert np.allclose(weights, np.asarray(counts) / sum(counts), rtol=0, atol=1e-7)
    # the seed's plan chooses one client in some rounds and both in others
    assert len({sum(c > 0 for c in counts) for counts, _ in syncs}) == 2


@pytest.mark.parametrize("name", list(REFUSALS))
def test_geo_refusals_match_jax(runs, name):
    """adamw and embedding_l2 (in the config, or injected at run time) are
    refused across processes with the JAX package's words."""
    for rank in range(2):
        got, want = runs["port", "refusals", rank][name], runs["jax", "refusals", rank][name]
        assert want is not None and got == want, (name, got, want)


def test_tools_train_runs_fl_rounds_across_processes(tmp_path):
    """``tools.train`` under the launcher dispatches ``sync_mode: fl`` to
    ``FLTrainer`` (the JAX CLI's dispatch): rank 0 logs each round's plan
    and saves the final model once."""
    data = tmp_path / "data"
    data.mkdir()
    for i, rows in enumerate((64, 32, 32)):
        _write_slot_file(data / f"part-{i}", rows, 9, 4, 4096, seed=i + 1)
    overrides = [f"{k}={v}" for k, v in {
        **{k: v for k, v in MODES["fl"].items() if k != "runner.model"},
        "runner.train_data_dir": str(data), "runner.model_save_path": str(tmp_path / "out"),
        "hyper_parameters.sparse_feature_number": 4096,
        "hyper_parameters.fc_sizes": "[16,8]"}.items()]
    cmd = [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc", "2",
           "--backend", "gloo", "--timeout", str(LAUNCH_TIMEOUT), "--", sys.executable, "-m",
           "paddlerec_tpu_torch.tools.train", "-m",
           os.path.join(REPO, "configs", "rank", "dnn", "config.yaml"), "--device", "cpu",
           "-o", *overrides]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=LAUNCH_TIMEOUT + 15)
    assert r.returncode == 0, r.stderr[-3000:]
    rounds = [line for line in r.stderr.splitlines() if "[fl round" in line]
    assert [line.split("[fl round ")[1][0] for line in rounds] == ["0", "1", "2"], rounds
    assert r.stderr.count("saved FL model to") == 1
    assert (tmp_path / "out" / "fl_final").is_dir()


def test_launch_timeout_stops_every_rank(tmp_path):
    """``tools.launch --timeout`` stops ranks that outlive it (exit code 124)
    instead of waiting on a rank that hangs."""
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc",
                        "2", "--backend", "gloo", "--timeout", "1", "--", sys.executable, "-c",
                        "import time; time.sleep(60)"], cwd=REPO, timeout=60)
    assert r.returncode == 124 and time.monotonic() - t0 < 30
