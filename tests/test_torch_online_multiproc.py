"""The online day/pass loop across processes: the port's gloo ranks on the CPU
against the JAX package.

* Two processes of each package (dp = 2; the JAX package's two
  ``jax.distributed`` processes, as ``tests/test_multihost_lifecycle.py``
  starts them) train one day of two passes, each process its file shard,
  from the JAX workers' initial parameters.  Held: the merged ``FeatureStats``
  (bitwise, the same on every rank), the donefile (rank 0 alone writes), each
  delta's keys (exact) and values (``VALUE_ATOL``), shrink's evictions, the
  final table.
* The port's 2×2 mesh of four ranks (the table row-sharded over mp, the
  engine in ``SlotEmbedding``) against the JAX package's one-process 2×2 CPU
  mesh (as ``tests/test_online_mp.py`` runs it), fed the same global batches
  (dp row i's file shard is the i-th part of each global batch): the same
  checks, the shards' replicas bitwise equal.
* ``batch_rows_by_table`` on the mp-padded geometry at mp = 2 against the JAX
  function.

Each launch waits with a timeout; one launch of each kind serves the module."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.data.slot_reader import SlotDataset, list_data_files, shard_files
from paddlerec_tpu.data.schema import schema_from_config
from paddlerec_tpu.parallel import context as jax_context
from paddlerec_tpu.parallel import sharding as jax_sharding
from paddlerec_tpu.parallel.mesh import create_mesh as jax_create_mesh
from paddlerec_tpu.train import online as jax_online
from paddlerec_tpu.train import touched as jax_touched
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.core.registry import load_model_def
from paddlerec_tpu_torch.native.cube import CubeClient
from paddlerec_tpu_torch.parallel import context as port_context
from paddlerec_tpu_torch.parallel.mesh import Mesh
from paddlerec_tpu_torch.tools import launch as port_launch
from paddlerec_tpu_torch.train import touched as port_touched

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAY = "20240101"
VOCAB = 4993  # 625 rows at pack 8: padded to 626 at mp = 2
PASSES = ("0000", "1200")  # split_interval 720: two passes a day
ROWS, FILES = 128, 2  # a pass: one file a dp row, 64 rows
MIN_ROWS = 64  # MIN_ROWS_TO_SHARD in both packages: the table shards
LAUNCH_TIMEOUT = 180
# float32 sums in another order (the dp rows' gradients added by a collective
# against XLA's one program), kept by Adam's m / sqrt(v): the 1e-5 of the
# one-process online parity test.  Measured on the deltas: 1.8e-8 (two
# processes), 4.3e-7 (2×2)
VALUE_ATOL = 1e-5
FLAT = {
    "runner.model": "rank.dnn", "runner.infer_batch_size": 32,
    "runner.days": DAY, "runner.split_interval": 720, "runner.split_per_pass": 1,
    "runner.checkpoint_per_pass": 1, "runner.save_delta_frequency": 1,
    "runner.save_first_base": True, "runner.delta_cube_shards": 2, "runner.seed": 0,
    "hyper_parameters.sparse_inputs_slots": 27, "hyper_parameters.dense_input_dim": 13,
    "hyper_parameters.sparse_feature_number": VOCAB, "hyper_parameters.sparse_feature_dim": 9,
    "hyper_parameters.fc_sizes": [16], "hyper_parameters.optimizer.class": "Adam",
    "hyper_parameters.optimizer.learning_rate": 0.001,
    # a physical row (8 ids) is seen ~11 times a day here: about a quarter
    # of them fall under it at the day's end
    "table_parameters.delete_threshold": 8.0,
}

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
    from paddlerec_tpu.train.online import OnlineTrainer

    out, flat = sys.argv[1], json.load(open(sys.argv[2]))
    rank = jax.process_index()
    t = OnlineTrainer(Config(flat))
    t.init_state()
    params = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(
                  jax.device_get(t.state.params))[0]}
    if rank == 0:
        np.savez(os.path.join(out, "init.npz"), **params)
    evicted = []
    shrink = t.shrink
    t.shrink = lambda: evicted.append(shrink()) or evicted[-1]
    t.run()
    st = t.stats["embedding/embedding"]
    table = np.asarray(jax.device_get(t.state.params["embedding"]["embedding"]), np.float32)
    np.savez(os.path.join(out, f"rank{rank}.npz"), show=st.show, seen=st.seen,
             unseen_days=st.unseen_days, evicted=np.asarray(evicted), table=table)
""")

PORT_WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, os.environ["PADDLEREC_REPO"])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddlerec_tpu_torch.convert import from_jax_params
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.parallel import sharding
    from paddlerec_tpu_torch.tools.launch import init_from_env
    from paddlerec_tpu_torch.train.online import OnlineTrainer

    sharding.MIN_ROWS_TO_SHARD = int(sys.argv[4])
    init_from_env("cpu", timeout_s=60)
    out, flat, init = sys.argv[1], json.load(open(sys.argv[2])), sys.argv[3]
    rank = torch.distributed.get_rank()
    t = OnlineTrainer(Config(flat), device="cpu")
    t.init_state()
    deadline = time.time() + 120
    while not os.path.exists(init + ".done") and time.time() < deadline:
        time.sleep(0.2)
    t.state.module.load_state_dict(t._local(from_jax_params(dict(np.load(init))), t._sharded))
    evicted = []
    shrink = t.shrink
    t.shrink = lambda: evicted.append(shrink()) or evicted[-1]
    t.run()
    st = t.stats["embedding/embedding"]
    table = t.state.module.embedding.embedding.detach().float().numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), show=st.show, seen=st.seen,
             unseen_days=st.unseen_days, evicted=np.asarray(evicted), table=table,
             sharded=np.asarray(sorted(t._sharded)), mp_index=t.mesh.mp_index)
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_day(root):
    for i, p in enumerate(PASSES):
        write_criteo_sample(os.path.join(root, DAY, p), num_lines=ROWS, num_files=FILES,
                            vocab=VOCAB, seed=i)


def _mark_done(path: str, procs=(), timeout: float = LAUNCH_TIMEOUT) -> None:
    """``<path>.done`` once ``path`` is a whole npz (the port's ranks wait for
    it); gives up when every process in ``procs`` has ended."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if procs and all(p.poll() is not None for p in procs):
            return
        if os.path.exists(path):
            try:
                np.load(path).files
            except Exception:
                time.sleep(0.1)
                continue
            open(path + ".done", "w").close()
            return
        time.sleep(0.1)


def _port_launch(nproc: int, out, flat, init, log) -> subprocess.Popen:
    """``tools.launch`` of ``nproc`` gloo ranks of the port's worker, started
    without waiting."""
    json.dump(flat, open(out / "flat.json", "w"))
    cmd = [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc", str(nproc),
           "--backend", "gloo", "--", sys.executable, str(out.parent / "port_worker.py"),
           str(out), str(out / "flat.json"), str(init), str(MIN_ROWS)]
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PADDLEREC_REPO=REPO),
                            stdout=log, stderr=subprocess.STDOUT)


def _finish(proc, timeout: float, log_path) -> None:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    assert rc == 0, f"{rc}: {open(log_path).read()[-4000:]}"


def _records(root):
    with open(os.path.join(root, "online_donefile.txt")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["day"], r["pass"], r["kind"], os.path.relpath(r["path"], root)) for r in recs]


def _delta(path):
    """{table: (keys, values)} of a delta's cube shards, keys ascending."""
    meta = json.load(open(os.path.join(path, "delta_meta.json")))
    out = {}
    for t in meta["tables"]:
        if not t["keys"]:
            continue
        d = os.path.join(path, t["name"])
        shards = sorted(os.path.join(d, f) for f in os.listdir(d))
        keys = np.sort(np.concatenate([
            np.fromfile(s, np.int64, int(np.fromfile(s, np.uint64, 3)[2]), offset=24)
            for s in shards]))
        with CubeClient(shards) as client:
            out[t["name"]] = (keys, client.seek(keys))
    return out


def _results(out, ranks):
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(ranks)]


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """One day of two passes through 2 JAX processes and 2 port ranks (dp =
    2), the port started from the JAX workers' parameters."""
    root = tmp_path_factory.mktemp("online_2p")
    data, jax_out, port_out = root / "data", root / "jax", root / "port"
    _write_day(str(data))
    for d in (jax_out, port_out):
        d.mkdir()
    (root / "jax_worker.py").write_text(JAX_WORKER)
    (root / "port_worker.py").write_text(PORT_WORKER)
    flat = {**FLAT, "runner.train_data_dir": str(data), "runner.train_batch_size": 32}
    json.dump({**flat, "runner.model_save_path": str(jax_out)}, open(jax_out / "flat.json", "w"))
    port = _free_port()
    jax_log = open(root / "jax.log", "w")
    jax_procs = [subprocess.Popen(
        [sys.executable, str(root / "jax_worker.py"), str(jax_out), str(jax_out / "flat.json")],
        env=dict(os.environ, PADDLEREC_REPO=REPO, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r)),
        stdout=jax_log, stderr=subprocess.STDOUT) for r in range(2)]
    init = jax_out / "init.npz"
    marker = threading.Thread(target=_mark_done, args=(str(init), jax_procs), daemon=True)
    marker.start()
    port_log = open(root / "port.log", "w")
    proc = _port_launch(2, port_out, {**flat, "runner.model_save_path": str(port_out)}, init,
                        port_log)
    try:
        for p in jax_procs:
            _finish(p, LAUNCH_TIMEOUT, root / "jax.log")
        _finish(proc, LAUNCH_TIMEOUT, root / "port.log")
    finally:
        for p in jax_procs + [proc]:
            if p.poll() is None:
                p.kill()
    return {"jax": _results(jax_out, 2), "port": _results(port_out, 2),
            "jax_root": str(jax_out), "port_root": str(port_out)}


def _global_dataset(dirs, cfg, per_row: int, dp: int):
    """The global batches a dp × mp mesh of the port feeds: dp row i's batch
    of its file shard is the i-th part of each, the rows stopping together."""
    class Global:
        def __iter__(self):
            for d in dirs:
                files = list_data_files(d)
                rows = [SlotDataset(shard_files(files, i, dp), schema_from_config(cfg), per_row)
                        for i in range(dp)]
                for parts in zip(*rows):
                    yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return Global()


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """The port's 2×2 ranks and the JAX package's one-process 2×2 mesh on the
    same global batches, from the same start."""
    root = tmp_path_factory.mktemp("online_2x2")
    data, jax_out, port_out = root / "data", root / "jax", root / "port"
    _write_day(str(data))
    port_out.mkdir()
    (root / "port_worker.py").write_text(PORT_WORKER)
    flat = {**FLAT, "runner.train_data_dir": str(data),
            "hyper_parameters.distributed_embedding": 1}
    old = jax_sharding.MIN_ROWS_TO_SHARD
    jax_sharding.MIN_ROWS_TO_SHARD = MIN_ROWS
    try:
        cfg = JaxConfig({**flat, "runner.model_save_path": str(jax_out),
                         "runner.train_batch_size": 32})
        jt = jax_online.OnlineTrainer(cfg, mesh=jax_create_mesh(2, 2, jax.devices()[:4]))
        jt.init_state()
        params = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                  for p, v in jax.tree_util.tree_flatten_with_path(
                      jax.device_get(jt.state.params))[0]}
        init = root / "init.npz"
        np.savez(init, **params)
        open(str(init) + ".done", "w").close()
        log = open(root / "port.log", "w")
        proc = _port_launch(4, port_out, {**flat, "runner.model_save_path": str(port_out),
                                          "runner.train_batch_size": 16,
                                          "runner.mesh_dp": 2, "runner.mesh_mp": 2},
                            init, log)
        try:
            jt._prepare_pass = lambda dirs, seed: _global_dataset(dirs, cfg, 16, 2)
            evicted = []
            shrink = jt.shrink
            jt.shrink = lambda: evicted.append(shrink()) or evicted[-1]
            jt.run()
            st = jt.stats["embedding/embedding"]
            jax_res = {"show": st.show, "seen": st.seen, "unseen_days": st.unseen_days,
                       "evicted": np.asarray(evicted),
                       "table": np.asarray(jax.device_get(
                           jt.state.params["embedding"]["embedding"]), np.float32),
                       "spec": str(jt.state.params["embedding"]["embedding"].sharding.spec)}
            _finish(proc, LAUNCH_TIMEOUT, root / "port.log")
        finally:
            if proc.poll() is None:
                proc.kill()
    finally:
        jax_sharding.MIN_ROWS_TO_SHARD = old
        jax_context.set_mesh(None)
    return {"jax": [jax_res], "port": _results(port_out, 4), "jax_root": str(jax_out),
            "port_root": str(port_out)}


@pytest.fixture(params=["two_process", "mesh_2x2"])
def run(request):
    return request.getfixturevalue(request.param)


def test_stats_merged_and_equal_on_every_rank(run):
    """The lifecycle stats after the day (its shrink included) are the JAX
    package's, bitwise, on every rank; every rank evicted the same rows."""
    want = run["jax"][0]
    for r, got in enumerate(run["port"]):
        for key in ("show", "seen", "unseen_days", "evicted"):
            assert got[key].tobytes() == want[key].tobytes(), (r, key)
    assert 0 < int(want["evicted"][0]) < len(want["seen"]) // 2 < int(want["seen"].sum())


def test_rank0_alone_writes_the_same_records(run):
    """The donefile holds each record once (rank 0 alone appends), the JAX
    package's records, and every artifact is whole."""
    got, want = _records(run["port_root"]), _records(run["jax_root"])
    assert got == want and len(got) == 6, (got, want)
    kinds = [k for _, _, k, _ in got]
    assert kinds.count("delta") == 2 and kinds.count("checkpoint") == 2


def test_deltas_match_jax(run):
    """Each delta holds the union of the dp rows' touched rows: the JAX
    package's keys exactly, their values within ``VALUE_ATOL``."""
    deltas = [r for r in _records(run["jax_root"]) if r[2] == "delta"]
    assert deltas
    for _, _, _, rel in deltas:
        want = _delta(os.path.join(run["jax_root"], rel))
        got = _delta(os.path.join(run["port_root"], rel))
        assert sorted(got) == sorted(want) and want
        for name, (keys, vals) in want.items():
            assert np.array_equal(got[name][0], keys), name
            assert float(np.abs(got[name][1] - vals).max()) <= VALUE_ATOL


def test_final_tables_match_jax_and_replicas_agree(run):
    """The table after the day (evicted rows zero) is the JAX package's
    within ``VALUE_ATOL``; the replicas of each shard are bitwise equal."""
    want = run["jax"][0]["table"]
    ranks = run["port"]
    if "embedding.embedding" in ranks[0]["sharded"]:
        mp = 2
        joined = np.concatenate([ranks[j]["table"] for j in range(mp)])
        assert joined.shape[0] == want.shape[0] and run["jax"][0]["spec"].startswith(
            "PartitionSpec('mp'")
        for r in range(len(ranks)):
            assert np.array_equal(ranks[r]["table"], ranks[int(ranks[r]["mp_index"])]["table"])
    else:
        joined = ranks[0]["table"]
        assert np.array_equal(ranks[1]["table"], joined)
    assert float(np.abs(joined - want).max()) <= VALUE_ATOL


def test_batch_rows_by_table_on_the_mp_padded_geometry():
    """At mp = 2 the padded table (626 rows, where a 4,993-id vocab takes 625
    at pack 8) maps batches onto rows as the JAX function does; a row count
    of no pack warns in both."""
    cfg = {**FLAT, "runner.train_data_dir": "", "hyper_parameters.distributed_embedding": 1}
    md = load_model_def(Config(dict(cfg)))
    from paddlerec_tpu.core.registry import load_model_def as jax_load_model_def

    jmd = jax_load_model_def(JaxConfig(dict(cfg)))
    rng = np.random.RandomState(0)
    batch = {"sparse": rng.randint(0, 3 * VOCAB, (32, 26)).astype(np.int64)}
    rows = {"embedding/embedding": 626, "odd/embedding": 627}
    jax_warned, port_warned = [], []
    port_context.set_mesh(Mesh(1, 2))
    jax_context.set_mesh(jax_create_mesh(1, 2, jax.devices()[:2]))
    try:
        want = jax_touched.batch_rows_by_table(jmd, batch, rows,
                                               warn=lambda n, w: jax_warned.append((n, w)))
        got = port_touched.batch_rows_by_table(md, batch, rows,
                                               warn=lambda n, w: port_warned.append((n, w)))
    finally:
        port_context.set_mesh(None)
        jax_context.set_mesh(None)
    assert sorted(got) == sorted(want) == ["embedding/embedding"]
    assert np.array_equal(got["embedding/embedding"], want["embedding/embedding"])
    assert port_warned == jax_warned and [n for n, _ in port_warned] == ["odd/embedding"]
    assert int(got["embedding/embedding"].max()) < 626
