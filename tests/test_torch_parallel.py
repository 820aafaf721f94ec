"""The port's parallel foundation against the JAX package's: the all_to_all
engine (``parallel/embedding.py``) in 2- and 4-process gloo runs on the CPU
against the JAX engine on the same ``(dp, mp)`` CPU mesh, given the same
table and ids; the mesh from a config, the sharding rules, ``check_ported``
at one process and across processes, the launcher, and the Kubernetes
helpers with a fake API.  The cases of ``tests/test_sharded_embedding.py``
and ``tests/test_launch_visual.py``'s launcher."""

import logging
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import load_model_def as jax_load_model_def
from paddlerec_tpu.parallel import embedding as jax_emb
from paddlerec_tpu.parallel import mesh as jax_mesh
from paddlerec_tpu.parallel import sharding as jax_sharding
from paddlerec_tpu_torch.convert import flatten_tree, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import load_model_def
from paddlerec_tpu_torch.ops.packed_embedding import packed_lookup
from paddlerec_tpu_torch.parallel import context, sharding
from paddlerec_tpu_torch.parallel import embedding as port_emb
from paddlerec_tpu_torch.parallel.mesh import create_mesh, mesh_from_config
from paddlerec_tpu_torch.tools import launch as port_launch
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from paddlerec_tpu_torch.utils import k8s

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_parallel_worker.py")
MESHES = [(1, 2), (2, 2), (1, 4)]
# (vocab, dim, capacity factor) of each lookup of a run
CASES = {"lookup": (4096, 9, 1.5), "grad": (2048, 9, 1.5),
         "hot": (1024, 8, 0.05), "overflow": (16384, 8, 0.05)}


def _jax_case(dp, mp):
    """The JAX engine on the (dp, mp) CPU mesh: each case's table (its
    init output), ids, vectors, per-device overflow counts, and the
    gradient of the squared error to a target."""
    mesh = jax_mesh.create_mesh(dp, mp, jax.devices()[:dp * mp])
    rng = np.random.RandomState(dp * 10 + mp)
    ids = {"lookup": rng.randint(0, 4096, size=(64, 26)),
           "hot": np.full((32, 8), 3),
           # pack 16: physical rows 0..127, all on shard 0
           "overflow": (np.arange(256) * 8).reshape(32, 8)}
    grad_ids = rng.randint(0, 2048, size=(32, 8))
    grad_ids[:7] = grad_ids[0]  # duplicates across devices
    ids["grad"] = grad_ids
    case = {"dp": dp, "mp": mp, "grad_tgt": rng.randn(32, 8, 9).astype(np.float32)}
    for key, (vocab, dim, cf) in CASES.items():
        eng = jax_emb.ShardedEmbedding(mesh, vocab, dim, capacity_factor=cf)
        table = eng.init(jax.random.PRNGKey(len(key)))
        x = jnp.asarray(ids[key], jnp.int32)
        vecs, overflow = jax.jit(eng.lookup_with_overflow)(table, x)
        case.update({f"{key}_shape": np.array([vocab, dim]), f"{key}_cf": cf,
                     f"{key}_table": np.asarray(jax.device_get(table)),
                     f"{key}_ids": ids[key], f"{key}_vecs": np.asarray(vecs),
                     f"{key}_overflow": np.asarray(overflow).reshape(-1)})
        if key == "lookup":  # the delta-tap lookup: vectors and the delta's gradient
            delta = rng.randn(x.size, 128).astype(np.float32) * 0.01
            weight = rng.randn(*x.shape, dim).astype(np.float32)
            ext_fn = jax.jit(lambda d: eng.lookup_external(table, d, x)[0])
            case.update({"external_delta": delta, "external_weight": weight,
                         "external_vecs": np.asarray(ext_fn(jnp.asarray(delta))),
                         "external_dgrad": np.asarray(jax.grad(
                             lambda d: jnp.sum(ext_fn(d) * weight))(jnp.asarray(delta)))})
        if key == "grad":
            tgt = jnp.asarray(case["grad_tgt"])
            grad = jax.jit(jax.grad(
                lambda t: jnp.sum((eng.lookup(t, x) - tgt) ** 2)))(table)
            case["grad_dtable"] = np.asarray(jax.device_get(grad))
    return case


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"dp{m[0]}_mp{m[1]}")
def engine_run(request, tmp_path_factory):
    """One launch of dp·mp gloo ranks of the port's engine over the JAX
    case of a mesh; returns (case, per-rank results)."""
    dp, mp = request.param
    case = _jax_case(dp, mp)
    work = tmp_path_factory.mktemp(f"engine_{dp}x{mp}")
    np.savez(work / "case.npz", **{k: v for k, v in case.items()
                                   if not k.endswith(("_vecs", "_overflow", "dtable",
                                                      "_dgrad"))})
    rc = port_launch.launch(dp * mp, [sys.executable, WORKER, str(work)],
                            backend="gloo", timeout=120)
    assert rc == 0, f"the ranks exited with {rc}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(dp * mp)]
    return case, ranks


def _row(a, dp, i):
    b = a.shape[0] // dp
    return a[i * b:(i + 1) * b]


@pytest.mark.parametrize("key", ["lookup", "hot"])
def test_lookup_matches_jax(engine_run, key):
    """Every rank holds its dp row's vectors, the JAX engine's (rtol 1e-6)."""
    case, ranks = engine_run
    dp, mp = case["dp"], case["mp"]
    for r, out in enumerate(ranks):
        want = _row(case[f"{key}_vecs"], dp, r // mp)
        np.testing.assert_allclose(out[f"{key}_vecs"], want, rtol=1e-6, err_msg=str(r))


def test_lookup_external_matches_jax(engine_run):
    """The delta-tap lookup: each rank's dp row of the JAX engine's vectors
    (rtol 1e-6) and of its delta gradient (exact: a one-hot placement)."""
    case, ranks = engine_run
    dp, mp = case["dp"], case["mp"]
    for r, out in enumerate(ranks):
        i = r // mp
        np.testing.assert_allclose(out["external_vecs"], _row(case["external_vecs"], dp, i),
                                   rtol=1e-6, atol=1e-7, err_msg=str(r))
        n = out["external_dgrad"].shape[0]
        np.testing.assert_array_equal(out["external_dgrad"],
                                      case["external_dgrad"][i * n:(i + 1) * n])


def test_gradient_matches_jax(engine_run):
    """Each rank's shard gradient, summed over the mesh, is its rows of the
    JAX engine's table gradient (rtol 1e-4, atol 1e-5)."""
    case, ranks = engine_run
    mp = case["mp"]
    full = case["grad_dtable"]
    per = full.shape[0] // mp
    for r, out in enumerate(ranks):
        j = r % mp
        np.testing.assert_allclose(out["grad_dtable"], full[j * per:(j + 1) * per],
                                   rtol=1e-4, atol=1e-5, err_msg=str(r))
    # and the plain packed lookup's gradient (duplicates across ranks summed)
    table = torch.from_numpy(case["grad_table"].copy()).requires_grad_()
    vecs = packed_lookup(table, torch.from_numpy(case["grad_ids"]), 9)
    ((vecs - torch.from_numpy(case["grad_tgt"])) ** 2).sum().backward()
    np.testing.assert_allclose(full, table.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_hot_id_dedup_no_overflow(engine_run):
    """One id everywhere at a tiny capacity: dedup sends it once, no
    overflow on any rank."""
    case, ranks = engine_run
    assert case["hot_overflow"].sum() == 0
    for out in ranks:
        assert int(out["hot_overflow"].sum()) == 0


def test_overflow_count_matches_jax(engine_run):
    """The exact count of each rank, as each JAX device counts it; dropped
    ids read zeros."""
    case, ranks = engine_run
    got = np.array([int(out["overflow_overflow"].sum()) for out in ranks])
    np.testing.assert_array_equal(got, case["overflow_overflow"])
    assert got.sum() > 0
    for out in ranks:
        assert out["overflow_overflow"].shape == (1, 1)
        assert np.isfinite(out["overflow_vecs"]).all()


def test_shard_is_read_by_k1_and_written_by_k1b(engine_run):
    """The local gather is one ``gather_pool`` (K1) call on the shard, N =
    mp·C ids of L = 1, mode drop; the backward's scatter one
    ``gather_pool_bwd`` (K1b) call onto it, mode drop."""
    case, ranks = engine_run
    dp, mp = case["dp"], case["mp"]
    for key, (vocab, dim, cf) in CASES.items():
        pack = 128 // (16 if dim > 8 else 8)
        rows_local = -(-(-(-vocab // pack)) // mp) * mp // mp
        for out in ranks:
            cap = int(out[f"{key}_capacity"])
            n_row = case[f"{key}_ids"].size // dp
            assert cap == port_emb.bucket_capacity(-(-n_row // mp), mp, cf)
            want = [f"k1 ({rows_local}, 128) ({mp * cap}, 1) drop"]
            if key == "grad":
                want.append(f"k1b ({mp * cap}, 128) ({mp * cap}, 1) drop")
            assert list(out[f"{key}_calls"]) == want, key


@pytest.mark.parametrize("n,mp,cf", [(1000, 8, 1.5), (64, 4, 0.05), (416, 2, 1.5),
                                     (212992, 1, 1.5), (7, 3, 2.0)])
def test_bucket_capacity_as_jax(n, mp, cf):
    got = port_emb.bucket_capacity(n, mp, cf)
    assert got == jax_emb.bucket_capacity(n, mp, cf)
    assert got % 8 == 0 and got >= n / mp * cf


def test_engine_in_one_process_without_a_group(monkeypatch):
    """World size 1 with no process group: the exchanges are the identity,
    the lookup and its gradient the plain packed lookup's, the shard read
    by K1 and written by K1b."""
    calls = []

    def counting(fn, name):
        def wrapper(*args, **kwargs):
            calls.append((name, kwargs.get("mode")))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port_emb, "gather_pool", counting(port_emb.gather_pool, "k1"))
    monkeypatch.setattr(port_emb, "gather_pool_bwd",
                        counting(port_emb.gather_pool_bwd, "k1b"))
    mesh = create_mesh(1, 1)
    assert mesh.mp_group is None and mesh.dp_group is None
    eng = port_emb.get_engine(mesh, 3000, 9, device="cpu")
    table = eng.init(torch.Generator().manual_seed(0)).requires_grad_()
    assert table.shape == (375, 128)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 9000, (16, 26)))
    vecs, overflow = eng.lookup_with_overflow(table, ids)
    assert int(overflow) == 0 and calls == [("k1", "drop")]
    ref_table = table.detach().clone().requires_grad_()
    ref = packed_lookup(ref_table, ids % 3000, 9)
    torch.testing.assert_close(vecs, ref, rtol=0, atol=0)
    tgt = torch.randn(vecs.shape, generator=torch.Generator().manual_seed(1))
    ((vecs - tgt) ** 2).sum().backward()
    ((ref - tgt) ** 2).sum().backward()
    assert calls[-1] == ("k1b", "drop")
    torch.testing.assert_close(table.grad, ref_table.grad, rtol=1e-5, atol=1e-6)
    # the external (delta-tap) lookup: no table gradient, the delta's instead
    delta = torch.zeros((16 * 26, 128), requires_grad=True)
    ext, _ = eng.lookup_external(table, delta, ids)
    torch.testing.assert_close(ext, ref.detach())
    ext.sum().backward()
    assert delta.grad is not None and float(delta.grad.abs().sum()) > 0


@pytest.mark.parametrize("flat,world", [
    ({}, 1), ({}, 4), ({}, 8),
    ({"hyper_parameters.distributed_embedding": 1}, 1),
    ({"hyper_parameters.distributed_embedding": 1}, 4),
    ({"runner.mesh_dp": 2}, 8), ({"runner.mesh_mp": 2}, 8),
    ({"runner.mesh_dp": -1, "runner.mesh_mp": 4}, 8),
    ({"runner.mesh_dp": 2, "runner.mesh_mp": -1}, 4),
])
def test_mesh_from_config_as_jax(flat, world):
    want = jax_mesh.mesh_from_config(JaxConfig(dict(flat)), jax.devices()[:world])
    got = mesh_from_config(Config(dict(flat)), world)
    assert (got.dp, got.mp) == (want.shape["dp"], want.shape["mp"])
    assert got.shape == {"dp": want.shape["dp"], "mp": want.shape["mp"]}
    assert got.grid.shape == (got.dp, got.mp) and got.size == world
    assert got.mp_group is None and got.rank == 0


def test_create_mesh_refuses_a_grid_that_is_not_the_world():
    with pytest.raises(ValueError, match="mesh 2x1 != world size 1"):
        create_mesh(2, 1)
    with pytest.raises(ValueError):
        jax_mesh.create_mesh(2, 1, jax.devices()[:1])


def test_context_holds_the_mesh():
    assert context.get_mesh() is None or context.model_parallel_size() >= 1
    outer = context.get_mesh()
    mesh = create_mesh(1, 4, world=4)
    with context.use_mesh(mesh) as m:
        assert m is mesh and context.get_mesh() is mesh
        assert context.model_parallel_size() == 4
    assert context.get_mesh() is outer


@pytest.mark.parametrize("model", ["rank.deepfm", "rank.dnn"])
@pytest.mark.parametrize("sparse", [False, True])
def test_param_spec_as_jax(model, sparse):
    """Each leaf of DeepFM's and dnn's trees (a sparse run's
    ``embedding_delta`` among them) gets the JAX rule's decision, at every
    mp from 1 to 4 (12,501 table rows: sharded only where mp divides)."""
    flat = {"runner.model": model, "hyper_parameters.sparse_feature_number": 100001,
            "hyper_parameters.sparse_feature_dim": 9,
            "hyper_parameters.fc_sizes": [32, 16],
            "hyper_parameters.sparse_update": sparse}
    jax_def = jax_load_model_def(JaxConfig(dict(flat)))
    jax_params = jax_def.init_params(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    module = load_model_def(Config(dict(flat))).make_module(device="cpu")
    port_leaves = flatten_tree(to_jax_params(module.state_dict(),
                                             delta_capacity=64 if sparse else None))
    names = {"/".join(str(getattr(k, "key", k)) for k in path) for path, _ in leaves}
    assert names == set(port_leaves)
    for mp in (1, 2, 3, 4):
        specs = sharding.param_specs(port_leaves, mp)
        for path, leaf in leaves:
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            want = tuple(jax_sharding.param_spec(path, leaf, mp))
            assert specs[name] == want, (name, mp)
            assert sharding.param_spec(path, leaf, mp) == want
        sharded = [n for n, s in specs.items() if s]
        assert sharded == (["embedding/embedding"] if mp == 3 else [])


def test_rows_cut_and_joined():
    table = torch.arange(24.0).reshape(6, 4)
    parts = [sharding.local_rows(table, j, 3) for j in range(3)]
    assert all(p.shape == (2, 4) for p in parts)
    assert torch.equal(sharding.join_rows(parts), table)
    with pytest.raises(ValueError, match="do not split"):
        sharding.local_rows(table, 0, 4)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("flat,world,outcome", [
    ({"runner.sync_mode": "geo"}, 1, "plain sync"),
    ({"runner.sync_mode": "fl"}, 1, ValueError),
    ({"runner.sync_mode": "geo"}, 2, NotImplementedError),
    ({"runner.sync_mode": "fl"}, 2, NotImplementedError),
    ({"hyper_parameters.distributed_embedding": 1}, 1, (1, 1)),
    ({"runner.mesh_mp": -1, "runner.mesh_dp": 1}, 1, (1, 1)),
    ({"runner.mesh_mp": 2}, 1, NotImplementedError),
    ({"runner.mesh_dp": 2}, 2, NotImplementedError),
    ({"hyper_parameters.distributed_embedding": 1}, 2, NotImplementedError),
    ({}, 2, NotImplementedError),
])
def test_check_ported_at_one_process_and_across(flat, world, outcome):
    """At one process the reference's rules: geo trains as plain sync (one
    log line), fl raises its ValueError, a 1×1 mesh is accepted; dp or mp
    above 1, and geo or fl across processes, still raise."""
    cfg = Config({"runner.model": "rank.dnn", **flat})
    if isinstance(outcome, type):
        with pytest.raises(outcome):
            port_trainer_mod.check_ported(cfg, world)
        return
    handler = _Capture()
    port_trainer_mod.logger.addHandler(handler)
    try:
        mesh = port_trainer_mod.check_ported(cfg, world)
    finally:
        port_trainer_mod.logger.removeHandler(handler)
    assert (mesh.dp, mesh.mp) == (1, 1)
    geo_lines = [x for x in handler.lines if "sync_mode: geo" in x]
    assert len(geo_lines) == (outcome == "plain sync")


def test_launch_spawns_ranked_processes(tmp_path):
    """Each rank gets the torch.distributed variables, the backend (nccl
    unless asked otherwise) and the reference's role variables."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, sys\n"
        "keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT',\n"
        "        'PADDLEREC_DIST_BACKEND', 'PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM',\n"
        "        'TRAINING_ROLE')\n"
        "open(os.path.join(sys.argv[1], os.environ['RANK']), 'w').write(\n"
        "    ' '.join(os.environ[k] for k in keys))\n"
    )
    rc = port_launch.launch(3, [sys.executable, str(script), str(tmp_path)], port=12399)
    assert rc == 0
    for r in range(3):
        vals = (tmp_path / str(r)).read_text().split()
        assert vals == [str(r), "3", str(r), "127.0.0.1", "12399", "nccl", str(r), "3",
                        "TRAINER"]
    assert not any(k.startswith(("JAX_", "XLA_")) for k in vals)


def test_launch_cli_requires_command():
    r = subprocess.run(
        [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=60,
    )
    assert r.returncode != 0
    assert "no command" in r.stderr


def test_launch_returns_a_failed_rank_and_stops_the_rest(tmp_path):
    """Rank 1 exits 3 at once; rank 0 would wait forever (as in a
    collective): the launcher returns 3 and stops it."""
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(600)\n"
    )
    assert port_launch.launch(2, [sys.executable, str(script)], timeout=60) == 3


def test_launch_two_gloo_ranks_all_reduce(tmp_path):
    """Two launched processes join one gloo group through ``init_from_env``
    and agree on an all_reduce."""
    script = tmp_path / "ar.py"
    script.write_text(
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "import torch, torch.distributed as dist\n"
        "from paddlerec_tpu_torch.tools.launch import init_from_env\n"
        "init_from_env(timeout_s=60)\n"
        "x = torch.ones(2) * (dist.get_rank() + 1)\n"
        "dist.all_reduce(x)\n"
        "assert x.tolist() == [3.0, 3.0], x\n"
        "dist.destroy_process_group()\n"
    )
    assert port_launch.main(["--nproc", "2", "--backend", "gloo", "--",
                             sys.executable, str(script)]) == 0


def _pod(phase, ip, name, deleting=False):
    return SimpleNamespace(
        status=SimpleNamespace(phase=phase, pod_ip=ip),
        metadata=SimpleNamespace(name=name, deletion_timestamp=1 if deleting else None))


class _FakeApi:
    def __init__(self, pods):
        self.pods = pods
        self.calls = []

    def list_namespaced_pod(self, namespace, label_selector):
        self.calls.append((namespace, label_selector))
        return SimpleNamespace(items=self.pods)


def test_k8s_with_a_fake_api(monkeypatch):
    api = _FakeApi([_pod("Running", "10.0.0.9", "w1"), _pod("Running", "10.0.0.2", "w0"),
                    _pod("Pending", "10.0.0.5", "w2"),
                    _pod("Running", "10.0.0.7", "w3", deleting=True)])
    monkeypatch.setattr(k8s, "_api", lambda: api)
    monkeypatch.setenv("NAMESPACE", "rec")
    for var in ("PADDLEREC_POD_IPS", "PADDLE_TRAINER_ID", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert k8s.fetch_pods_info("app=rec") == [
        ("Running", "10.0.0.9", "w1"), ("Running", "10.0.0.2", "w0"),
        ("Pending", "10.0.0.5", "w2"), ("Terminating", "10.0.0.7", "w3")]
    assert api.calls[-1] == ("rec", "app=rec")
    assert k8s.count_pods_by_phase("app=rec", "Running") == 2
    assert k8s.pod_ips("app=rec") == ["10.0.0.2", "10.0.0.9"]
    monkeypatch.setenv("POD_IP", "10.0.0.9")
    assert k8s.my_rank("app=rec") == 1
    monkeypatch.setenv("POD_IP", "10.9.9.9")
    assert k8s.my_rank("app=rec") == 0
    k8s.wait_pods_running("app=rec", 2, poll_s=0)
    monkeypatch.setenv("PADDLEREC_POD_IPS", "10.1.0.3,10.1.0.1")
    assert k8s.pod_ips() == ["10.1.0.1", "10.1.0.3"]
    monkeypatch.setenv("RANK", "5")
    assert k8s.my_rank() == 5


def test_k8s_without_the_client(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_kubernetes(name, *args, **kwargs):
        if name.startswith("kubernetes"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_kubernetes)
    with pytest.raises(RuntimeError, match="kubernetes client not installed"):
        k8s.fetch_pods_info("app=rec")
