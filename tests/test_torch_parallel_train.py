"""The port's trainer on a ``(dp, mp)`` mesh of gloo ranks on the CPU against
the JAX ``Trainer`` on the same mesh of the 8-device CPU platform
(``tests/conftest.py``): DeepFM with Adam, from the JAX trainer's initial
parameters (``convert.from_jax_params``, cut by ``local_rows``), the JAX step
fed the global batch and the port's dp row i its rows ``[i·B/dp,
(i+1)·B/dp)``.  Also the engine's overflow count and its error, the train
loop over uneven file shards, a checkpoint saved on the mesh and resumed,
and ``init_from_env``'s device.  One launch of dp·mp ranks a mesh
(``tests/test_torch_mesh_worker.py``), shared by the module's tests."""

import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.parallel import embedding as jax_emb
from paddlerec_tpu.parallel import context as jax_context
from paddlerec_tpu.parallel import mesh as jax_mesh
from paddlerec_tpu.parallel import sharding as jax_sharding
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch.convert import (
    adam_state_from_optax, from_jax_params, from_jax_sparse_state,
)
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.tools import launch as port_launch
from tests.test_torch_mesh_worker import Launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (1, 2), (2, 2)]
MIN_ROWS = 64  # MIN_ROWS_TO_SHARD in both packages, as tests/test_distributed_train.py
VOCAB, BATCH, STEPS = 16384, 16, 3  # the global batch: BATCH // dp rows a dp row
FLAT = {
    "runner.model": "rank.deepfm", "runner.seed": 0, "runner.print_interval": 2,
    "hyper_parameters.sparse_inputs_slots": 27, "hyper_parameters.dense_input_dim": 13,
    "hyper_parameters.sparse_feature_number": VOCAB, "hyper_parameters.sparse_feature_dim": 9,
    "hyper_parameters.fc_sizes": [32, 16],
    "hyper_parameters.optimizer.class": "Adam",
    "hyper_parameters.optimizer.learning_rate": 0.001,
}
# each mesh's config: at (1,2) with a global-norm clip small enough to bind,
# so that the dense optimizer's clip sums the shards' squares over the row
FLATS = {(2, 1): FLAT, (1, 2): {**FLAT, "hyper_parameters.clip_by_norm": 0.05},
         (2, 2): FLAT}
# the overflow job: dnn at width 64 (pack 2: 8,192 rows, 4,096 a shard at
# mp = 2) under ids that all fall in shard 0's rows, as the skewed ids of
# tests/test_distributed_train.py fall in the first shard: more distinct rows
# than a bucket holds
OVERFLOW = {**FLAT, "runner.model": "rank.dnn", "hyper_parameters.sparse_feature_dim": 64,
            "runner.overflow_raise_after": 2}
OVERFLOW_BATCH = 64
# the sparse step on the dp-only mesh (2,1): the table whole on every rank,
# stepped by row-wise Adam over the global batch's unique rows
SPARSE = {**FLAT, "hyper_parameters.sparse_update": True,
          "hyper_parameters.optimizer.learning_rate": 0.01}
# f32 sums in another order (JAX's global batch against the port's dp rows
# added by an all_reduce), kept by Adam's m / sqrt(v) as a relative error:
# the tolerances of tests/test_torch_train.py's twenty one-device steps.
# Measured over the three meshes after three steps: loss 1.2e-7, dense
# leaves 6.0e-8, table 4.7e-7 (at (1,2), under the clip), first moment
# 3.7e-9, second 7.3e-12.
LOSS_ATOL, PARAM_ATOL, MU_ATOL, NU_ATOL = 1e-5, 1e-5, 1e-6, 1e-7


def _batches(seed, steps, rows, ids_hi=3 * VOCAB):
    """Ids beyond the vocab (hashed), a planted signal, a few masked rows;
    the second batch masks half of dp row 0's rows (of any dp)."""
    rng = np.random.RandomState(seed)
    weight = rng.randn(ids_hi)
    out = []
    for step in range(steps):
        sparse = rng.randint(0, ids_hi, (rows, 26)).astype(np.int64)
        dense = rng.rand(rows, 13).astype(np.float32)
        score = weight[sparse].mean(axis=1) * 6 + dense.mean(axis=1) - 0.5
        label = (rng.rand(rows) < 1 / (1 + np.exp(-score))).astype(np.float32)
        mask = (rng.rand(rows) < 0.95).astype(np.float32)
        if step == 1:
            mask[:rows // 4] = 0.0
        out.append({"label": label, "sparse": sparse, "dense": dense, "mask": mask})
    return out


def _jax_trainer(flat, dp, mp, batch, init=True):
    cfg = JaxConfig({**flat, "runner.train_batch_size": batch})
    mesh = jax_mesh.create_mesh(dp, mp, jax.devices()[:dp * mp])
    trainer = jax_trainer_mod.Trainer(cfg, mesh=mesh)
    if init:
        trainer.init_state()
    return trainer


def _host_params(trainer):
    return from_jax_params(jax.tree.map(np.asarray, jax.device_get(trainer.state.params)))


def _skewed(dp, mp):
    """Ids that all fall in shard 0's rows (pack 2: 4,096 physical rows a
    shard at mp = 2, 2,048 at mp = 4)."""
    rows_local = -(-VOCAB // 2) // mp
    rng = np.random.RandomState(7)
    return {"label": np.zeros(OVERFLOW_BATCH, np.float32),
            "sparse": rng.randint(0, rows_local * 2, (OVERFLOW_BATCH, 26)),
            "dense": np.zeros((OVERFLOW_BATCH, 13), np.float32),
            "mask": np.ones(OVERFLOW_BATCH, np.float32)}


def _jobs(dp, mp, tmp, params0, batches, sparse_params0=None):
    """The port's jobs of a mesh (``tests/test_torch_mesh_worker.py``)."""
    mesh_keys = {"runner.train_batch_size": BATCH // dp, "runner.mesh_dp": dp,
                 "runner.mesh_mp": mp}
    jobs = [{"name": "dense", "kind": "steps", "config": {**FLATS[dp, mp], **mesh_keys},
             "params": params0, "batches": batches}]
    if (dp, mp) == (2, 2):
        jobs.append(dict(jobs[0], name="double", double_sum=True))
        # three files: dp row 0 reads two, row 1 one (uneven shards)
        data = tmp / "data"
        write_criteo_sample(str(data), num_lines=3 * 40, num_files=3, vocab=VOCAB, seed=3)
        jobs.append({"name": "train", "kind": "train", "next_batch": _batches(9, 1, BATCH)[0],
                     "config": {**FLAT, **mesh_keys, "runner.train_data_dir": str(data),
                                "runner.epochs": 1,
                                "runner.model_save_path": str(tmp / "ckpt")}})
    if (dp, mp) == (2, 1):
        jobs.append({"name": "sparse", "kind": "steps", "config": {**SPARSE, **mesh_keys},
                     "params": sparse_params0, "batches": batches, "global_dedup": True})
    if mp > 1:
        jobs.append({"name": "overflow", "kind": "overflow", "batch": _skewed(dp, mp),
                     "config": {**OVERFLOW, "runner.mesh_dp": dp, "runner.mesh_mp": mp,
                                "runner.train_batch_size": OVERFLOW_BATCH // dp}})
    return jobs


def _jax_steps(ref, batches, dp, mp):
    """The JAX trainer's steps on the global batches; and at mp > 1 the
    JAX engine's dropped ids on the skewed batch (the count the JAX
    trainer's step sows: the sum over devices) and ``_check_overflow``'s
    error after two growing checks."""
    jax_context.set_mesh(ref.mesh)  # the mesh the JAX layers trace with
    step = ref._build_train_step()
    ms = ref._init_metric_state()
    losses = []
    for b in batches:
        ref.state, ms, loss = step(ref.state, jax.device_put(b, ref.batch_sharding), ms)
        losses.append(float(loss))
    case = {"losses": losses, "params": _host_params(ref), "metric_state": jax.device_get(ms),
            "adam": adam_state_from_optax(jax.device_get(ref.state.opt_state)),
            "metrics": ref._compute_metrics(ms)}
    if mp > 1:
        eng = jax_emb.ShardedEmbedding(ref.mesh, VOCAB, 64)
        table = eng.init(jax.random.PRNGKey(0))
        _, dropped = jax.jit(eng.lookup_with_overflow)(
            table, jnp.asarray(_skewed(dp, mp)["sparse"], jnp.int32))
        case["overflow"] = int(np.asarray(dropped).sum())
        checker = _jax_trainer(OVERFLOW, dp, mp, OVERFLOW_BATCH, init=False)
        checker._overflow_seen = 0
        checker._check_overflow({"embedding_overflow": np.int32(case["overflow"])})
        with pytest.raises(RuntimeError) as err:
            checker._check_overflow({"embedding_overflow": np.int32(2 * case["overflow"])})
        case["overflow_error"] = str(err.value)
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's JAX case and its ranks' results: the launches of dp·mp
    gloo ranks start first and run while the JAX steps compile."""
    old = jax_sharding.MIN_ROWS_TO_SHARD
    jax_sharding.MIN_ROWS_TO_SHARD = MIN_ROWS
    try:
        started = {}
        sparse_ref = _jax_trainer(SPARSE, 2, 1, BATCH)
        sparse_params0 = _host_params(sparse_ref)
        for dp, mp in MESHES:
            tmp = tmp_path_factory.mktemp(f"mesh_{dp}x{mp}")
            ref = _jax_trainer(FLATS[dp, mp], dp, mp, BATCH)
            batches = _batches(dp * 10 + mp, STEPS, BATCH)
            jobs = _jobs(dp, mp, tmp, _host_params(ref), batches, sparse_params0)
            torch.save({"min_rows": MIN_ROWS, "jobs": jobs}, tmp / "case.pt")
            started[dp, mp] = (ref, batches, tmp, Launch(tmp, dp * mp))
        out = {}
        for (dp, mp), (ref, batches, tmp, launch) in started.items():
            case = _jax_steps(ref, batches, dp, mp)
            case["ckpt"] = str(tmp / "ckpt")
            if (dp, mp) == (2, 1):
                case["sparse"] = _jax_steps(sparse_ref, batches, dp, mp)
                case["sparse"]["params0"] = sparse_params0
                case["sparse"]["extra"] = from_jax_sparse_state(
                    jax.device_get(sparse_ref.state.extra))
            out[dp, mp] = (dp, mp, case, launch.ranks())
        return out
    finally:
        jax_sharding.MIN_ROWS_TO_SHARD = old


@pytest.fixture(params=MESHES, ids=lambda m: f"dp{m[0]}_mp{m[1]}")
def mesh_run(request, runs):
    return runs[request.param]


@pytest.fixture(params=[m for m in MESHES if m[1] > 1], ids=lambda m: f"dp{m[0]}_mp{m[1]}")
def mp_run(request, runs):
    return runs[request.param]


def _joined(ranks, mp, name, pick):
    """A tensor of the mesh whole: dp row 0's shards joined in mp order
    where it is sharded, rank 0's otherwise."""
    if name in ranks[0]["dense"]["sharded"]:
        return torch.cat([pick(ranks[j]) for j in range(mp)])
    return pick(ranks[0])


def test_dense_step_matches_jax(mesh_run):
    """Loss, every dense leaf, the joined table and its Adam moments after
    three steps (one with half of dp row 0's rows masked; at (1,2) under a
    global-norm clip that binds, the norm taken over the whole table)."""
    dp, mp, case, ranks = mesh_run
    for out in ranks:
        np.testing.assert_allclose(out["dense"]["losses"], case["losses"], rtol=0,
                                   atol=LOSS_ATOL)
    final = ranks[0]["dense"]["states"][-1]
    assert sorted(final) == sorted(case["params"])
    assert ranks[0]["dense"]["sharded"] == (["embedding.embedding"] if mp > 1 else [])
    for k, want in case["params"].items():
        got = _joined(ranks, mp, k, lambda o: o["dense"]["states"][-1][k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        for moment, atol in (("mu", MU_ATOL), ("nu", NU_ATOL)):
            got = _joined(ranks, mp, k, lambda o: o["dense"]["opt_state"][moment][k])
            np.testing.assert_allclose(got.numpy(), case["adam"][moment][k].numpy(),
                                       rtol=0, atol=atol, err_msg=f"{moment} {k}")
    assert ranks[0]["dense"]["opt_state"]["count"] == STEPS


def test_replicas_are_bitwise_equal_after_every_step(mesh_run):
    """Every rank of a shard's column holds the same bits of it, and every
    rank the same dense leaves, after each step."""
    dp, mp, case, ranks = mesh_run
    sharded = set(ranks[0]["dense"]["sharded"])
    for step in range(STEPS):
        for r, out in enumerate(ranks):
            peer = ranks[r % mp]  # dp row 0's rank of the same column
            for k, v in out["dense"]["states"][step].items():
                ref = (peer if k in sharded else ranks[0])["dense"]["states"][step][k]
                assert torch.equal(v, ref), (step, r, k)


def test_a_second_dense_sum_would_show(runs):
    """The dense dp sum skips the mp-sharded table, whose engine backward
    sums it over dp already.  The same ranks, told that the table is not
    sharded (so it joins the dense sum), step it with a doubled gradient:
    its Adam moments come out twice and four times JAX's, far outside the
    tolerance that the real step keeps."""
    dp, mp, case, ranks = runs[2, 2]  # dp > 1 and a sharded table
    real = _joined(ranks, mp, "embedding.embedding",
                   lambda o: o["dense"]["opt_state"]["mu"]["embedding.embedding"])
    double = torch.cat([ranks[j]["double"]["opt_state"]["mu"]["embedding.embedding"]
                        for j in range(mp)])
    want = case["adam"]["mu"]["embedding.embedding"]
    big = want.abs() > 1e-4
    assert int(big.sum()) > 100
    np.testing.assert_allclose(real.numpy(), want.numpy(), rtol=0, atol=MU_ATOL)
    ratio = double[big] / want[big]
    assert float(ratio.median()) == pytest.approx(2.0, rel=1e-3)
    assert float((double - want).abs().max()) > 100 * MU_ATOL


def test_shard_read_by_k1_and_written_by_k1b(mesh_run):
    """Each step of the mesh: one K1 call on the shard (rows_local, 128),
    mode drop, and one K1b call onto it; nothing else touches the shard."""
    dp, mp, case, ranks = mesh_run
    for out in ranks:
        for calls in out["dense"]["calls"]:
            if mp == 1:
                assert calls == []
                continue
            rows_local = out["dense"]["states"][0]["embedding.embedding"].shape[0]
            assert [c[0] for c in calls] == ["k1", "k1b"], calls
            assert calls[0][1] == (rows_local, 128) and calls[0][3] == "drop"
            assert calls[1][3] == "drop" and calls[1][2] == calls[0][2]


def test_metrics_are_the_dp_sums(mesh_run):
    """Each rank's AUC state counts its dp row; read, it is the mesh's: the
    dp sum, the JAX trainer's global counts.  A prediction 1e-7 from JAX's
    may fall into the next of 4,096 buckets: the bucket counts are held to
    the same totals and to at most 2 moved counts."""
    dp, mp, case, ranks = mesh_run
    rows = [ranks[i * mp]["dense"]["metric_state"]["auc"] for i in range(dp)]
    for out in ranks:
        glob = out["dense"]["global_metric_state"]["auc"]
        for k in ("stat_pos", "stat_neg"):
            assert torch.equal(glob[k], sum(r[k] for r in rows))
            want = torch.from_numpy(np.array(case["metric_state"]["auc"][k]))
            assert int(glob[k].sum()) == int(want.sum())
            assert int((glob[k] - want).abs().sum()) <= 2
        assert out["dense"]["metrics"]["total_ins"] == case["metrics"]["total_ins"]
        assert out["dense"]["metrics"]["auc"] == pytest.approx(case["metrics"]["auc"],
                                                               abs=2e-3)


def test_overflow_count_and_error_match_jax(mp_run):
    """The skewed ids overflow a bucket: the mesh's count (each rank's
    summed over the world) is the JAX trainer's, and the second growing
    check raises the reference's RuntimeError."""
    dp, mp, case, ranks = mp_run
    for out in ranks:
        o = out["overflow"]
        assert o["has_counter"]
        assert o["total"] == case["overflow"] > 0
        assert o["strikes"] == 1
        assert o["error"] == case["overflow_error"]
        assert o["metrics_total"] == 2 * case["overflow"]
    assert sum(out["overflow"]["local"] for out in ranks) == case["overflow"]


def test_train_over_uneven_shards_and_resume(runs):
    """``Trainer.train()`` at (2,2) over three files (dp row 0 reads two,
    row 1 one): the ranks stop together, the replicas are bitwise equal,
    the metrics are the dp sums; the checkpoint holds the padded table
    whole, and a trainer resumed from it holds every rank's state bitwise
    and takes the same next step."""
    dp, mp, case, ranks = runs[2, 2]
    steps = {out["train"]["steps"] for out in ranks}
    assert steps == {40 // (BATCH // dp)}  # row 1's one file: 40 rows
    for out in ranks:
        t = out["train"]
        assert t["metrics"]["total_ins"] == 40 * dp
        assert t["saved"] == ["0", "donefile.txt"]
        for k, v in t["state"].items():
            assert torch.equal(v, t["resumed_state"][k]), k
        for moment in ("mu", "nu"):
            for k, v in t["opt_state"][moment].items():
                assert torch.equal(v, t["resumed_opt_state"][moment][k]), (moment, k)
        assert t["next_loss"] == t["resumed_next_loss"]
        for k, v in t["next_state"].items():
            assert torch.equal(v, t["resumed_next_state"][k]), k
    for r, out in enumerate(ranks):
        peer = ranks[r % mp]["train"]["state"]
        for k, v in out["train"]["state"].items():
            assert torch.equal(v, peer[k]), (r, k)
    saved = torch.load(os.path.join(case["ckpt"], "0", "state", "checkpoint.pt"),
                       weights_only=True)
    whole = torch.cat([ranks[j]["train"]["state"]["embedding.embedding"] for j in range(mp)])
    assert torch.equal(saved["params"]["embedding.embedding"], whole)
    assert whole.shape == (-(-VOCAB // 8), 128)


def test_sparse_step_on_a_dp_mesh_matches_jax(runs):
    """At (2,1) the table is whole on every rank and the row-wise Adam step
    merges each dp row's positions into the global batch's unique rows and
    adds them over dp: loss, dense leaves, table and row state match the
    JAX trainer's step of the global batch (the tolerances of the dense
    step; measured: loss 6.0e-8, table 6.0e-7, m 2.5e-9, v 6.8e-13), and
    both ranks hold the same bits."""
    dp, mp, case, ranks = runs[2, 1]
    want = case["sparse"]
    for out in ranks:
        got = out["sparse"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["states"][-1][k].numpy(), v.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
        key = "embedding/embedding_delta"
        for f, v in want["extra"][key]._asdict().items():
            np.testing.assert_allclose(got["extra"][key][f].numpy(), v.numpy(), rtol=0,
                                       atol=MU_ATOL, err_msg=f)
        assert [c[0] for c in got["calls"][0]] == ["merge"]
        for k, v in got["states"][-1].items():
            assert torch.equal(v, ranks[0]["sparse"]["states"][-1][k]), k
    start = want["params0"]["embedding.embedding"]
    assert int((want["params"]["embedding.embedding"] != start).any(dim=1).sum()) > 100


def test_init_from_env_takes_the_device_from_the_caller(monkeypatch):
    """The device is the caller's, not the backend's: the card by default
    (which raises without one, before any group is joined), the CPU when
    asked for."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv(port_launch.BACKEND_VAR, "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_launch.init_from_env()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_launch.init_from_env("cuda")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port_launch.free_port()))
    try:
        assert port_launch.init_from_env("cpu", timeout_s=30) == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()
