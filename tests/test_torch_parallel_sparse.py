"""The port's sparse (row-wise) step on a ``(dp, mp)`` mesh of gloo ranks on
the CPU against the JAX ``Trainer`` on the same mesh of the 8-device CPU
platform: DeepFM with ``sparse_update``, its table row-sharded over mp and
stepped by the sharded rules (``apply_sparse_*_sharded``) over the global
batch's unique rows (``global_dedup_arrays``).  At (2,2) row-wise adagrad
and Adam in float32; at (1,2) the bfloat16 table of ``config_bigdata.yaml``
with stochastic rounding, also against the port's own one-device step.
Then the CLI under the launcher at (2,1) (the feed's global dedup in the
main thread), and the refusals across processes (the host-table loop's
ValueError, the online loop's NotImplementedError of ``use_host_table``).  One launch of dp·mp
ranks a mesh (``tests/test_torch_mesh_worker.py``)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import load_model_def as jax_load_model_def
from paddlerec_tpu.parallel import context as jax_context
from paddlerec_tpu.parallel import mesh as jax_mesh
from paddlerec_tpu.parallel import sharding as jax_sharding
from paddlerec_tpu.train import host_loop as jax_host_loop
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch.convert import from_jax_params, from_jax_sparse_state
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.train import host_loop as port_host_loop
from paddlerec_tpu_torch.train import online as port_online
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_host_loop import _config as host_config
from tests.test_torch_mesh_worker import Launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_ROWS = 64
VOCAB, BATCH, STEPS = 16384, 16, 3
FLAT = {
    "runner.model": "rank.deepfm", "runner.seed": 0, "runner.print_interval": 2,
    "hyper_parameters.sparse_inputs_slots": 27, "hyper_parameters.dense_input_dim": 13,
    "hyper_parameters.sparse_feature_number": VOCAB, "hyper_parameters.sparse_feature_dim": 9,
    "hyper_parameters.fc_sizes": [32, 16],
    "hyper_parameters.optimizer.class": "Adam",
    "hyper_parameters.optimizer.learning_rate": 0.01,
    "hyper_parameters.sparse_update": True,
}
RULES = {
    "adagrad": {"hyper_parameters.sparse_update_rule": "adagrad"},
    "adam": {"hyper_parameters.sparse_update_rule": "adam"},
    # config_bigdata.yaml's table and rule
    "bf16_sr": {"hyper_parameters.sparse_update_rule": "adagrad",
                "hyper_parameters.sparse_feature_dtype": "bfloat16",
                "hyper_parameters.sparse_update_stochastic_round": True},
}
MESH_JOBS = {(2, 2): ("adagrad", "adam"), (1, 2): ("bf16_sr",)}
# float32 sums in another order (JAX's global batch against the port's dp
# rows merged per unique row and added over dp): loss 1e-5 and dense leaves
# 1e-5 as tests/test_torch_train.py; the table's touched rows and their row
# state are relative to the step (lr 0.01).  Measured after three steps:
# loss 6.0e-8, dense 4.8e-6 (tower.fc_0, which Adam moves by lr 0.01 a
# step), table 2.3e-7, acc 1.1e-11, m 4.3e-9, v 1.5e-11.
LOSS_ATOL, PARAM_ATOL, TABLE_ATOL, STATE_ATOL = 1e-5, 1e-5, 1e-6, 1e-8
# bfloat16 with stochastic rounding: the two packages draw other noise, so a
# written element may land on the other neighbour of its float32 value, and
# the steps after read other rows: the loss is held to 2e-4, the float32
# leaves to a tenth of an Adam step (lr 0.01), the accumulator to 1e-5, and
# the table as tests/test_torch_train.py holds a bf16 table: a bound on every
# element (a fifth of an lr step) and on the share beyond smaller gaps (about
# a fifth of the elements are in touched rows: a wrong step would move most
# of them).  Measured: loss 4.0e-5, dense 2.7e-4 (tower.fc_0, which reads the
# rows), acc 9.4e-7, table 9.8e-4 (one bf16 step of a value near 0.2), 1.26%
# of the elements beyond 1e-5 and 0.37% beyond 1e-4.  The port's own
# one-device step draws the same noise: there the bits are equal
# (test_bf16_rounding_noise_is_the_one_device_steps).
BF16 = {"loss": 2e-4, "dense": 1e-3, "acc": 1e-5, "table": 2e-3,
        "share_beyond": {1e-5: 4e-2, 1e-4: 1e-2}}


def _batches(seed, steps, rows, ids_hi=3 * VOCAB):
    rng = np.random.RandomState(seed)
    weight = rng.randn(ids_hi)
    out = []
    for step in range(steps):
        sparse = rng.randint(0, ids_hi, (rows, 26)).astype(np.int64)
        sparse[:4, :3] = 17  # a hot id in every dp row
        dense = rng.rand(rows, 13).astype(np.float32)
        score = weight[sparse].mean(axis=1) * 6 + dense.mean(axis=1) - 0.5
        label = (rng.rand(rows) < 1 / (1 + np.exp(-score))).astype(np.float32)
        mask = (rng.rand(rows) < 0.95).astype(np.float32)
        if step == 1:
            mask[:rows // 4] = 0.0
        out.append({"label": label, "sparse": sparse, "dense": dense, "mask": mask})
    return out


def _jax_trainer(flat, dp, mp):
    mesh = jax_mesh.create_mesh(dp, mp, jax.devices()[:dp * mp])
    trainer = jax_trainer_mod.Trainer(JaxConfig({**flat, "runner.train_batch_size": BATCH}),
                                      mesh=mesh)
    trainer.init_state()
    return trainer


def _host(trainer):
    return from_jax_params(jax.tree.map(np.asarray, jax.device_get(trainer.state.params)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's JAX cases (one a rule) and its ranks' results; the
    launches start before the JAX steps compile."""
    old = jax_sharding.MIN_ROWS_TO_SHARD
    jax_sharding.MIN_ROWS_TO_SHARD = MIN_ROWS
    try:
        started = {}
        for (dp, mp), rules in MESH_JOBS.items():
            tmp = tmp_path_factory.mktemp(f"sparse_{dp}x{mp}")
            refs, jobs = {}, []
            batches = _batches(dp * 10 + mp, STEPS, BATCH)
            for rule in rules:
                flat = {**FLAT, **RULES[rule]}
                refs[rule] = (_jax_trainer(flat, dp, mp), flat)
                jobs.append({"name": rule, "kind": "steps", "batches": batches,
                             "params": _host(refs[rule][0]),
                             "global_dedup": dp > 1, "augment": dp == 1,
                             "config": {**flat, "runner.train_batch_size": BATCH // dp,
                                        "runner.mesh_dp": dp, "runner.mesh_mp": mp}})
            torch.save({"min_rows": MIN_ROWS, "jobs": jobs}, tmp / "case.pt")
            started[dp, mp] = (refs, batches, Launch(tmp, dp * mp))
        out = {}
        for (dp, mp), (refs, batches, launch) in started.items():
            cases = {}
            for rule, (ref, flat) in refs.items():
                case = {"params0": _host(ref), "flat": flat, "batches": batches}
                jax_context.set_mesh(ref.mesh)  # the mesh the JAX layers trace with
                step = ref._build_train_step()
                ms, losses = ref._init_metric_state(), []
                for b in batches:
                    ref.state, ms, loss = step(ref.state, jax.device_put(b, ref.batch_sharding),
                                               ms)
                    losses.append(float(loss))
                case.update(losses=losses, params=_host(ref),
                            extra=from_jax_sparse_state(jax.device_get(ref.state.extra)),
                            dedup=[ref.model_def.global_dedup_arrays(b) for b in batches])
                cases[rule] = case
            out[dp, mp] = (dp, mp, cases, launch.ranks())
        return out
    finally:
        jax_sharding.MIN_ROWS_TO_SHARD = old


RUNS = [((2, 2), "adagrad"), ((2, 2), "adam"), ((1, 2), "bf16_sr")]


@pytest.fixture(params=RUNS, ids=lambda r: f"dp{r[0][0]}_mp{r[0][1]}_{r[1]}")
def run(request, runs):
    dp, mp, cases, ranks = runs[request.param[0]]
    rule = request.param[1]
    return dp, mp, rule, cases[rule], [out[rule] for out in ranks]


def _joined(ranks, mp, pick):
    return torch.cat([pick(ranks[j]) for j in range(mp)])


def test_global_dedup_matches_jax_bitwise(runs):
    """Every rank of the 2x2 mesh gathers the int32 rows over its dp group
    and gets the JAX package's (uniq, slot) of the global batch, bitwise."""
    dp, mp, cases, ranks = runs[2, 2]
    for rule in MESH_JOBS[2, 2]:
        want = cases[rule]["dedup"]
        for out in ranks:
            got = out[rule]["dedups"]
            assert len(got) == len(want) == STEPS
            for (gu, gs), (wu, ws) in zip(got, want):
                assert gu.dtype == wu.dtype and gs.dtype == ws.dtype
                assert np.array_equal(gu, wu) and np.array_equal(gs, ws)


def test_sparse_step_matches_jax(run):
    """Loss and dense leaves; the table's touched rows and their row state
    after three steps; untouched rows bitwise unchanged."""
    dp, mp, rule, case, ranks = run
    bf16 = rule == "bf16_sr"
    for out in ranks:
        np.testing.assert_allclose(out["losses"], case["losses"], rtol=0,
                                   atol=BF16["loss"] if bf16 else LOSS_ATOL)
    assert ranks[0]["sharded"] == ["embedding.embedding"]
    final = ranks[0]["states"][-1]
    for k, want in case["params"].items():
        if k == "embedding.embedding":
            continue
        np.testing.assert_allclose(final[k].numpy(), want.numpy(), rtol=0,
                                   atol=BF16["dense"] if bf16 else PARAM_ATOL, err_msg=k)
    table = _joined(ranks, mp, lambda o: o["states"][-1]["embedding.embedding"])
    want = case["params"]["embedding.embedding"]
    start = case["params0"]["embedding.embedding"]
    assert table.shape == want.shape and table.dtype == want.dtype
    touched = (want != start).any(dim=1) | (table != start).any(dim=1)
    assert int(touched.sum()) > 100
    assert torch.equal(table[~touched], start[~touched])
    key = "embedding/embedding_delta"
    want_state = case["extra"][key]._asdict()
    got_state = {f: _joined(ranks, mp, lambda o: o["extra"][key][f]) for f in want_state}
    if bf16:
        diff = (table.float() - want.float()).abs()
        assert float(diff.max()) <= BF16["table"]
        for beyond, share in BF16["share_beyond"].items():
            assert float((diff > beyond).float().mean()) <= share, beyond
    else:
        np.testing.assert_allclose(table.numpy(), want.numpy(), rtol=0, atol=TABLE_ATOL)
    for f, w in want_state.items():
        np.testing.assert_allclose(got_state[f].numpy(), w.numpy(), rtol=0,
                                   atol=BF16["acc"] if bf16 else STATE_ATOL, err_msg=f)


def test_sparse_replicas_are_bitwise_equal(run):
    """After every step each rank of a shard's column holds its bits, and
    every rank the same dense leaves."""
    dp, mp, rule, case, ranks = run
    for step in range(STEPS):
        for r, out in enumerate(ranks):
            for k, v in out["states"][step].items():
                peer = ranks[r % mp] if k == "embedding.embedding" else ranks[0]
                assert torch.equal(v, peer["states"][step][k]), (rule, step, r, k)


def test_shard_read_by_k1_and_rows_merged_by_k1b(run):
    """Each step: one K1 call on the shard (mode drop) and one K1b call that
    merges this rank's positions into the global unique rows (128 lanes a
    position: the delta's gradient); the table takes no gradient."""
    dp, mp, rule, case, ranks = run
    n = BATCH // dp * 26
    for out in ranks:
        rows_local = out["states"][0]["embedding.embedding"].shape[0]
        for step, calls in enumerate(out["calls"]):
            assert [c[0] for c in calls] == ["k1", "merge"], calls
            assert calls[0][1] == (rows_local, 128) and calls[0][3] == "drop"
            assert calls[1][1] == (n, 128) and calls[1][2] == (n, 1)


def test_bf16_rounding_noise_is_the_one_device_steps(runs):
    """At (1,2) the bf16 shards draw the stochastic-rounding noise over the
    whole global uniq from the step's generator, as the one-device step
    does: the joined table and accumulator equal the port's own 1×1 run,
    bitwise."""
    dp, mp, cases, ranks = runs[1, 2]
    case = cases["bf16_sr"]
    port = port_trainer_mod.Trainer(Config({**case["flat"], "runner.train_batch_size": BATCH}),
                                     device="cpu")
    port.init_state()
    port.state.module.load_state_dict(case["params0"])
    ms = port._init_metric_state()
    for b in case["batches"]:
        batch = port_trainer_mod._count_uniq(port.model_def.augment_batch_host(b))
        ms, _ = port.train_step(to_tensors(batch, port.device), ms)
    table = _joined([o["bf16_sr"] for o in ranks], mp,
                    lambda o: o["states"][-1]["embedding.embedding"])
    assert torch.equal(table, port.state.module.state_dict()["embedding.embedding"])
    acc = _joined([o["bf16_sr"] for o in ranks], mp,
                  lambda o: o["extra"]["embedding/embedding_delta"]["acc"])
    assert torch.equal(acc, port.state.extra["embedding/embedding_delta"].acc)


def test_cli_trains_sparse_on_a_dp_mesh_under_the_launcher(tmp_path):
    """``tools.launch --backend gloo -- tools.train ... --device cpu`` at
    ``runner.mesh_dp=2`` with ``sparse_update``: the launcher passes
    ``--device`` through, each rank joins the group on the CPU, the feed's
    main thread adds the global dedup, and rank 0 alone logs and writes the
    checkpoint (row state included) and the donefile."""
    data = tmp_path / "data"
    write_criteo_sample(str(data), num_lines=96, num_files=3, vocab=VOCAB, seed=1)
    overrides = [f"runner.train_data_dir={data}", f"runner.model_save_path={tmp_path / 'out'}",
                 "runner.mesh_dp=2", "runner.train_batch_size=16", "runner.print_interval=1",
                 "runner.wire_format=compact",
                 f"hyper_parameters.sparse_feature_number={VOCAB}",
                 "hyper_parameters.fc_sizes=[32,16]", "hyper_parameters.sparse_update=true",
                 "hyper_parameters.sparse_update_rule=adagrad"]
    script = (f"import sys; sys.path.insert(0, {REPO!r})\n"
              "from paddlerec_tpu_torch.tools import train\n"
              "train.main(sys.argv[1:])\n")
    cmd = [sys.executable, "-c", script, "-m",
           os.path.join(REPO, "configs", "rank", "deepfm", "config.yaml"),
           "--device", "cpu", "-o", *overrides]
    r = subprocess.run([sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc",
                        "2", "--backend", "gloo", "--", *cmd], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("training finished") == 1  # rank 0 alone logs
    # dp row 0 reads two files, row 1 one: both stop after row 1's 2 steps
    assert r.stderr.count("epoch: 0, batch_id:") == 2
    state = torch.load(tmp_path / "out" / "0" / "state" / "checkpoint.pt", weights_only=True)
    acc = state["extra"]["embedding/embedding_delta"]["acc"]
    assert acc.shape == (-(-VOCAB // 8),) and int((acc > 0).sum()) > 100
    assert (tmp_path / "out" / "donefile.txt").read_text().count("\n") == 1


def test_loops_across_processes_refuse(monkeypatch, tmp_path):
    """More than one process: the host-table loop raises the JAX package's
    ValueError, word for word, and the online loop, which runs across
    processes, still refuses ``use_host_table`` (fault 8) there."""
    monkeypatch.setattr(jax_host_loop.jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as want:
        jax_host_loop.HostTableTrainer(host_config(tmp_path))
    monkeypatch.setattr(port_host_loop, "world_size", lambda: 2)
    with pytest.raises(ValueError) as got:
        port_host_loop.HostTableTrainer(Config(host_config(tmp_path).to_dict()), device="cpu")
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(port_trainer_mod, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="use_host_table"):
        port_online.OnlineTrainer(Config({**FLAT, "runner.days": "20240101",
                                          "runner.use_host_table": True}), device="cpu")


def test_jax_dedup_reference_is_the_global_unique():
    """The JAX function the ranks are held to, at one process, is the
    unique of the global batch's physical rows (process-major order)."""
    md = jax_load_model_def(JaxConfig(dict(FLAT)))
    b = _batches(0, 1, BATCH)[0]
    uniq, slot = md.global_dedup_arrays(b)
    phys = (b["sparse"].reshape(-1) % VOCAB) // 8
    vals = np.unique(phys)
    assert np.array_equal(uniq[:len(vals)], vals) and np.array_equal(vals[slot], phys)


def test_slot_embedding_takes_the_engine_as_the_jax_module():
    """The decision of the JAX ``SlotEmbedding._use_distributed``: no mesh, or
    a 1×1 mesh with the auto default, keeps the local table; ``distributed
    =True`` with a mesh takes the engine (here mp = 1, no process group: the
    exchanges are the identity) and its shard holds the one-device table's
    values from the same generator, so both paths look up the same bits;
    below ``MIN_ROWS_TO_SHARD`` packed rows ``distributed=True`` falls back to
    the local table with one warning per geometry.  Multi-hot bags pool to
    the local path's sums within 1e-6 (f32 sums of 3 rows in another
    order)."""
    import logging

    from paddlerec_tpu_torch.ops import embedding as port_embedding
    from paddlerec_tpu_torch.parallel import context, sharding
    from paddlerec_tpu_torch.parallel.mesh import create_mesh

    def build(vocab, **kw):
        return port_embedding.SlotEmbedding(
            vocab, 9, generator=torch.Generator().manual_seed(3), device="cpu", **kw)

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 300000, (8, 26)))
    local = build(100000)
    assert local.engine is None and local.embedding.shape == (12500, 128)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    port_embedding.logger.addHandler(handler)
    try:
        with context.use_mesh(create_mesh(1, 1)):
            assert build(100000).engine is None
            sharded = build(100000, distributed=True)
            small = [build(4000, distributed=True) for _ in range(2)]
    finally:
        port_embedding.logger.removeHandler(handler)
    assert sharded.engine is not None and sharded.embedding.shape == (12500, 128)
    assert torch.equal(sharded(ids), local(ids))
    assert int(sharded.take_overflow()) == 0 and local.take_overflow() is None
    # multi-hot ids go flat through the engine and are pooled after it
    rng = np.random.RandomState(1)
    bags = torch.from_numpy(rng.randint(0, 300000, (8, 26, 3)))
    mask = torch.from_numpy((rng.rand(8, 26, 3) < 0.7).astype(np.float32))
    for combiner in ("sum", "mean"):
        sharded.combiner = local.combiner = combiner
        torch.testing.assert_close(sharded(bags, mask), local(bags, mask),
                                   rtol=0, atol=1e-6)
    assert all(s.engine is None for s in small) and sharding.MIN_ROWS_TO_SHARD == 8192
    assert sum("falling back to the local" in x for x in lines) == 1
