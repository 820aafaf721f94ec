"""The port's online day/pass loop (``paddlerec_tpu_torch/train/online.py``)
against the JAX package's ``OnlineTrainer`` on ``rank.dnn``: both built from
one config, the port started from the JAX package's initial parameters, the
same day directories fed to both.  Records, pass schedule, touched and evict
sets, ``FeatureStats``, cube keys and shard layout must be exact; losses and
delta values agree to 1e-5 (float32 sums in another order); the streaming
AUC's buckets agree but for at most two predictions on a bucket edge."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.data.synthetic import write_criteo_sample
from paddlerec_tpu.native.cube import CubeClient as JaxCubeClient
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import online as jax_online
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.native.cube import CubeClient
from paddlerec_tpu_torch.tools import online_train
from paddlerec_tpu_torch.train import online as port_online

torch.set_num_threads(1)

DAY = "20240101"
VOCAB = 5001
PASSES = ("0000", "1200")  # split_interval 720: two passes a day
ROWS = 64


def _write_day(root, passes=PASSES, rows=ROWS, files=1):
    for i, p in enumerate(passes):
        write_criteo_sample(os.path.join(root, DAY, p), num_lines=rows, num_files=files,
                            vocab=VOCAB, seed=i)


def _flat(data, out, **extra):
    flat = {
        "runner.model": "rank.dnn",
        "runner.train_data_dir": str(data),
        "runner.train_batch_size": 32,
        "runner.infer_batch_size": 32,
        "runner.model_save_path": str(out),
        "runner.days": DAY,
        "runner.split_interval": 720,
        "runner.split_per_pass": 1,
        "runner.checkpoint_per_pass": 1,
        "runner.save_delta_frequency": 1,
        "runner.save_first_base": True,
        "runner.delta_cube_shards": 2,
        "runner.seed": 0,
        "hyper_parameters.sparse_inputs_slots": 27,
        "hyper_parameters.dense_input_dim": 13,
        "hyper_parameters.sparse_feature_number": VOCAB,
        "hyper_parameters.sparse_feature_dim": 9,
        "hyper_parameters.fc_sizes": [16],
        "hyper_parameters.optimizer.class": "Adam",
        # the configs' rate: Adam's m / sqrt(v) turns the relative error of a
        # gradient near 0 into a step error of up to lr, so the delta values'
        # 1e-5 holds at 1e-3 (measured 3.3e-5 at 1e-2 on one element)
        "hyper_parameters.optimizer.learning_rate": 0.001,
    }
    flat.update(extra)
    return flat


class Recorded:
    """Step losses and the streaming metric states a trainer reaches."""

    def __init__(self):
        self.losses, self.buckets = [], []


def _jax_trainer(flat):
    trainer = jax_online.OnlineTrainer(JaxConfig(dict(flat)),
                                       mesh=create_mesh(1, 1, jax.devices()[:1]))
    trainer.init_state()
    rec = Recorded()
    step = trainer._build_train_step()

    def train_step(state, batch, metric_state):
        out = step(state, batch, metric_state)
        rec.losses.append(float(out[2]))
        return out

    trainer._train_step = train_step
    compute = trainer._compute_metrics

    def compute_metrics(metric_state):
        ms = jax.device_get(metric_state)["auc"]
        rec.buckets.append((np.asarray(ms["stat_pos"]), np.asarray(ms["stat_neg"])))
        return compute(metric_state)

    trainer._compute_metrics = compute_metrics
    return trainer, rec


def _port_trainer(flat, jax_trainer=None, init=None):
    trainer = port_online.OnlineTrainer(Config(dict(flat)), device="cpu")
    trainer.init_state()
    if init is None:
        init = from_jax_params(jax.tree.map(np.asarray,
                                            jax.device_get(jax_trainer.state.params)))
    trainer.state.module.load_state_dict(init)
    rec = Recorded()
    step = trainer.train_step

    def train_step(batch, metric_state):
        metric_state, loss = step(batch, metric_state)
        rec.losses.append(float(loss))
        return metric_state, loss

    trainer.train_step = train_step
    compute = trainer._compute_metrics

    def compute_metrics(metric_state):
        ms = metric_state["auc"]
        rec.buckets.append((ms["stat_pos"].numpy().copy(), ms["stat_neg"].numpy().copy()))
        return compute(metric_state)

    trainer._compute_metrics = compute_metrics
    return trainer, rec


def _records(root):
    with open(os.path.join(root, "online_donefile.txt")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["day"], r["pass"], r["kind"], os.path.relpath(r["path"], root)) for r in recs]


def _shard_keys(path):
    """Keys of a cube shard file, from its layout (u64 magic, dim, count,
    i64 keys[count], f32 values[count·dim])."""
    head = np.fromfile(path, np.uint64, 3)
    return np.fromfile(path, np.int64, int(head[2]), offset=24)


def _assert_buckets_close(a, b):
    for (pa, na), (pb, nb) in zip(a, b):
        # a prediction on a bucket edge may land on either side: at most two
        moved = np.abs(pa.astype(np.int64) - pb).sum() + np.abs(na.astype(np.int64) - nb).sum()
        assert moved <= 4, moved
        assert pa.sum() == pb.sum() and na.sum() == nb.sum()
    assert len(a) == len(b)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One day of two passes through both packages, then a second run of
    each over the same roots (resume: every pass is done)."""
    root = tmp_path_factory.mktemp("online")
    data = root / "data"
    _write_day(str(data))
    jt, jrec = _jax_trainer(_flat(data, root / "jax"))
    init = from_jax_params(jax.tree.map(np.asarray, jax.device_get(jt.state.params)))
    pt, prec = _port_trainer(_flat(data, root / "port"), init=init)
    jm, pm = jt.run(), pt.run()
    first = {"jax": _records(str(root / "jax")), "port": _records(str(root / "port"))}
    again = {}
    for name, make in (("jax", lambda: _jax_trainer(_flat(data, root / "jax"))[0]),
                       ("port", lambda: _port_trainer(_flat(data, root / "port"),
                                                      init=init)[0])):
        trainer = make()
        passes = []
        train_pass = trainer.train_pass
        trainer.train_pass = lambda *a, _f=train_pass, **k: passes.append(a[1:3]) or _f(*a, **k)
        trainer.run()
        again[name] = {"passes": passes, "records": _records(str(root / name))}
    return {"root": root, "data": data, "jax": jt, "port": pt, "jrec": jrec, "prec": prec,
            "jm": jm, "pm": pm, "first": first, "again": again, "init": init}


def test_pass_interval_layout_equal():
    for args in ((5, 1), (5, 2), (720, 1), (360, 1), (60, 1, True), (120, 2, True)):
        assert (port_online.get_online_pass_interval(*args)
                == jax_online.get_online_pass_interval(*args)), args
    hourly = port_online.get_online_pass_interval(60, 1, is_data_hourly_placed=True)
    assert len(hourly) == 24 and hourly[3] == ["03"]


def test_feature_stats_equal_bitwise(tmp_path):
    rng = np.random.RandomState(0)
    kw = dict(decay=0.7, delete_threshold=0.9, delete_after_unseen_days=2)
    port, ref = port_online.FeatureStats(50, **kw), jax_online.FeatureStats(50, **kw)
    for day in range(4):
        for _ in range(3):
            rows = rng.randint(0, 50 if day < 2 else 20, size=rng.randint(1, 40))
            port.observe(rows)
            ref.observe(rows)
        np.testing.assert_array_equal(port.end_day(), ref.end_day())
        for a in ("show", "unseen_days", "seen"):
            assert getattr(port, a).tobytes() == getattr(ref, a).tobytes(), (day, a)
    path = str(tmp_path / "stats.npz")
    port.save(path)
    back = jax_online.FeatureStats(50)
    back.load(path)
    for a in ("show", "unseen_days", "seen"):
        assert getattr(back, a).tobytes() == getattr(ref, a).tobytes()
    # the multi-host merge, run on two views in this process
    views = {pkg: [pkg.FeatureStats(10, track_base=True) for _ in range(2)]
             for pkg in (port_online, jax_online)}
    for pkg, (h0, h1) in views.items():
        h0.observe(np.array([1, 1, 2]))
        h1.observe(np.array([2, 3]))
        for _ in range(2):  # a second merge adds nothing
            deltas = [h.local_delta() for h in (h0, h1)]
            for h in (h0, h1):
                h.apply_global([r for r, _ in deltas], [v for _, v in deltas])
        h0.end_day()
        h1.end_day()
        h0.observe(np.array([5]))
        deltas = [h.local_delta() for h in (h0, h1)]
        for h in (h0, h1):
            h.apply_global([r for r, _ in deltas], [v for _, v in deltas])
    for p, r in zip(views[port_online], views[jax_online]):
        for a in ("show", "unseen_days", "seen"):
            assert getattr(p, a).tobytes() == getattr(r, a).tobytes()
    assert views[port_online][1].show[5] == views[port_online][0].show[5] == 1.0


def test_online_run_matches_jax(pair):
    jrec, prec = pair["jrec"], pair["prec"]
    assert len(prec.losses) == len(jrec.losses) == 4  # 2 passes of 2 steps
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=0, atol=1e-5)
    # join-time eval and train leg of each pass
    assert len(prec.buckets) == 4
    _assert_buckets_close(prec.buckets, jrec.buckets)
    assert abs(pair["pm"]["auc"] - pair["jm"]["auc"]) < 1e-2
    assert pair["pm"]["total_ins"] == pair["jm"]["total_ins"] == ROWS
    assert {k for k in pair["pm"] if k.startswith("phase_")} == {
        k for k in pair["jm"] if k.startswith("phase_")}
    assert pair["first"]["port"] == pair["first"]["jax"]
    assert [r[2] for r in pair["first"]["port"]] == [
        "base", "checkpoint", "delta", "checkpoint", "delta", "base"]


def test_deltas_match_jax(pair):
    root = pair["root"]
    for p in range(len(PASSES)):
        tag = f"delta_{DAY}_{p}"
        port_dir, jax_dir = root / "port" / tag, root / "jax" / tag
        meta = json.loads((port_dir / "delta_meta.json").read_text())
        assert meta == json.loads((jax_dir / "delta_meta.json").read_text())
        (table,) = meta["tables"]
        assert table["format"] == "cube" and table["keys"] > 0
        names = sorted(os.listdir(port_dir / table["name"]))
        assert names == sorted(os.listdir(jax_dir / table["name"])) == [
            "cube_shard_0.bin", "cube_shard_1.bin"]
        keys = []
        for name in names:
            k = _shard_keys(str(port_dir / table["name"] / name))
            np.testing.assert_array_equal(k, _shard_keys(str(jax_dir / table["name"] / name)))
            keys.append(k)
        keys = np.concatenate(keys)
        assert len(keys) == table["keys"]
        probe = np.concatenate([keys, [VOCAB + 7, -3]])  # two misses
        port_shards = [str(port_dir / table["name"] / n) for n in names]
        jax_shards = [str(jax_dir / table["name"] / n) for n in names]
        with CubeClient(port_shards) as pc:
            got = pc.seek(probe)
        want = JaxCubeClient(jax_shards).seek(probe)
        # each package's client reads the other's shards the same way
        np.testing.assert_array_equal(JaxCubeClient(port_shards).seek(probe), got)
        with CubeClient(jax_shards) as jc:
            np.testing.assert_array_equal(jc.seek(probe), want)
        assert got.shape == (len(probe), 9)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert not got[-2:].any()


def test_delta_is_proportional_to_touched_rows(pair):
    """The delta holds the touched rows only (all pack lanes of each touched
    physical row), far below a full table; it resets after each publish
    and after the day's base."""
    root, port = pair["root"], pair["port"]
    meta = json.loads((root / "port" / f"delta_{DAY}_0" / "delta_meta.json").read_text())
    assert 0 < meta["rows_touched"] <= ROWS * 26
    assert meta["tables"][0]["keys"] <= meta["rows_touched"] * 8 < VOCAB
    delta_bytes = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(root / "port" / f"delta_{DAY}_0") for f in fs)
    table = port.state.module.embedding.embedding
    assert delta_bytes < table.numel() * 4
    assert port._touched and all(not m.any() for m in port._touched.values())
    # each delta's touched set is the rows its own pass's batches map to:
    # the bookkeeping starts afresh after each publish
    for p, sub in enumerate(PASSES):
        meta = json.loads((root / "port" / f"delta_{DAY}_{p}" / "delta_meta.json").read_text())
        rows = [(batch["sparse"].reshape(-1) % VOCAB) // 8
                for batch in port.make_dataset(str(pair["data"] / DAY / sub), 32)]
        assert meta["rows_touched"] == len(np.unique(np.concatenate(rows)))


def test_resume_skips_the_same_passes(pair):
    again = pair["again"]
    assert again["port"]["passes"] == again["jax"]["passes"] == []
    # at most the end-of-day base is written again: here not even that,
    # since the day trained no pass
    assert again["port"]["records"] == again["jax"]["records"] == pair["first"]["port"]


def test_checkpoint_and_base_restore(pair):
    """The last checkpoint restores into a fresh trainer; the day's base is
    the parameters after the shrink, and loads as params only."""
    root, port = pair["root"], pair["port"]
    fresh = port_online.OnlineTrainer(Config(_flat(pair["data"], root / "port")),
                                      device="cpu")
    fresh.load_checkpoint(str(root / "port"), f"base_{DAY}", params_only=True)
    for k, v in port.state.module.state_dict().items():
        assert torch.equal(fresh.state.module.state_dict()[k], v), k
    fresh.load_checkpoint(str(root / "port"), f"ckpt_{DAY}_1")
    fresh._load_stats(str(root / "port"), f"ckpt_{DAY}_1")
    stats = np.load(root / "jax" / f"ckpt_{DAY}_1_stats.npz")
    (name,) = fresh.stats
    assert name == "embedding/embedding"
    np.testing.assert_array_equal(fresh.stats[name].show, stats["embedding__embedding--show"])
    np.testing.assert_array_equal(fresh.stats[name].seen, stats["embedding__embedding--seen"])


def test_split_per_pass_trains_every_subdir(tmp_path):
    _write_day(str(tmp_path / "data"))
    flat = _flat(tmp_path / "data", tmp_path / "out", **{
        "runner.split_per_pass": 2, "runner.save_delta_frequency": 6,
        "runner.save_first_base": False})
    jt, jrec = _jax_trainer(flat)
    pt, prec = _port_trainer(dict(flat, **{"runner.model_save_path": str(tmp_path / "p")}), jt)
    seen = []
    make = pt.make_dataset
    pt.make_dataset = lambda d, b, *a, **k: seen.append(os.path.basename(d)) or make(d, b, *a, **k)
    jm, pm = jt.run(), pt.run()
    assert seen == list(PASSES)
    assert pm["total_ins"] == jm["total_ins"] == 2 * ROWS
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=0, atol=1e-5)


def _observe_then_shrink(trainer, batches):
    trainer._ensure_tracking()
    for batch in batches:
        trainer._observe_batch(batch)
    evicted = {}
    zero = trainer._zero_table_rows

    def spy(name, rows):
        evicted[name] = np.array(rows)
        zero(name, rows)

    trainer._zero_table_rows = spy
    return trainer.shrink(), evicted


def test_shrink_matches_jax_and_zeroes_table_and_moments(pair, tmp_path):
    """Rows seen once in the pass fall under the threshold after a day's
    decay and are evicted; rows seen more often stay.  The evicted rows are
    exactly 0 in the table and both Adam moments, every other value is
    untouched."""
    batches = list(pair["port"].make_dataset(str(pair["data"] / DAY / PASSES[0]), 32))
    keys = ("table_parameters.delete_threshold", 1.5)
    flat = _flat(pair["data"], tmp_path / "out", **{keys[0]: keys[1]})
    jt, _ = _jax_trainer(flat)
    pt, _ = _port_trainer(flat, init=pair["init"])
    g = torch.Generator().manual_seed(0)
    for tree in (pt.state.opt_state["mu"], pt.state.opt_state["nu"]):
        for v in tree.values():
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    before = {k: v.clone() for k, v in pt.state.module.state_dict().items()}
    moments = {m: {k: v.clone() for k, v in pt.state.opt_state[m].items()} for m in ("mu", "nu")}
    n_jax, ev_jax = _observe_then_shrink(jt, batches)
    n_port, ev_port = _observe_then_shrink(pt, batches)
    assert n_port == n_jax > 0 and set(ev_port) == set(ev_jax) == {"embedding/embedding"}
    rows = ev_port["embedding/embedding"]
    np.testing.assert_array_equal(rows, ev_jax["embedding/embedding"])
    st = pt.stats["embedding/embedding"]
    assert 0 < len(rows) < np.count_nonzero(st.show) + len(rows)
    keep = np.ones(len(before["embedding.embedding"]), bool)
    keep[rows] = False
    for t, old in ((pt.state.module.embedding.embedding, before["embedding.embedding"]),
                   (pt.state.opt_state["mu"]["embedding.embedding"],
                    moments["mu"]["embedding.embedding"]),
                   (pt.state.opt_state["nu"]["embedding.embedding"],
                    moments["nu"]["embedding.embedding"])):
        assert not t[rows].detach().any()
        assert torch.equal(t[keep].detach(), old[keep])
    for k, v in pt.state.module.state_dict().items():
        if k != "embedding.embedding":
            assert torch.equal(v, before[k]), k
    for m in ("mu", "nu"):
        for k, v in pt.state.opt_state[m].items():
            if k != "embedding.embedding":
                assert torch.equal(v, moments[m][k]), k


def test_shrink_matches_tables_by_name_not_row_count(tmp_path):
    """Two tables of one row count: evicting 'emb/embedding' leaves
    'user_emb/embedding' whole, and the reverse."""
    trainer = port_online.OnlineTrainer(Config(_flat(tmp_path, tmp_path / "out")),
                                        device="cpu")

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Module()
            self.user_emb = torch.nn.Module()
            self.emb.embedding = torch.nn.Parameter(torch.ones(6, 4))
            self.user_emb.embedding = torch.nn.Parameter(torch.ones(6, 4))

    from paddlerec_tpu_torch.train.state import TrainState

    trainer.state = TrainState.create(Two(), trainer.tx)
    assert [n for n, _ in trainer._embedding_entries()] == ["emb/embedding",
                                                            "user_emb/embedding"]
    trainer._ensure_tracking()
    trainer._zero_table_rows("emb/embedding", np.array([1, 4]))
    assert not trainer.state.module.emb.embedding[[1, 4]].any()
    assert bool((trainer.state.module.user_emb.embedding == 1).all())
    assert bool((trainer.state.module.emb.embedding[[0, 2, 3, 5]] == 1).all())


def test_global_shuffle_covers_every_row(tmp_path):
    write_criteo_sample(str(tmp_path / "data" / DAY / PASSES[0]), num_lines=ROWS, num_files=2,
                        vocab=VOCAB, seed=3)
    flat = _flat(tmp_path / "data", tmp_path / "j", **{"runner.global_shuffle": True})
    jt, jrec = _jax_trainer(flat)
    pt, prec = _port_trainer(dict(flat, **{"runner.model_save_path": str(tmp_path / "p")}), jt)
    jm, pm = jt.run(), pt.run()
    assert pm["total_ins"] == jm["total_ins"] == ROWS
    # the same permutation of the same rows: the same batches
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=0, atol=1e-5)


def _port_losses(pair, tmp_path, **extra):
    flat = _flat(pair["data"], tmp_path / "out", **extra)
    trainer, rec = _port_trainer(flat, init=pair["init"])
    return trainer, rec


def test_prefetch_gives_the_same_passes(pair, tmp_path):
    trainer, rec = _port_losses(pair, tmp_path, **{"runner.prefetch": True})
    consumed = []
    take = trainer._take_prefetched
    trainer._take_prefetched = lambda key: consumed.append(key) or take(key)
    prefetched = []
    start = trainer._start_prefetch
    trainer._start_prefetch = lambda key, *a, **k: prefetched.append(key) or start(key, *a, **k)
    trainer.run()
    assert consumed == [(DAY, 0), (DAY, 1)] and prefetched == [(DAY, 1)]
    # the same steps as the run that read each pass when it came
    np.testing.assert_array_equal(rec.losses, pair["prec"].losses)


def test_staged_replay_and_restage(pair, tmp_path):
    """The train leg replays the infer leg's device batches (the pass's
    files are read once); over runner.resident_max_gb it restages them (read
    twice).  Both train the same steps."""
    reads = {}
    for name, gb in (("staged", 8.0), ("restaged", 1e-9)):
        trainer, rec = _port_losses(pair, tmp_path / name,
                                    **{"runner.resident_max_gb": gb})
        count = [0]
        prepare = trainer._prepare_pass

        def counting(dirs, seed, _prepare=prepare, _count=count):
            inner = _prepare(dirs, seed)

            class Counted:
                def __iter__(self):
                    _count[0] += 1
                    return iter(inner)
            return Counted()

        trainer._prepare_pass = counting
        trainer.run()
        reads[name] = count[0]
        np.testing.assert_array_equal(rec.losses, pair["prec"].losses)
    assert reads == {"staged": 2, "restaged": 4}  # two passes


def test_superbatch_feed(pair, tmp_path):
    """runner.feed_superbatch: the staged superbatches replay through
    super_step, to the same steps."""
    trainer, rec = _port_losses(pair, tmp_path, **{"runner.feed_superbatch": 2})
    calls = []
    step = trainer.super_step
    trainer.super_step = lambda sb, i, m: calls.append(i) or step(sb, i, m)
    trainer.run()
    assert calls == [0, 1, 0, 1]
    np.testing.assert_allclose(rec.losses, pair["prec"].losses, rtol=0, atol=1e-6)


def test_sparse_rowwise_run_matches_jax_and_shrink_zeroes_row_state(tmp_path):
    """A sparse (row-wise adagrad, float32) run: losses, records and deltas
    as the JAX package's; the feed's dedup (``sparse_uniq``) gives the
    touched rows, and an eviction zeroes the row state too."""
    _write_day(str(tmp_path / "data"))
    flat = _flat(tmp_path / "data", tmp_path / "j", **{
        "hyper_parameters.sparse_update": True,
        "hyper_parameters.sparse_update_rule": "adagrad",
        "runner.checkpoint_per_pass": 2})
    jt, jrec = _jax_trainer(flat)
    pt, prec = _port_trainer(dict(flat, **{"runner.model_save_path": str(tmp_path / "p")}), jt)
    uniq_batches = []
    observe = pt._observe_batch
    pt._observe_batch = lambda b: uniq_batches.append("sparse_uniq" in b) or observe(b)
    jt.run()
    pt.run()
    assert uniq_batches == [True] * 4
    np.testing.assert_allclose(prec.losses, jrec.losses, rtol=0, atol=1e-5)
    assert _records(str(tmp_path / "p")) == _records(str(tmp_path / "j"))
    for p in range(len(PASSES)):
        tag = f"delta_{DAY}_{p}"
        assert (json.loads((tmp_path / "p" / tag / "delta_meta.json").read_text())
                == json.loads((tmp_path / "j" / tag / "delta_meta.json").read_text()))
    acc = pt.state.extra["embedding/embedding_delta"].acc
    assert acc.any()
    st = pt.stats["embedding/embedding"]
    rows = np.nonzero(acc.numpy())[0][:5]
    st.seen[rows] = True
    st.show[rows] = 0.0
    assert pt.shrink() >= len(rows)
    assert not acc[rows].any() and not pt.state.module.embedding.embedding[rows].any()


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    _write_day(str(tmp_path / "data"), passes=PASSES[:1])
    flat = _flat(tmp_path / "data", tmp_path / "out")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_online.OnlineTrainer(Config(dict(flat)))
    # Trainer's check_ported at one process: geo trains as plain sync, fl
    # raises the reference's ValueError; the online loop refuses the host
    # table itself (the JAX online loop ignores the key, and composing the
    # day/pass loop with the host tier is part of neither package)
    port_online.OnlineTrainer(Config(dict(flat, **{"runner.sync_mode": "geo"})),
                              device="cpu")
    with pytest.raises(ValueError, match="sync_mode: fl needs >1 process"):
        port_online.OnlineTrainer(Config(dict(flat, **{"runner.sync_mode": "fl"})),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="use_host_table"):
        port_online.OnlineTrainer(Config(dict(flat, **{"runner.use_host_table": True})),
                                  device="cpu")
    yaml = tmp_path / "online.yaml"
    yaml.write_text("runner:\n  model: rank.dnn\n")
    over = [f"{k}={json.dumps(v) if isinstance(v, list) else v}" for k, v in flat.items()
            if k != "runner.model"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            online_train.main(["-m", str(yaml), "-o", *over])
    metrics = online_train.main(["-m", str(yaml), "-o", *over, "--device", "cpu"])
    assert metrics["total_ins"] == ROWS
    assert [r[2] for r in _records(str(tmp_path / "out"))] == [
        "base", "checkpoint", "delta", "base"]
