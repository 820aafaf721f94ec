"""The port's host-tiered table (``parallel/host_table.py``) against the JAX
package's on the same calls: the pass protocol, the errors, the feature
lifecycle, the spill tier and the prefetch snapshot.  Every store read,
snapshot and show count is bitwise the JAX package's (the module is a numpy
copy); the cache the port hands out is float32 host memory."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from paddlerec_tpu.parallel import host_table as jax_ht
from paddlerec_tpu_torch.parallel import host_table as port_ht

torch.set_num_threads(1)


def _both(*args, **kwargs):
    return jax_ht.HostTieredTable(*args, **kwargs), port_ht.HostTieredTable(*args, **kwargs)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_tables(ref, port, ids):
    _same(ref.lookup_host(ids), port.lookup_host(ids))
    for x, y in zip(ref.snapshot_rows(), port.snapshot_rows()):
        _same(x, y)
    _same(ref._shows, port._shows)
    assert (ref.rows_resident, ref.rows_in_ram, ref.rows_on_disk) == (
        port.rows_resident, port.rows_in_ram, port.rows_on_disk)


@pytest.mark.parametrize("seed,dim,n", [(0, 8, 300), (1, 9, 300), (2023, 128, 300),
                                        (7, 1, 300), (3, 9, 3 * port_ht._FRESH_BLOCK + 5)])
def test_fresh_values_are_bitwise_the_jax_packages(seed, dim, n):
    """Bitwise, also where the port draws blocks of rows on threads."""
    ref, port = _both(vocab=10_000_000, dim=dim, seed=seed)
    ids = np.unique(np.random.RandomState(seed).randint(0, 10_000_000, n))
    got = port._fresh_values(ids)
    assert got.dtype == np.float32 and got.shape == (len(ids), dim)
    _same(ref._fresh_values(ids), got)


def test_pass_protocol_roundtrip():
    ref, port = _both(vocab=10_000_000, dim=8, seed=1)
    ids = np.asarray([3, 9_999_999, 42, 3, 42])
    cache = port.begin_pass(ids)
    assert isinstance(cache, np.ndarray) and cache.shape == (3, 8)  # deduped
    _same(ref.begin_pass(ids), cache)
    assert port.rows_resident == 3  # lazy: only touched rows materialize
    # deterministic per-row init (same seed -> same rows next time)
    _same(port_ht.HostTieredTable(vocab=10_000_000, dim=8, seed=1).begin_pass(ids), cache)
    query = np.asarray([[42, 3], [9_999_999, 42]])
    slots = port.translate(query)
    _same(ref.translate(query), slots)
    np.testing.assert_array_equal(port._pass_ids[slots.reshape(-1)], [42, 3, 9_999_999, 42])
    # ids outside the pass raise with the offenders named
    with pytest.raises(KeyError, match="7777"):
        port.translate([7777])
    trained = cache + 1.0
    ref.end_pass(trained)
    port.end_pass(torch.from_numpy(trained))  # a CPU tensor flushes as numpy does
    _same(port.lookup_host([3]), trained[0:1])
    _same_tables(ref, port, np.arange(0, 10_000_000, 99_991))
    with pytest.raises(RuntimeError):
        port.translate([3])  # pass closed
    with pytest.raises(RuntimeError, match="before begin_pass"):
        port.end_pass(trained)


def test_out_of_range_and_bad_flush():
    port = port_ht.HostTieredTable(vocab=100, dim=4)
    with pytest.raises(ValueError, match="out of range"):
        port.begin_pass([5, 100])
    with pytest.raises(ValueError, match="out of range"):
        port.begin_pass([-1, 5])
    cache = port.begin_pass([1, 2])
    with pytest.raises(ValueError, match="cache shape"):
        port.end_pass(np.zeros((3, 4), np.float32))
    port.end_pass(cache)
    empty = port.begin_pass([])
    assert empty.shape == (0, 4)
    with pytest.raises(KeyError, match="pass is empty"):
        port.translate([1])


def test_eviction_lifecycle():
    ref, port = _both(vocab=1000, dim=4, show_decay=0.5)
    for t in (ref, port):
        t.end_pass(np.asarray(t.begin_pass([1, 2, 3])))
        t.end_pass(np.asarray(t.begin_pass([1])))  # id 1 seen twice
        for _ in range(3):
            t.end_day()
    assert ref.shrink(threshold=0.2) == port.shrink(threshold=0.2) == 2
    assert port.rows_resident == 1
    _same_tables(ref, port, np.arange(1000))
    # evicted rows read back as zeros and re-init on next touch
    assert not port.lookup_host([2]).any()
    again = port.begin_pass([2])
    assert np.abs(again).sum() > 0
    _same(ref.begin_pass([2]), again)


def test_learning_across_passes():
    """Two passes over a planted embedding-regression problem, the JAX loop
    with optax's adagrad and the port's ``pass_train_loop`` with the same
    rule in torch: the second pass resumes from the trained rows, the loss
    falls, and both tables agree."""
    vocab, dim, bs = 50_000, 8, 64
    rng = np.random.RandomState(0)
    target = rng.randn(32, dim).astype(np.float32)  # 32 hot ids
    hot_ids = rng.choice(vocab, 32, replace=False).astype(np.int64)
    passes = []
    for _ in range(2):
        picks = [rng.randint(0, 32, bs) for _ in range(80)]
        passes.append([{"ids": hot_ids[p], "y": target[p]} for p in picks])

    ref, port = _both(vocab=vocab, dim=dim, seed=0)
    tx = optax.adagrad(1.0)

    @jax.jit
    def jax_grad(cache, batch):
        return jax.grad(lambda c: jnp.mean((c[batch["slots"]] - batch["y"]) ** 2))(cache)

    def torch_grad(cache, batch):
        c = cache.detach().requires_grad_(True)
        loss = torch.mean((c[batch["slots"]] - torch.from_numpy(batch["y"])) ** 2)
        loss.backward()
        return c.grad

    def torch_adagrad(grad, acc, cache):  # optax.adagrad(1.0): acc from 0.1, eps 1e-7
        acc = acc + grad * grad
        return -1.0 * grad / torch.sqrt(acc + 1e-7), acc

    losses = []
    for batches in passes:
        ids = np.concatenate([b["ids"] for b in batches])
        cache = ref.begin_pass(ids)
        cache, _ = jax_ht.pass_train_loop(ref, batches, jax_grad, tx.update,
                                          tx.init(cache), cache)
        ref.end_pass(cache)
        host = port.begin_pass(ids)
        first = port.translate(batches[0]["ids"])
        losses.append(float(np.mean((host[first] - batches[0]["y"]) ** 2)))
        t = torch.from_numpy(host)
        t, _ = port_ht.pass_train_loop(port, batches, torch_grad, torch_adagrad,
                                       torch.full_like(t, 0.1), t)
        port.end_pass(t)
    assert losses[1] < losses[0] * 0.3, losses
    got = port.lookup_host(hot_ids)
    assert float(np.mean((got - target) ** 2)) < 0.05
    np.testing.assert_allclose(got, ref.lookup_host(hot_ids), rtol=1e-5, atol=1e-5)
    assert port.rows_resident == ref.rows_resident == 32


def _run_passes(tbl, n_passes=6, rows_per_pass=40, vocab=1000, seed=7, prefetch=False):
    """The JAX spill tests' pass sequence: 'training' adds a per-row delta
    derived from the row id."""
    rng = np.random.RandomState(seed)
    pass_ids = [np.unique(rng.randint(0, vocab, rows_per_pass)) for _ in range(n_passes)]
    for i, ids in enumerate(pass_ids):
        cache = np.asarray(tbl.begin_pass(ids))
        if prefetch and i + 1 < n_passes:
            tbl.prefetch(pass_ids[i + 1])
        tbl.end_pass(cache + (ids[:, None] % 13 + 1).astype(np.float32) * 0.01)
    return pass_ids


@pytest.mark.parametrize("prefetch", [False, True])
def test_spill_against_dense_and_the_jax_package(tmp_path, prefetch):
    vocab, dim = 1000, 8
    dense = port_ht.HostTieredTable(vocab, dim, seed=3)
    ref = jax_ht.HostTieredTable(vocab, dim, seed=3, ram_rows=32,
                                 spill_path=str(tmp_path / "ref" / "t.npy"))
    spill = port_ht.HostTieredTable(vocab, dim, seed=3, ram_rows=32,
                                    spill_path=str(tmp_path / "port" / "t.npy"))
    for t in (dense, ref, spill):
        _run_passes(t, prefetch=prefetch)
    assert dense.rows_resident == spill.rows_resident > 32
    assert spill.rows_in_ram <= 32 and spill.rows_on_disk > 0
    assert spill.rows_in_ram + spill.rows_on_disk == spill.rows_resident
    all_ids = np.arange(vocab)
    _same(dense.lookup_host(all_ids), spill.lookup_host(all_ids))
    _same_tables(ref, spill, all_ids)
    for name in ("slot_of", "row_of", "on_disk", "slab"):
        _same(getattr(ref._store, name), getattr(spill._store, name))
    assert ref._store._free == spill._store._free
    _same(np.load(tmp_path / "ref" / "t.npy", mmap_mode="r"),
          np.load(tmp_path / "port" / "t.npy", mmap_mode="r"))


def test_spill_eviction_prefers_cold_rows():
    ref, port = _both(1000, 4, seed=0, ram_rows=16)
    hot = np.arange(8)
    for i in range(5):
        ids = np.union1d(hot, np.arange(100 + 20 * i, 120 + 20 * i))
        for t in (ref, port):
            t.end_pass(np.asarray(t.begin_pass(ids)))
    # the hot rows were shown 5x; they must still be RAM-resident
    assert (port._store.slot_of[hot] >= 0).all(), port._store.slot_of[hot]
    assert port.rows_on_disk > 0
    _same(ref._store.slot_of, port._store.slot_of)
    _same_tables(ref, port, np.arange(1000))


def test_spill_shrink_and_reinit():
    ref, port = _both(500, 4, seed=1, ram_rows=8, show_decay=0.5)
    ids = np.arange(30)
    for t in (ref, port):
        t.end_pass(np.asarray(t.begin_pass(ids)))
    assert port.rows_on_disk > 0
    for t in (ref, port):
        t.end_day()
        t.end_day()
    assert ref.shrink(threshold=0.5) == port.shrink(threshold=0.5) == 30
    assert port.rows_resident == port.rows_on_disk == 0
    # freed rows re-init deterministically (same values as a fresh table)
    again = port.begin_pass(ids)
    _same(port_ht.HostTieredTable(500, 4, seed=1).begin_pass(ids), again)
    _same(ref.begin_pass(ids), again)


def test_spill_pass_larger_than_slab():
    """A pass whose working set exceeds the RAM slab still trains (overflow
    rows go straight to disk)."""
    dense = port_ht.HostTieredTable(300, 4, seed=2)
    ref, spill = _both(300, 4, seed=2, ram_rows=8)
    for t in (dense, ref, spill):
        t.end_pass(np.asarray(t.begin_pass(np.arange(100))) + 1.0)
    assert spill.rows_in_ram <= 8 and spill.rows_on_disk >= 92
    _same(dense.lookup_host(np.arange(300)), spill.lookup_host(np.arange(300)))
    _same_tables(ref, spill, np.arange(300))


def test_prefetch_refresh_on_overlap():
    """A row trained in pass i and prefetched for pass i+1 arrives with its
    post-pass-i value (end_pass refreshes the snapshot)."""
    ref, port = _both(100, 4, seed=5, ram_rows=4)
    ids = np.arange(10)
    got = []
    for t in (ref, port):
        cache = np.asarray(t.begin_pass(ids))
        t.prefetch(ids)  # snapshot taken BEFORE this pass's training lands
        t.end_pass(cache + 7.0)
        got.append(np.asarray(t.begin_pass(ids)))
        np.testing.assert_array_equal(got[-1], cache + 7.0)
    _same(*got)


def test_restore_rows_and_snapshot_roundtrip(tmp_path):
    ref, port = _both(2000, 8, seed=4, ram_rows=16)
    _run_passes(ref, vocab=2000)
    ids, vals = ref.snapshot_rows()
    port.restore_rows(ids, vals, shows=ref._shows)
    _same_tables(ref, port, np.arange(2000))
