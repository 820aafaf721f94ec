"""Host-tiered embedding table: the GPUBox / HeterPS analog.

A copy of ``paddlerec_tpu/parallel/host_table.py`` (numpy; the stores,
``_fresh_values`` and the prefetch snapshot bit for bit).  The reference's
GPU parameter server keeps the full sparse table in host memory (and on
SSD) and builds a per-pass device cache of exactly the rows that pass
touches (``PSGPU.begin_pass/end_pass``):

- the FULL table lives in host RAM as numpy (rows materialize lazily:
  untouched ids cost nothing beyond a bool bitmask);
- ``begin_pass(ids)`` uniques the pass's ids, seeds any never-seen rows and
  returns one dense ``(U, D)`` float32 array in host memory; the caller
  uploads it to the card in one transfer (``train/host_loop.py``);
- during the pass every batch translates global ids into cache slots on the
  host (a sorted-array searchsorted, no device sync), and the step gathers
  and updates ONLY the cache;
- ``end_pass(cache)`` writes the trained rows back to host storage.

**Disk tier** (the SSD_EMBEDDING analog): with ``ram_rows`` set, host
storage becomes a fixed-size RAM slab plus an mmap-backed spill file.  Rows
evict from the slab to disk coldest-first by the same decayed show counts
that drive ``shrink``, and ``prefetch`` reads the next pass's rows on a
host thread while the current pass trains.  Rows only MOVE between tiers,
so the values are the RAM-only path's bit for bit.

Feature lifecycle (the CtrAccessor show-decay / eviction analog): the show
counts of ``begin_pass`` are decayed by ``end_day`` and ``shrink`` frees
cold rows.  All store access is serialized by one ``RLock``; the prefetch
thread runs on the host and never touches the card.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch


# fresh rows drawn a block at a time, the blocks on up to 8 host threads
_FRESH_BLOCK = 1 << 14
_FRESH_THREADS = min(8, os.cpu_count() or 1)


class _DenseStore:
    """RAM-only storage: one virtual-memory array, untouched rows free."""

    def __init__(self, vocab: int, dim: int):
        # np.zeros is virtual memory — untouched rows are never paged in
        self.table = np.zeros((vocab, dim), np.float32)

    def read(self, ids: np.ndarray) -> np.ndarray:
        return self.table[ids]

    def write(self, ids: np.ndarray, vals: np.ndarray, shows) -> None:
        self.table[ids] = vals

    def free(self, mask: np.ndarray) -> None:
        self.table[mask] = 0.0

    @property
    def rows_in_ram(self) -> int:  # informational only
        return self.table.shape[0]

    rows_on_disk = 0


class _SpillStore:
    """Fixed RAM slab + mmap spill file (the SSD tier).

    Row states: in-slab (slot_of >= 0), on-disk (on_disk), or neither
    (uninitialized / evicted).  Eviction picks the coldest slab rows by
    the table's decayed show counts.  The spill file is created lazily
    and sparse (disk blocks allocate only for written rows)."""

    def __init__(self, vocab: int, dim: int, ram_rows: int, path: str):
        self.vocab, self.dim = int(vocab), int(dim)
        self.ram_rows = int(ram_rows)
        if self.ram_rows <= 0:
            raise ValueError(f"ram_rows must be positive: {ram_rows}")
        self.path = path
        self.slab = np.zeros((self.ram_rows, dim), np.float32)
        self.slot_of = np.full(self.vocab, -1, np.int32)
        self.row_of = np.full(self.ram_rows, -1, np.int64)
        self.on_disk = np.zeros(self.vocab, bool)
        self._free = list(range(self.ram_rows - 1, -1, -1))
        self._mmap: Optional[np.memmap] = None

    def _ensure_mmap(self) -> np.memmap:
        if self._mmap is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            mode = "r+" if os.path.exists(self.path) else "w+"
            self._mmap = np.lib.format.open_memmap(
                self.path, mode=mode, dtype=np.float32,
                shape=(self.vocab, self.dim),
            )
        return self._mmap

    def read(self, ids: np.ndarray) -> np.ndarray:
        out = np.zeros((len(ids), self.dim), np.float32)
        slots = self.slot_of[ids]
        in_slab = slots >= 0
        if in_slab.any():
            out[in_slab] = self.slab[slots[in_slab]]
        disk = (~in_slab) & self.on_disk[ids]
        if disk.any():
            out[disk] = self._ensure_mmap()[ids[disk]]
        return out

    def write(self, ids: np.ndarray, vals: np.ndarray,
              shows: np.ndarray) -> None:
        vals = np.asarray(vals, np.float32)
        slots = self.slot_of[ids]
        in_slab = slots >= 0
        if in_slab.any():
            self.slab[slots[in_slab]] = vals[in_slab]
            # slab copy is now newer than any disk copy
            self.on_disk[ids[in_slab]] = False
        new_ids, new_vals = ids[~in_slab], vals[~in_slab]
        if not len(new_ids):
            return
        need = len(new_ids) - len(self._free)
        if need > 0:
            # evict the coldest current residents to disk.  The rows
            # just written in place had their shows bumped this pass, so
            # coldest-first naturally spares the hot working set.
            occ = np.flatnonzero(self.row_of >= 0)
            order = np.argsort(shows[self.row_of[occ]], kind="stable")
            evict = occ[order[:need]]
            if len(evict):
                rows = self.row_of[evict]
                self._ensure_mmap()[rows] = self.slab[evict]
                self.on_disk[rows] = True
                self.slot_of[rows] = -1
                self.row_of[evict] = -1
                self._free.extend(int(e) for e in evict)
        k = min(len(new_ids), len(self._free))
        if k:
            take = np.asarray(
                [self._free.pop() for _ in range(k)], np.int64
            )
            self.slab[take] = new_vals[:k]
            self.slot_of[new_ids[:k]] = take
            self.row_of[take] = new_ids[:k]
            self.on_disk[new_ids[:k]] = False
        if k < len(new_ids):
            # pass working set exceeds the slab: overflow goes straight
            # to disk (it will prefetch back on its next touch)
            self._ensure_mmap()[new_ids[k:]] = new_vals[k:]
            self.on_disk[new_ids[k:]] = True

    def free(self, mask: np.ndarray) -> None:
        rows = np.flatnonzero(mask)
        slots = self.slot_of[rows]
        in_slab = slots >= 0
        for s in slots[in_slab]:
            self._free.append(int(s))
        self.row_of[slots[in_slab]] = -1
        self.slot_of[rows] = -1
        self.on_disk[rows] = False  # dead disk blocks; value unreachable

    @property
    def rows_in_ram(self) -> int:
        return self.ram_rows - len(self._free)

    @property
    def rows_on_disk(self) -> int:
        return int(self.on_disk.sum())


class HostTieredTable:
    """Full sparse table in host RAM (+ optional mmap disk tier) with a
    per-pass dense device cache.

    ``ram_rows=None`` keeps the original RAM-only dense storage;
    setting it caps RAM residency at that many rows and spills the rest
    to ``spill_path`` (defaults to a tempfile)."""

    def __init__(self, vocab: int, dim: int, seed: int = 0,
                 init_scale: Optional[float] = None,
                 show_decay: float = 0.98,
                 ram_rows: Optional[int] = None,
                 spill_path: Optional[str] = None):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.seed = int(seed)
        self.init_scale = (
            float(init_scale) if init_scale is not None
            else 1.0 / np.sqrt(dim)
        )
        self.show_decay = float(show_decay)
        if ram_rows is None:
            self._store = _DenseStore(self.vocab, self.dim)
        else:
            if spill_path is None:
                import tempfile

                spill_path = os.path.join(
                    tempfile.mkdtemp(prefix="host_table_spill_"),
                    "table.npy",
                )
            self._store = _SpillStore(
                self.vocab, self.dim, ram_rows, spill_path
            )
        self._initialized = np.zeros(self.vocab, bool)
        self._shows = np.zeros(self.vocab, np.float32)
        self._pass_ids: Optional[np.ndarray] = None  # sorted unique ids
        # prefetch state: (ids, vals) snapshot + the reader thread.
        # begin_pass consumes it when the requested ids match exactly;
        # end_pass refreshes any overlap it rewrites, so the snapshot is
        # never stale.  All store access is serialized by _lock.
        self._lock = threading.RLock()
        self._prefetched: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._pre_found: Optional[np.ndarray] = None
        self._prefetch_thread: Optional[threading.Thread] = None

    # backward-compat accessor (tests + host_loop.save read the dense
    # table directly in RAM-only mode)
    @property
    def _table(self) -> np.ndarray:
        if isinstance(self._store, _DenseStore):
            return self._store.table
        raise AttributeError(
            "_table is dense-mode only; use snapshot_rows() on a "
            "spill-tier table"
        )

    @_table.setter
    def _table(self, value: np.ndarray) -> None:
        if not isinstance(self._store, _DenseStore):
            raise AttributeError("_table is dense-mode only")
        self._store.table = value

    # -- storage ------------------------------------------------------------
    def _fresh_values(self, fresh: np.ndarray) -> np.ndarray:
        """Deterministic per-(seed, id) init values for never-seen rows:
        splitmix64 of (seed, id, column) → uniform → Box-Muller.  A
        per-row RandomState loop costs minutes at 10^7 fresh rows.  Every
        value depends on its row alone, so blocks of rows are drawn on
        host threads (numpy's ufuncs release the GIL): the same bits as one
        draw over all the rows."""
        if len(fresh) <= _FRESH_BLOCK:
            return self._fresh_block(fresh)
        out = np.empty((len(fresh), self.dim), np.float32)

        def block(start: int) -> None:
            out[start:start + _FRESH_BLOCK] = self._fresh_block(
                fresh[start:start + _FRESH_BLOCK])

        with ThreadPoolExecutor(_FRESH_THREADS) as pool:
            list(pool.map(block, range(0, len(fresh), _FRESH_BLOCK)))
        return out

    def _fresh_block(self, fresh: np.ndarray) -> np.ndarray:

        def _splitmix64(x: np.ndarray) -> np.ndarray:
            x = (x + np.uint64(0x9E3779B97F4A7C15))
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            return x ^ (x >> np.uint64(31))

        with np.errstate(over="ignore"):
            base = (np.uint64(self.seed) * np.uint64(1_000_003)
                    + fresh.astype(np.uint64))[:, None]
            cols = np.arange(2 * ((self.dim + 1) // 2),
                             dtype=np.uint64)[None, :]
            bits = _splitmix64(base * np.uint64(2**32 + 1) + cols)
        u = (bits >> np.uint64(11)).astype(np.float64) / float(2**53)
        u = np.clip(u, 1e-12, 1.0 - 1e-12)
        u1, u2 = u[:, 0::2], u[:, 1::2]
        z = np.concatenate(
            [np.sqrt(-2 * np.log(u1)) * np.cos(2 * np.pi * u2),
             np.sqrt(-2 * np.log(u1)) * np.sin(2 * np.pi * u2)],
            axis=1,
        )[:, : self.dim]
        return (z * self.init_scale).astype(np.float32)

    def _materialize(self, ids: np.ndarray) -> None:
        fresh = ids[~self._initialized[ids]]
        if len(fresh):
            self._store.write(fresh, self._fresh_values(fresh),
                              self._shows)
            self._initialized[fresh] = True

    @property
    def rows_resident(self) -> int:
        return int(self._initialized.sum())

    @property
    def rows_in_ram(self) -> int:
        return self._store.rows_in_ram

    @property
    def rows_on_disk(self) -> int:
        return self._store.rows_on_disk

    # -- pass protocol (PSGPU.begin_pass/end_pass) ---------------------------
    def begin_pass(self, ids) -> np.ndarray:
        """Unique the pass's ids, init fresh rows, read the pass's rows.

        Returns the dense ``(U, D)`` float32 cache in host memory, rows in
        ascending id order; the caller uploads it (it IS the trainable
        embedding for this pass)."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        if ids.size and (ids[0] < 0 or ids[-1] >= self.vocab):
            raise ValueError(
                f"ids out of range [0, {self.vocab}): "
                f"min={ids[0]}, max={ids[-1]}"
            )
        self._join_prefetch()
        with self._lock:
            pre = self._prefetched
            self._prefetched = None
            if pre is not None and np.array_equal(pre[0], ids):
                # the snapshot covers this exact pass: rows it found are
                # current (end_pass refreshed any overlap); rows it did
                # not find were uninitialized then — materialize and
                # re-read just those
                self._materialize(ids)
                cache = pre[1]
                missing = ~self._pre_found
                if missing.any():
                    cache[missing] = self._store.read(ids[missing])
            else:
                self._materialize(ids)
                cache = self._store.read(ids)
            self._shows[ids] += 1.0
            self._pass_ids = ids
        return cache

    def prefetch(self, ids) -> None:
        """Read the (sorted unique) next pass's rows on a background
        thread — the SSD-tier pass-level prefetch (reference
        static_ps_online_trainer.py:370-371 dataset preload analog).
        Safe to call while the current pass trains on device; end_pass
        refreshes any rows it rewrites, so the snapshot stays exact."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        self._join_prefetch()

        def work():
            with self._lock:
                vals = self._store.read(ids)
                self._pre_found = self._initialized[ids].copy()
                self._prefetched = (ids, vals)

        th = threading.Thread(target=work, daemon=True)
        # start BEFORE publishing: a concurrent _join_prefetch (from
        # end_pass on the main thread while this runs on the prepare
        # thread) must never see an unstarted thread
        th.start()
        self._prefetch_thread = th

    def _join_prefetch(self) -> None:
        th = self._prefetch_thread
        if th is not None:
            th.join()
            self._prefetch_thread = None

    def translate(self, ids) -> np.ndarray:
        """Global ids → cache slot indices (host-side, no device sync).

        Ids that were not declared in ``begin_pass`` raise — the same
        contract as the reference's pass-build (a pass trains only on
        the data used to build it)."""
        if self._pass_ids is None:
            raise RuntimeError("translate() before begin_pass()")
        ids = np.asarray(ids, np.int64)
        if len(self._pass_ids) == 0:
            raise KeyError(
                f"ids not in the current pass (the pass is empty; first "
                f"few requested: {ids.reshape(-1)[:5].tolist()})"
            )
        slots = np.searchsorted(self._pass_ids, ids.reshape(-1))
        slots = np.clip(slots, 0, max(len(self._pass_ids) - 1, 0))
        if not np.array_equal(self._pass_ids[slots], ids.reshape(-1)):
            missing = ids.reshape(-1)[self._pass_ids[slots]
                                      != ids.reshape(-1)]
            raise KeyError(
                f"ids not in the current pass (first few: "
                f"{missing[:5].tolist()}); call begin_pass with all ids "
                f"the pass will touch"
            )
        return slots.reshape(ids.shape).astype(np.int32)

    def end_pass(self, cache) -> None:
        """Flush the trained cache rows back to host storage."""
        if self._pass_ids is None:
            raise RuntimeError("end_pass() before begin_pass()")
        cache = np.asarray(cache, np.float32)
        if cache.shape != (len(self._pass_ids), self.dim):
            raise ValueError(
                f"cache shape {cache.shape} != "
                f"({len(self._pass_ids)}, {self.dim})"
            )
        self._join_prefetch()
        with self._lock:
            self._store.write(self._pass_ids, cache, self._shows)
            if self._prefetched is not None:
                # refresh the prefetched snapshot where this pass just
                # rewrote rows the next pass will read
                pids, pvals = self._prefetched
                idx = np.searchsorted(pids, self._pass_ids)
                safe = np.clip(idx, 0, max(len(pids) - 1, 0))
                hit = (idx < len(pids)) & (pids[safe] == self._pass_ids)
                if hit.any():
                    pvals[safe[hit]] = cache[hit]
                    self._pre_found[safe[hit]] = True
            self._pass_ids = None

    # -- feature lifecycle (CtrAccessor analog) -------------------------------
    def end_day(self) -> None:
        """Decay show counts (config_fleet.py show_click_decay_rate)."""
        self._shows *= self.show_decay

    def shrink(self, threshold: float = 0.5) -> int:
        """Evict rows whose decayed show count fell below ``threshold``:
        free the storage and let the row re-init on next touch
        (DownpourSparseTable delete_threshold analog).  Returns the
        number of evicted rows."""
        self._join_prefetch()
        with self._lock:
            cold = self._initialized & (self._shows < threshold)
            n = int(cold.sum())
            if n:
                self._store.free(cold)
                self._initialized[cold] = False
                self._shows[cold] = 0.0
                self._prefetched = None  # may reference freed rows
            return n

    # -- convenience ----------------------------------------------------------
    def lookup_host(self, ids) -> np.ndarray:
        """Serving-style host read (no pass required); missing rows are
        zeros, matching the cube KV miss contract."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        self._join_prefetch()
        with self._lock:
            safe = np.clip(ids, 0, self.vocab - 1)
            out = self._store.read(safe)
            out[(ids < 0) | (ids >= self.vocab)
                | ~self._initialized[safe]] = 0.0
        return out

    def snapshot_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, values) of every initialized row — the checkpoint form
        that works for both storage modes (a dense dump of a
        disk-tier vocab would defeat the tier)."""
        self._join_prefetch()
        with self._lock:
            ids = np.flatnonzero(self._initialized)
            return ids, self._store.read(ids)

    def restore_rows(self, ids, values,
                     shows: Optional[np.ndarray] = None) -> None:
        """Checkpoint-load counterpart of snapshot_rows."""
        ids = np.asarray(ids, np.int64)
        self._join_prefetch()
        with self._lock:
            if shows is not None:
                self._shows[:] = shows
            self._store.write(ids, np.asarray(values, np.float32),
                              self._shows)
            self._initialized[ids] = True
            self._prefetched = None


def pass_train_loop(table: HostTieredTable, batches, step_fn, opt_update,
                    opt_state, cache: torch.Tensor
                    ) -> Tuple[torch.Tensor, object]:
    """Reference loop shape for one pass: every batch gathers from the
    cache by slot, ``step_fn(cache, batch)`` returns the cache gradient, and
    ``opt_update(grad, opt_state, cache)`` returns ``(updates, opt_state)``,
    which are added to the cache.  Call ``table.end_pass(cache)`` afterwards
    to persist."""
    for batch in batches:
        slots = table.translate(batch["ids"])
        grad = step_fn(cache, dict(batch, slots=torch.from_numpy(slots).long()))
        updates, opt_state = opt_update(grad, opt_state, cache)
        cache = cache + updates
    return cache, opt_state
