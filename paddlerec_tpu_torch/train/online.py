"""Online (streaming) training: the production day/pass loop.

Counterpart of ``paddlerec_tpu/train/online.py`` (the reference's
tools/static_ps_online_trainer.py with tools/utils/static_ps/flow_helper.py),
at one process on one device:
  * day/pass scheduling from split_interval / split_per_pass;
  * donefile-gated data readiness polling;
  * resume: skip the passes recorded in the model donefile up to the last
    checkpoint;
  * infer-before-train on each pass (join-time eval), whose device batches
    the train leg replays while they fit under ``runner.resident_max_gb``;
  * checkpoint cadence, mode-1 deltas (the rows touched since the last
    published artifact, as cube KV shards) and mode-2 bases (parameters
    only) with the online donefile;
  * end-of-day feature eviction (``shrink``, the ``fleet.shrink()`` analog)
    from per-row show counters with a daily decay.

The rows a batch touches are counted on the host batch in the feed (in the
feed's thread, before the batch is staged to the device), per table, by the
table's flax-form name (``"embedding/embedding"``); where the feed's dedup
of a sparse run already put ``sparse_uniq`` into the batch, its unique rows
are used.  A delta reads its touched physical rows off the device with one
K1 launch (``ops/embedding.py`` ``take_rows``, float32 out, from a bfloat16
table as well) and unpacks them with numpy.

Roots reach their filesystem through ``utils/fs.py`` ``get_fs`` (local
paths, ``gs://`` with google-cloud-storage installed).

**Across processes** (``tools.launch``; one rank of the trainer's ``(dp,
mp)`` mesh a process) each dp row trains its share of a pass (its file shard,
or with ``runner.global_shuffle`` its rows ``[dp_index::dp]`` of every file),
and the tables past ``MIN_ROWS_TO_SHARD`` are row-sharded over mp behind the
engine of ``SlotEmbedding``.  The bookkeeping names a sharded table by its
whole padded rows (``train/touched.py``).  Each dp row observed only its own
batches, so the lifecycle stats merge before they are saved or evict
(``FeatureStats(track_base=True)``: each row's show increments since the last
merge, ``_allgather_sparse`` over the dp group, applied in row order, so every
rank holds the same bits) and a delta covers the union of the dp rows'
touched rows.  A delta's rows are read off each shard with one K1 launch and
gathered over the mesh row.  Rank 0 alone writes the donefile, the stats,
the deltas and the bases; every rank takes part in every collective, and
``shrink`` zeroes the same rows on every replica of a shard.
"""

from __future__ import annotations

import json
import os
import threading
import time
from datetime import datetime, timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddlerec_tpu_torch.convert import is_embedding_path
from paddlerec_tpu_torch.core import metrics as metrics_lib
from paddlerec_tpu_torch.core.config import Config, resolve_path
from paddlerec_tpu_torch.native.cube import export_table
from paddlerec_tpu_torch.ops.embedding import take_rows
from paddlerec_tpu_torch.ops.packed_embedding import sub_width
from paddlerec_tpu_torch.ops.sparse_update import SENTINEL
from paddlerec_tpu_torch.parallel.embedding import _all_gather
from paddlerec_tpu_torch.train import checkpoint as ckpt_lib
from paddlerec_tpu_torch.train.touched import batch_rows_by_table
from paddlerec_tpu_torch.train.trainer import Trainer, all_gather_np, logger, rank0_info
from paddlerec_tpu_torch.utils.fs import get_fs


def get_online_pass_interval(
    split_interval: int, split_per_pass: int, is_data_hourly_placed: bool = False
) -> List[List[str]]:
    """Partition a day into passes of data sub-dirs, named HHMM (or HH when
    hourly), as flow_helper.get_online_pass_interval does."""
    passes = []
    minutes_per_pass = split_interval * split_per_pass
    n_passes = 24 * 60 // minutes_per_pass
    for p in range(n_passes):
        dirs = []
        for s in range(split_per_pass):
            start_min = p * minutes_per_pass + s * split_interval
            hh, mm = divmod(start_min, 60)
            dirs.append(f"{hh:02d}" if is_data_hourly_placed else f"{hh:02d}{mm:02d}")
        passes.append(dirs)
    return passes


class _ChainDataset:
    """Concatenate re-iterable datasets (split_per_pass > 1 spans several
    data sub-dirs per pass)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class _ArrayDataset:
    """Re-iterable fixed-shape batches over in-memory row arrays (the form a
    global-shuffled pass takes)."""

    def __init__(self, labels, sparse, dense, batch_size: int):
        self.labels = labels
        self.sparse = sparse
        self.dense = dense
        self.batch_size = int(batch_size)

    def __iter__(self):
        bs = self.batch_size
        n = len(self.labels) - (len(self.labels) % bs)
        for i in range(0, n, bs):
            batch = {
                "label": np.asarray(self.labels[i:i + bs], np.float32),
                "sparse": np.asarray(self.sparse[i:i + bs]),
                "mask": np.ones(bs, np.float32),
            }
            if self.dense is not None:
                batch["dense"] = np.asarray(self.dense[i:i + bs])
            yield batch


def _allgather_sparse(rows: np.ndarray, vals: Optional[np.ndarray], group,
                      device: torch.device):
    """Every member's (row ids[, values]) of ``group``, in group order, padded
    to the largest count: the bytes follow the rows touched, never the table.
    A collective: every member calls it in step.  Returns (rows by member,
    values by member or None)."""
    n = dist.get_world_size(group)
    rows = np.asarray(rows, np.int64)
    counts = all_gather_np(np.asarray([len(rows)], np.int64), device, group).reshape(-1)
    cap = int(counts.max())
    if cap == 0:
        empty = [np.zeros(0, np.int64) for _ in range(n)]
        return empty, (None if vals is None else
                       [np.zeros((0,) + vals.shape[1:], vals.dtype) for _ in range(n)])
    pad = np.zeros(cap, np.int64)
    pad[:len(rows)] = rows
    g_rows = all_gather_np(pad, device, group)
    out_rows = [g_rows[h, :int(counts[h])] for h in range(n)]
    if vals is None:
        return out_rows, None
    vpad = np.zeros((cap,) + vals.shape[1:], vals.dtype)
    vpad[:len(vals)] = vals
    g_vals = all_gather_np(vpad, device, group)
    return out_rows, [g_vals[h, :int(counts[h])] for h in range(n)]


class FeatureStats:
    """Per-row show counters with daily decay: feature lifecycle
    bookkeeping, a copy of the JAX package's (numpy only).

    The reference keeps show/click statistics inside the PS accessor
    (DownpourCtrDymfAccessor) and evicts features whose decayed score falls
    under delete_threshold or that stay unseen delete_after_unseen_days.
    Here the stats live on the host (one float and one int per physical
    table row) and eviction zeroes the rows of the table and its optimizer
    moments.

    ``track_base=True`` (dp > 1) keeps a snapshot of ``show`` at the last
    merge, so that ``local_delta``/``apply_global`` exchange only the rows
    observed since: each dp row sees only its own batches, and eviction and
    the saved stats act on the merged view.
    """

    def __init__(self, num_rows: int, decay: float = 0.98,
                 delete_threshold: float = 0.8,
                 delete_after_unseen_days: int = 30,
                 track_base: bool = False):
        self.show = np.zeros((num_rows,), np.float32)
        self.unseen_days = np.zeros((num_rows,), np.int32)
        # rows the table has hosted: only these may be evicted (never-seen
        # rows keep their random init, as the reference PS evicts only
        # features that exist in its table)
        self.seen = np.zeros((num_rows,), bool)
        self.decay = decay
        self.delete_threshold = delete_threshold
        self.delete_after_unseen_days = delete_after_unseen_days
        self._show_base = self.show.copy() if track_base else None

    def observe(self, rows: np.ndarray) -> None:
        u, c = np.unique(rows.reshape(-1), return_counts=True)
        self.observe_unique(u, c)

    def observe_unique(self, u: np.ndarray, c: np.ndarray) -> None:
        """observe() for deduplicated rows: O(batch), not O(table)."""
        self.show[u] += c
        self.unseen_days[u] = -1  # reset at end_day (+1 → 0)
        self.seen[u] = True

    def end_day(self) -> np.ndarray:
        """Apply the decay; return the row ids to evict (seen rows only)."""
        self.show *= self.decay
        self.unseen_days += 1
        evict = self.seen & (
            (self.show < self.delete_threshold)
            | (self.unseen_days > self.delete_after_unseen_days)
        )
        evict_rows = np.nonzero(evict)[0]
        self.show[evict] = 0.0
        self.unseen_days[evict] = 0
        self.seen[evict] = False
        if self._show_base is not None:
            self._show_base = self.show.copy()
        return evict_rows

    def local_delta(self):
        """(rows, show increments) observed since the last merge: observe()
        only adds, so the rows changed against the base are exactly those
        observed."""
        rows = np.nonzero(self.show != self._show_base)[0]
        return rows, (self.show[rows] - self._show_base[rows]).astype(np.float32)

    def apply_global(self, rows_by_host, deltas_by_host) -> None:
        """Replace the local view with the merged one: show = base + every
        host's increments; rows any host observed count as seen today."""
        show = self._show_base
        for r, d in zip(rows_by_host, deltas_by_host):
            if len(r):
                show[r] += d  # per-host rows are unique
        self.show = show
        touched = [r for r in rows_by_host if len(r)]
        if touched:
            allr = np.unique(np.concatenate(touched))
            self.unseen_days[allr] = -1
            self.seen[allr] = True
        self._show_base = self.show.copy()

    def save(self, path: str) -> None:
        np.savez(path, show=self.show, unseen_days=self.unseen_days, seen=self.seen)

    def load(self, path: str) -> None:
        z = np.load(path)
        self.show = z["show"]
        self.unseen_days = z["unseen_days"]
        self.seen = z["seen"]
        if self._show_base is not None:
            self._show_base = self.show.copy()


def _flax_name(key: str) -> str:
    return key.replace(".", "/")


def _tensor_leaves(tree, prefix: str = ""):
    """(flax-form path, tensor) of every tensor in a nested dict (an
    optimizer state: its keys are state_dict names)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            key = _flax_name(str(k))
            yield from _tensor_leaves(v, f"{prefix}/{key}" if prefix else key)


class OnlineTrainer(Trainer):
    """Day/pass streaming trainer with donefile-based exactly-once passes.
    ``device`` as ``Trainer``'s: ``cuda`` unless the CPU is asked for."""

    def __init__(self, config: Config, model_def=None, device=None):
        if config.runner("use_host_table"):
            # the JAX online loop ignores the key and trains its device
            # table; composing the day/pass loop with the host tier is not
            # part of either package, so the port refuses it by name
            raise NotImplementedError(
                "runner.use_host_table is not ported to the online loop of "
                "paddlerec_tpu_torch (use tools/train.py's HostTableTrainer)")
        super().__init__(config, model_def=model_def, device=device)
        raw_days = config.runner("days", "")
        if isinstance(raw_days, (list, tuple)):
            self.days = [str(d) for d in raw_days] or None
        else:
            self.days = [str(d) for d in str(raw_days).split()] or None
        self.start_day = str(config.runner("start_day", "20240101"))
        self.end_day = str(config.runner("end_day", self.start_day))
        self.split_interval = int(config.runner("split_interval", 5))
        self.split_per_pass = int(config.runner("split_per_pass", 1))
        self.checkpoint_per_pass = int(config.runner("checkpoint_per_pass", 6))
        self.save_delta_frequency = int(config.runner("save_delta_frequency", 6))
        # wall time by phase of the loop: prepare / infer / train / publish
        self.phase_times: Dict[str, float] = {}
        self.save_first_base = bool(config.runner("save_first_base", False))
        self.data_donefile = config.runner("data_donefile", "")
        self.data_sleep_second = float(config.runner("data_sleep_second", 1))
        self.data_wait_timeout = float(config.runner("data_wait_timeout", 0))
        self.infer_before_train = bool(config.runner("infer_first", True))
        self.pass_intervals = get_online_pass_interval(
            self.split_interval,
            self.split_per_pass,
            bool(config.runner("data_hourly_placed", False)),
        )
        # per-table feature lifecycle and delta bookkeeping, by table name
        self.stats: Optional[Dict[str, FeatureStats]] = None
        self._feature_lifecycle = bool(config.runner("feature_lifecycle", True))
        # rows touched since the last published base or delta: name → mask
        self._touched: Optional[Dict[str, np.ndarray]] = None
        self._untracked_warned: set = set()
        self.global_shuffle = bool(config.runner("global_shuffle", False))
        self.prefetch_next_pass = bool(config.runner("prefetch", False))
        self._prefetch_thread = None
        self._prefetched = None  # (key, dataset)

    # -- donefile protocol -----------------------------------------------------
    def _donefile(self) -> str:
        root = resolve_path(self.config, "runner.model_save_path")
        get_fs(root).mkdir(root)
        return os.path.join(root, "online_donefile.txt")

    def _records(self) -> List[dict]:
        path = self._donefile()
        fs = get_fs(path)
        if not fs.exists(path):
            return []
        return [json.loads(l) for l in fs.read_text(path).splitlines() if l.strip()]

    def last_done(self):
        """The last record of the online donefile ({"day", "pass", "path",
        "kind", "ts"}), or None."""
        records = self._records()
        return records[-1] if records else None

    def write_done(self, day: str, pass_id: int, path: str, kind: str) -> None:
        if self.rank != 0:
            return  # one writer: concurrent appends duplicate or interleave
        done = self._donefile()
        get_fs(done).append_line(done, json.dumps(
            {"day": day, "pass": pass_id, "path": path, "kind": kind, "ts": time.time()}))

    # -- data gating ---------------------------------------------------------------
    def wait_for_data(self, pass_dir: str) -> bool:
        fs = get_fs(pass_dir)
        if not self.data_donefile:
            return fs.isdir(pass_dir)
        marker = os.path.join(pass_dir, self.data_donefile)
        waited = 0.0
        while not fs.exists(marker):
            if self.data_wait_timeout and waited >= self.data_wait_timeout:
                return False
            time.sleep(self.data_sleep_second)
            waited += self.data_sleep_second
        return True

    def _data_ready_now(self, pass_dir: str) -> bool:
        """Non-blocking readiness check (prefetch never reads a pass whose
        data donefile is absent: a producer may still be writing it)."""
        fs = get_fs(pass_dir)
        if not self.data_donefile:
            return fs.isdir(pass_dir)
        return fs.exists(os.path.join(pass_dir, self.data_donefile))

    # -- feature lifecycle ------------------------------------------------------------
    def _embedding_entries(self):
        """[(name, table)] for every embedding table of the module, by its
        flax-form name, in the JAX package's order (the flattened tree's,
        sorted by path).  A sharded table is this rank's shard."""
        entries = [(_flax_name(k), p) for k, p in self.state.module.named_parameters()
                   if is_embedding_path(k) and p.dim() >= 2]
        return sorted(entries, key=lambda e: e[0].split("/"))

    def _is_sharded(self, name: str) -> bool:
        return name.replace("/", ".") in self._sharded

    def _table_rows(self, name: str, table: torch.Tensor) -> int:
        """The rows of the whole table: a shard's rows times mp (the engine's
        padded table), else its own."""
        return table.shape[0] * (self.mesh.mp if self._is_sharded(name) else 1)

    def _ensure_tracking(self) -> bool:
        """Allocate the per-table touched masks and lifecycle stats once."""
        if self._touched is not None:
            return bool(self._touched)
        entries = self._embedding_entries()
        self._touched = {}
        self.stats = {}
        for name, table in entries:
            rows = self._table_rows(name, table)
            self._touched[name] = np.zeros(rows, bool)
            if self._feature_lifecycle:
                self.stats[name] = self._make_stats(rows)
        if not entries:
            self._feature_lifecycle = False
        return bool(entries)

    def _make_stats(self, rows: int) -> FeatureStats:
        return FeatureStats(
            rows,
            decay=float(self.config.get("table_parameters.show_click_decay_rate", 0.98)),
            delete_threshold=float(self.config.get("table_parameters.delete_threshold", 0.8)),
            delete_after_unseen_days=int(self.config.get(
                "table_parameters.delete_after_unseen_days", 30)),
            # each dp row observes only its own batches: the stats merge to
            # the global view before eviction and persistence
            track_base=self.mesh.dp > 1,
        )

    def _merge_stats_global(self) -> None:
        """A collective: merge the dp rows' lifecycle stats into the same
        global view on every rank, over the dp group (the mp ranks of a row
        observed the same batches).  The bytes follow the rows observed since
        the last merge, never the table's."""
        if self.mesh.dp <= 1 or not self.stats:
            return
        for name in sorted(self.stats):
            st = self.stats[name]
            rows, delta = st.local_delta()
            g_rows, g_vals = _allgather_sparse(rows, delta, self.mesh.dp_group,
                                               self._comm_device)
            st.apply_global(g_rows, g_vals)

    def _observing(self, dataset):
        """Wrap a host-batch iterator: the feed's dedup of a sparse run, then
        the rows each batch touches are recorded, before the batch is staged
        to the device.  It runs where the feed pulls it, in the feed's
        thread; the loop reads the bookkeeping only after the pass."""
        for batch in dataset:
            if self.sparse:
                batch = self.model_def.augment_batch_host(batch)
            self._observe_batch(batch)
            yield batch

    def _warn_untracked(self, name: str, why: str) -> None:
        if name in self._untracked_warned:
            return
        self._untracked_warned.add(name)
        logger.warning(
            f"table {name!r} gets NO touched-row bookkeeping ({why}); its "
            "deltas and eviction are skipped: override "
            "ModelDef.touched_tables to map batches onto it")

    def _batch_rows_by_table(self, batch) -> Optional[Dict[str, np.ndarray]]:
        if not self._ensure_tracking():
            return None
        return batch_rows_by_table(
            self.model_def, batch,
            {name: len(mask) for name, mask in self._touched.items()},
            warn=self._warn_untracked)

    @staticmethod
    def _unique_rows(batch, rows: np.ndarray):
        """(unique rows, counts) of ``rows``: from the batch's
        ``sparse_uniq``/``sparse_slot`` where they dedup exactly these rows
        (the sort is then already done), else ``np.unique``."""
        uniq, slot = batch.get("sparse_uniq"), batch.get("sparse_slot")
        if uniq is not None and slot is not None and slot.size == rows.size:
            n = int(np.searchsorted(uniq, SENTINEL))
            if np.array_equal(uniq[slot], rows):
                return uniq[:n].astype(np.int64), np.bincount(slot, minlength=n)[:n]
        return np.unique(rows, return_counts=True)

    def _observe_batch(self, batch) -> None:
        rows_by_table = self._batch_rows_by_table(batch)
        if not rows_by_table:
            return
        for name, rows in rows_by_table.items():
            # dedup once per table: the touched mask and the show counters
            # index by unique rows
            u, c = self._unique_rows(batch, rows.reshape(-1))
            # the delta publishes the rows touched since the last artifact,
            # whether or not the lifecycle runs
            self._touched[name][u] = True
            if self._feature_lifecycle and name in self.stats:
                self.stats[name].observe_unique(u, c)

    @staticmethod
    def _stats_key(name: str) -> str:
        return name.replace("/", "__")

    def _write_stats_npz(self, path: str) -> None:
        arrays = {}
        for name, st in (self.stats or {}).items():
            k = self._stats_key(name)
            arrays[f"{k}--show"] = st.show
            arrays[f"{k}--unseen_days"] = st.unseen_days
            arrays[f"{k}--seen"] = st.seen
        np.savez(path, **arrays)

    def _read_stats_npz(self, path: str) -> None:
        z = np.load(path)
        for name, st in (self.stats or {}).items():
            k = self._stats_key(name)
            if f"{k}--show" in z.files:
                st.show = z[f"{k}--show"]
                st.unseen_days = z[f"{k}--unseen_days"]
                st.seen = z[f"{k}--seen"]
                if st._show_base is not None:
                    # every rank restores the same merged stats: a merge point
                    st._show_base = st.show.copy()

    def _save_stats(self, save_root: str, tag: str) -> None:
        """A collective across processes: the stats merge to the global view,
        then rank 0 alone writes them."""
        if not self.stats:
            return
        self._merge_stats_global()
        if self.rank == 0:
            self._write_stats_npz(os.path.join(save_root, f"{tag}_stats.npz"))

    def _load_stats(self, save_root: str, tag: str) -> None:
        src = os.path.join(save_root, f"{tag}_stats.npz")
        if get_fs(src).exists(src) and self._ensure_tracking():
            self._read_stats_npz(src)

    def shrink(self) -> int:
        """Evict stale feature rows per table: zero the table's rows and
        its optimizer moments (matched by name, never by row count: two
        tables may share one).  A collective across processes: the stats
        merge first, so every rank evicts the same rows."""
        if not self.stats:
            return 0
        self._merge_stats_global()
        total = 0
        for name, st in self.stats.items():
            evict_rows = st.end_day()
            if len(evict_rows) == 0:
                continue
            total += len(evict_rows)
            self._zero_table_rows(name, evict_rows)
            rank0_info(f"shrink: evicted {len(evict_rows)} stale rows from {name}")
        return total

    @torch.no_grad()
    def _zero_table_rows(self, name: str, evict_rows: np.ndarray) -> None:
        n_rows = len(self._touched[name])
        if self._is_sharded(name):
            # this rank's rows of the shard, and everything of it is a shard
            n_rows //= self.mesh.mp
            lo = self.mesh.mp_index * n_rows
            evict_rows = evict_rows[(evict_rows >= lo) & (evict_rows < lo + n_rows)] - lo
        rows = torch.as_tensor(evict_rows, dtype=torch.long, device=self.device)
        scope = name.rsplit("/", 1)[0]  # the module that owns the table

        def match(path: str, t: torch.Tensor) -> bool:
            # an exact component-suffix match: `name in path` would also hit
            # another table whose path merely contains this name
            # ('user_emb/embedding' against 'emb/embedding')
            return ((path == name or path.endswith("/" + name))
                    and t.dim() >= 1 and t.shape[0] == n_rows)

        for key, param in self.state.module.named_parameters():
            if match(_flax_name(key), param):
                param[rows] = 0
        # the optimizer's moments are keyed by the parameters' names
        for path, t in _tensor_leaves(self.state.opt_state):
            if match(path, t):
                t[rows] = 0
        # a sparse run's row state is keyed "<scope>/embedding_delta"
        for key, row_state in (self.state.extra or {}).items():
            if key.rsplit("/", 1)[0] == scope:
                for t in row_state:
                    if t.dim() >= 1 and t.shape[0] == n_rows:
                        t[rows] = 0

    # -- delta publishing -----------------------------------------------------
    def _union_touched(self, mask: np.ndarray) -> np.ndarray:
        """The union of the dp rows' touched rows (each observed only its own
        batches): a collective over the dp group that ships the row ids,
        never the mask.  The mask itself at dp = 1."""
        if self.mesh.dp <= 1:
            return mask
        g_rows, _ = _allgather_sparse(np.nonzero(mask)[0], None, self.mesh.dp_group,
                                      self._comm_device)
        union = np.zeros_like(mask)
        for r in g_rows:
            union[r] = True
        return union

    @torch.no_grad()
    def _gather_rows(self, name: str, table: torch.Tensor, rows: np.ndarray) -> np.ndarray:
        """float32 values of the ascending ``rows`` of a table on the device,
        as a host array: one K1 launch (clip mode; float32 out of a bfloat16
        table).  A sharded table's: each rank of the mesh row gathers the
        rows of its shard, and the row's parts, padded to the largest, are
        gathered in mp order (a collective over the row)."""
        if not self._is_sharded(name):
            idx = torch.from_numpy(rows.astype(np.int32)).to(self.device)
            return take_rows(table.detach(), idx, out_dtype=torch.float32).cpu().numpy()
        per, mp = table.shape[0], self.mesh.mp
        bounds = np.searchsorted(rows, np.arange(mp + 1) * per)
        cap = int(np.diff(bounds).max())
        mine = rows[bounds[self.mesh.mp_index]:bounds[self.mesh.mp_index + 1]]
        part = torch.zeros((cap, table.shape[1]), dtype=torch.float32, device=self.device)
        if len(mine):
            idx = torch.from_numpy((mine - self.mesh.mp_index * per).astype(np.int32))
            part[:len(mine)] = take_rows(table.detach(), idx.to(self.device),
                                         out_dtype=torch.float32)
        parts = _all_gather(part, self.mesh).reshape(mp, cap, -1).cpu().numpy()
        return np.concatenate([parts[k, :bounds[k + 1] - bounds[k]] for k in range(mp)])

    def save_delta(self, save_root: str, tag: str) -> str:
        """Mode-1 delta: publish only the rows touched since the last
        published artifact, as cube KV shards (logical id → vector) with
        ``delta_meta.json``; a table of another layout as
        ``<name>_delta.npz``.  The artifact's size is proportional to the
        touched rows.  A collective across processes (the union of the dp
        rows' touched rows, the shards' gathers); rank 0 alone writes."""
        out_dir = os.path.join(save_root, tag)
        vocab = getattr(self.model_def, "vocab_size", None) or int(
            self.config.hyper("sparse_feature_number", 0))
        dim = int(getattr(self.model_def, "sparse_embed_logical_dim",
                          int(self.config.hyper("sparse_feature_dim", 9))))
        primary = self.rank == 0
        if primary:
            os.makedirs(out_dir, exist_ok=True)
        meta = {"rows_touched": 0, "vocab": int(vocab), "dim": dim, "tables": []}
        shards = int(self.config.runner("delta_cube_shards", 1))
        # every table publishes its own touched rows; tables without
        # bookkeeping were warned about when the batches were mapped
        for name, table in self._embedding_entries():
            mask = (self._touched or {}).get(name)
            if mask is None or self._table_rows(name, table) != len(mask):
                self._warn_untracked(name, "no touched mask at delta time")
                continue
            rows = np.nonzero(self._union_touched(mask))[0]
            meta["rows_touched"] += int(len(rows))
            fname = name.replace("/", "_")
            if len(rows) == 0:
                meta["tables"].append({"name": fname, "keys": 0})
                continue
            sub = self._gather_rows(name, table, rows)
            if not primary:
                continue
            if sub.ndim == 2 and sub.shape[1] == 128 and vocab:
                # packed physical rows → logical (id, vector) pairs
                w = sub_width(dim)
                pack = 128 // w
                vals = sub.reshape(-1, pack, w)[:, :, :dim].reshape(-1, dim)
                keys = (rows[:, None] * pack + np.arange(pack)[None, :]).reshape(-1)
                keep = keys < vocab
                export_table(os.path.join(out_dir, fname), keys[keep].astype(np.int64),
                             np.ascontiguousarray(vals[keep]), shards)
                meta["tables"].append({"name": fname, "keys": int(keep.sum()),
                                       "format": "cube"})
            else:
                # another layout: the raw touched rows
                np.savez_compressed(os.path.join(out_dir, f"{fname}_delta.npz"),
                                    rows=rows, values=sub)
                meta["tables"].append({"name": fname, "keys": int(len(rows)),
                                       "format": "npz"})
        if primary:
            with open(os.path.join(out_dir, "delta_meta.json"), "w") as f:
                json.dump(meta, f)
        self._clear_touched()  # the next delta counts from here (every rank)
        return out_dir

    def _clear_touched(self) -> None:
        for mask in (self._touched or {}).values():
            mask[:] = False

    # -- global shuffle + pass prefetch ---------------------------------------
    def _prepare_pass(self, dirs: List[str], seed: int):
        """Materialize a pass (the InMemoryDataset.load_into_memory analog).

        With ``runner.global_shuffle`` every dp row reads all the pass's
        files and keeps their rows ``[dp_index::dp]`` (the dataset's
        global_shuffle redistribution, decided alike everywhere), then
        permutes them from ``seed + dp_index``; without it the directories'
        datasets chain (the dp row's file shard), and read their files as the
        feed pulls them.  Reads files only: no device work."""
        batch_size = int(self.config.runner("train_batch_size", 32))
        if not self.global_shuffle:
            return _ChainDataset([self.make_dataset(d, batch_size)
                                  for d in dirs if get_fs(d).isdir(d)])
        from paddlerec_tpu_torch.data.schema import schema_from_config
        from paddlerec_tpu_torch.data.slot_reader import list_data_files

        schema = schema_from_config(self.config)
        rank, nproc = self._data_shard()
        labels, sparse, dense = [], [], []
        for d in dirs:
            if not get_fs(d).isdir(d):
                continue
            for f in list_data_files(d):
                la, sp, de = self._load_rows(f, schema)
                labels.append(la[rank::nproc])
                sparse.append(sp[rank::nproc])
                dense.append(de[rank::nproc] if de is not None else None)
        if not labels:
            return _ChainDataset([])
        la = np.concatenate(labels)
        sp = np.concatenate(sparse)
        de = (np.concatenate([d for d in dense if d is not None])
              if any(d is not None for d in dense) else None)
        perm = np.random.RandomState(seed + rank).permutation(len(la))
        return _ArrayDataset(la[perm], sp[perm], de[perm] if de is not None else None,
                             batch_size)

    def _load_rows(self, path: str, schema):
        """(labels, sparse (N, S), dense or None) of one data file: a
        slotbin file, or slot text in the standard schema (click,
        dense_feature, slots 1..S)."""
        from paddlerec_tpu_torch.data.binary import SlotBinFile, is_slotbin
        from paddlerec_tpu_torch.data.schema import SlotSchema
        from paddlerec_tpu_torch.data.slot_reader import parse_slot_lines

        if path.endswith(".bin") and is_slotbin(path):
            f = SlotBinFile(path)
            sp = np.asarray(f.sparse)
            if sp.ndim == 3 and sp.shape[2] == 1:
                sp = sp[:, :, 0]
            return (np.asarray(f.labels), sp,
                    np.asarray(f.dense) if f.dense is not None else None)
        num_sparse, dense_dim = schema.num_sparse, schema.dense_dim
        std = SlotSchema(
            label_slot="click",
            sparse_slots=[str(i) for i in range(1, num_sparse + 1)],
            dense_slots=["dense_feature"] if dense_dim else [],
            dense_dims=[dense_dim] if dense_dim else [],
        )
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        arrays = parse_slot_lines(lines, std)
        return arrays["label"], arrays["sparse"][:, :, 0], arrays.get("dense")

    def _next_pass_key(self, day_idx: int, pass_id: int, days: List[str]):
        """(day, pass, dirs) of the pass after (day_idx, pass_id), or None."""
        data_root = resolve_path(self.config, "runner.train_data_dir")
        p, d = pass_id + 1, day_idx
        if p >= len(self.pass_intervals):
            p, d = 0, d + 1
        if d >= len(days):
            return None
        return (days[d], p, [os.path.join(data_root, days[d], s)
                             for s in self.pass_intervals[p]])

    def _start_prefetch(self, key, dirs, seed: int) -> None:
        """Overlap the next pass's parse and load with this pass's training.
        Starts only when every interval of the next pass is ready already;
        otherwise the gated path loads it later.  The thread reads files
        and makes no tensor."""
        if not all(self._data_ready_now(d) for d in dirs):
            return

        def work():
            try:
                self._prefetched = (key, self._prepare_pass(dirs, seed))
            except Exception as e:  # raised when the pass is consumed
                self._prefetched = (key, e)

        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    def _take_prefetched(self, key):
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()
            self._prefetch_thread = None
        if self._prefetched and self._prefetched[0] == key:
            ds = self._prefetched[1]
            self._prefetched = None
            if isinstance(ds, Exception):
                raise ds
            return ds
        return None

    # -- pass/day loops -------------------------------------------------------------
    def _day_list(self) -> List[str]:
        if self.days:
            return self.days
        days = []
        d = datetime.strptime(self.start_day, "%Y%m%d")
        end = datetime.strptime(self.end_day, "%Y%m%d")
        while d <= end:
            days.append(d.strftime("%Y%m%d"))
            d += timedelta(days=1)
        return days

    def _phase(self, name: str, seconds: float) -> None:
        self.phase_times[name] = self.phase_times.get(name, 0.0) + seconds

    def save_base(self, save_root: str, tag: str) -> Optional[str]:
        """A mode-2 base (the parameters only) under save_root/tag.  Across
        processes every rank takes part (the sharded tables gathered whole
        over mp) and rank 0 writes; returns the path there, None on the
        other ranks."""
        params = self._whole(self.state.module.state_dict(), self._sharded)
        path = (ckpt_lib.save_params_only(params, save_root, tag)
                if self.rank == 0 else None)
        if self.world > 1:
            dist.barrier()  # the file is whole before any rank reads it
        return path

    def train_pass(self, pass_dir, day: str, pass_id: int,
                   dataset=None) -> Dict[str, float]:
        dirs = [pass_dir] if isinstance(pass_dir, str) else list(pass_dir)
        t_prep = time.time()
        if dataset is None:
            dataset = self._prepare_pass(
                dirs, seed=int(self.config.runner("seed", 2023)) + pass_id)
        self._phase("prepare", time.time() - t_prep)

        # join-time eval before training on the pass (online AUC).  The
        # infer leg is also the staging pass: its device batches stay on the
        # device and the train leg replays them, so the pass crosses the
        # host→device link once, unless it exceeds runner.resident_max_gb.
        # Row observation rides the same single host iteration.
        staged = None
        ran_infer = False
        if self.infer_before_train and self.use_auc:
            ran_infer = True
            t0 = time.time()
            cap = float(self.config.runner("resident_max_gb", 8.0)) * (1 << 30)
            staged, staged_bytes = [], 0
            # wait on the metric chain every N superbatches, so that progress
            # is observable and the queue of launched work stays shallow
            sync_every = int(self.config.runner("infer_sync_superbatches", 8))
            n_super = 0
            metric_state = self._init_metric_state()
            for batch in self._device_batches(self._observing(dataset), allow_super=True,
                                              augment=True):
                if isinstance(batch, tuple):  # (superbatch, index)
                    sb, idx = batch
                    metric_state, _ = self.infer_super(sb, idx, metric_state)
                    if idx == 0:
                        n_super += 1
                        if sync_every and n_super % sync_every == 0:
                            self._sync()
                            rank0_info(f"[day {day} pass {pass_id}] online eval "
                                       f"staged superbatch {n_super}")
                        if staged is not None:
                            staged_bytes += self._device_bytes(sb)
                            staged.append(("super", sb))
                else:
                    metric_state, _ = self.infer_step(batch, metric_state)
                    if staged is not None:
                        staged_bytes += self._device_bytes(batch)
                        staged.append(("plain", batch))
                if staged is not None and staged_bytes > cap:
                    staged = None  # the pass does not fit: restage below
                    logger.warning("online pass exceeds resident_max_gb: the train "
                                   "leg restages over the link")
            m = self._compute_metrics(metric_state)
            rank0_info(f"[day {day} pass {pass_id}] "
                       + metrics_lib.metrics_str(m, "online eval (pre-train)"))
            self._phase("infer", time.time() - t0)

        t0 = time.time()
        metric_state = self._init_metric_state()
        if staged is not None:
            # replay the infer leg's device batches: no link traffic
            for kind, b in staged:
                if kind == "super":
                    for i in range(int(next(iter(b.values())).shape[0])):
                        metric_state, _ = self.super_step(b, i, metric_state)
                else:
                    metric_state, _ = self.train_step(b, metric_state)
            staged = None  # release the device memory before publishing
        else:
            # observation already happened on the infer leg if it ran
            source = dataset if ran_infer else self._observing(dataset)
            for batch in self._device_batches(source, allow_super=True, augment=True):
                if isinstance(batch, tuple):  # (superbatch, index)
                    metric_state, _ = self.super_step(*batch, metric_state)
                else:
                    metric_state, _ = self.train_step(batch, metric_state)
        metrics = self._compute_metrics(metric_state) if self.use_auc else {}
        self._phase("train", time.time() - t0)
        if self.use_auc:
            rank0_info(f"[day {day} pass {pass_id}] "
                       + metrics_lib.metrics_str(metrics, "train"))
        return metrics

    def run(self) -> Dict[str, float]:
        save_root = resolve_path(self.config, "runner.model_save_path")
        data_root = resolve_path(self.config, "runner.train_data_dir")
        if self.state is None:
            self.init_state()
        # resume: the last checkpoint record restores the state and gates
        # which passes are done; delta and base records are published
        # artifacts, not resume points
        ckpts = [r for r in self._records() if r["kind"] == "checkpoint"]
        done = ckpts[-1] if ckpts else None
        if done:
            rank0_info(f"resuming state from {done['path']}")
            tag = os.path.basename(done["path"])
            self.load_checkpoint(save_root, tag)
            self._load_stats(save_root, tag)
        last_metrics: Dict[str, float] = {}
        first = True
        seed = int(self.config.runner("seed", 2023))
        for day in self._day_list():
            trained_this_day = False
            for pass_id, pass_dirs in enumerate(self.pass_intervals):
                if done and (day < done["day"]
                             or (day == done["day"] and pass_id <= done["pass"])):
                    continue  # already trained (exactly once per donefile)
                # a pass may span several split intervals: train them all,
                # once every one of them is ready
                dirs = [os.path.join(data_root, day, d) for d in pass_dirs]
                if not all(self.wait_for_data(d) for d in dirs):
                    continue  # no (complete) data for this pass
                if first and self.save_first_base:
                    path = self.save_base(save_root, f"base_{day}")
                    self.write_done(day, -1, path, "base")
                first = False

                # take the dataset the previous pass prefetched; start the
                # next pass's prefetch before training this one
                dataset = self._take_prefetched((day, pass_id))
                if self.prefetch_next_pass:
                    days = self._day_list()
                    nxt = self._next_pass_key(days.index(day), pass_id, days)
                    if nxt is not None:
                        nday, npass, ndirs = nxt
                        self._start_prefetch((nday, npass), ndirs, seed=seed + npass)
                last_metrics = self.train_pass(dirs, day, pass_id, dataset=dataset)
                trained_this_day = True

                t_pub = time.time()
                if (pass_id + 1) % self.checkpoint_per_pass == 0:
                    tag = f"ckpt_{day}_{pass_id}"
                    path = self.save_checkpoint(save_root, tag)
                    if self.stats is not None:
                        # the feature lifecycle survives restarts (the
                        # reference keeps show/click in the PS table)
                        self._save_stats(save_root, tag)
                    self.write_done(day, pass_id, path, "checkpoint")
                if (pass_id + 1) % self.save_delta_frequency == 0:
                    path = self.save_delta(save_root, f"delta_{day}_{pass_id}")
                    self.write_done(day, pass_id, path, "delta")
                self._phase("publish", time.time() - t_pub)
            # end of day: shrink and base, but never republish a day whose
            # passes were all skipped on resume
            if not trained_this_day:
                continue
            self.shrink()
            path = self.save_base(save_root, f"base_{day}")
            self._clear_touched()  # deltas count from this base
            self.write_done(day, len(self.pass_intervals) - 1, path, "base")
        if self.phase_times:
            rank0_info("online loop phase breakdown: " + json.dumps(
                {k: round(v, 1) for k, v in sorted(self.phase_times.items())}))
            last_metrics = dict(last_metrics)
            for k, v in self.phase_times.items():
                last_metrics[f"phase_{k}_s"] = round(v, 2)
        return last_metrics
