"""HostTableTrainer: the GPUBox/HeterPS pass loop, reachable from the CLI.

Counterpart of ``paddlerec_tpu/train/host_loop.py``.  The reference's GPU
parameter server trains tables larger than device memory by building a
per-pass device cache of exactly the rows the pass touches
(``PSGPU.begin_pass/end_pass``), with the full table and the per-feature
optimizer state in host memory:

  * the FULL packed table and its per-row adagrad accumulator persist in
    host RAM (``parallel/host_table.py`` ``HostTieredTable``: lazily
    materialized rows, show decay and shrink, an optional mmap spill tier);
  * each pass (``runner.files_per_pass`` data files) gathers its unique
    physical rows, copies them into ONE preallocated ``(cap, 128)`` cache
    on the device (the inner trainer's table, in its dtype) and translates
    the batches' ids into cache slots on the host;
  * inside the pass the trainer's own sparse step runs on the cache:
    K1 looks the cache up and K1b sums its per-row gradient for the
    row-wise adagrad;
  * ``end_pass`` writes the trained rows and accumulator back to host RAM.

Enable from any CTR config with one fused slot table::

    runner:
      use_host_table: true
      host_table_cache_rows: 262144   # >= unique physical rows per pass
      files_per_pass: 1

The table's capacity is then bounded by host memory, while the device holds
only the per-pass working set.  More than one process (``tools.launch``)
raises the JAX package's ``ValueError``: the host tier is per-process state.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlerec_tpu_torch.core.config import Config, resolve_path
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.data.wire import WireEncoder
from paddlerec_tpu_torch.ops.packed_embedding import sub_width
from paddlerec_tpu_torch.parallel.host_table import HostTieredTable
from paddlerec_tpu_torch.parallel.mesh import world_size
from paddlerec_tpu_torch.train import checkpoint as ckpt_lib
from paddlerec_tpu_torch.train.trainer import Trainer, _count_uniq, logger

# rows of the cache copied to the device at a time: bounds the float32
# staging copy on the device (128 MiB) while the table's dtype may be bf16
_UPLOAD_ROWS = 1 << 18


class HostTableTrainer:
    def __init__(self, config: Config, device=None):
        from paddlerec_tpu_torch.core.registry import load_model_def

        self.config = config
        if world_size() > 1:
            # each rank's tier would train on its own file shard and diverge:
            # the table and its accumulator are per-process host state
            raise ValueError(
                "use_host_table does not compose with multi-process "
                "training: the host tier (table + adagrad accumulator) "
                "is per-process state, so each host would train a "
                "diverging copy on its own file shard. Run host-table "
                "mode single-process (it exists for host-RAM capacity, "
                "not dp scale), or use sparse_update + multi-host dp for "
                "distributed big-vocab training."
            )
        self.vocab = int(config.hyper("sparse_feature_number", 1000001))
        self.cap_rows = int(config.runner("host_table_cache_rows", 1 << 18))
        self.files_per_pass = int(config.runner("files_per_pass", 1))

        # the inner model sees the CACHE as its table: vocab' = cap*pack, so
        # its packed table has exactly cap physical rows
        probe_md = load_model_def(config)
        dim = int(getattr(
            probe_md, "sparse_embed_logical_dim",
            int(config.hyper("sparse_feature_dim", 9)),
        ))
        self.pack = 128 // sub_width(dim)
        inner_cfg = config.copy()
        inner_cfg.update({
            "hyper_parameters.sparse_feature_number": self.cap_rows * self.pack,
            "hyper_parameters.sparse_update": True,
            # scalar per-row accumulator: ONE extra host array instead of two
            # full-table moments (the reference accessor's rule)
            "hyper_parameters.sparse_update_rule": "adagrad",
        })
        self.trainer = Trainer(inner_cfg, device=device)
        self.device = self.trainer.device
        self.phys_rows = (self.vocab + self.pack - 1) // self.pack
        # host tier: packed physical rows + per-row optimizer state;
        # host_table_ram_rows caps RAM residency and spills cold rows to an
        # mmap file (the SSD tier)
        ram_rows = config.runner("host_table_ram_rows")
        spill_dir = config.runner("host_table_spill_dir")
        self.table = HostTieredTable(
            self.phys_rows, 128,
            seed=int(config.runner("seed", 2023)),
            init_scale=1e-2,
            show_decay=float(config.runner("show_decay", 0.98)),
            ram_rows=int(ram_rows) if ram_rows is not None else None,
            spill_path=(os.path.join(str(spill_dir), "table_spill.npy")
                        if spill_dir else None),
        )
        self.prefetch_on = bool(config.runner("host_table_prefetch", True))
        self.host_acc = np.zeros(self.phys_rows, np.float32)
        self._tap = None  # (row-state key, the tapped SlotEmbedding)
        # one record a pass: its rows, the host tiers' rows after it and the
        # seconds of its stages (host clock; the device's work is waited for)
        self.pass_log: List[Dict[str, float]] = []

    # -- plumbing -------------------------------------------------------------
    def _find_tap(self):
        taps = self.trainer.model_def.sparse_taps(self.trainer.state.module)
        if len(taps) != 1:
            raise ValueError(
                "use_host_table requires a model with exactly one fused "
                f"slot table (found {len(taps)} taps); got model "
                f"{self.config.runner('model')}"
            )
        return next(iter(taps.items()))

    def _swap_in_pass(self, pass_rows: np.ndarray) -> Dict[str, float]:
        """begin_pass: copy the pass's rows and accumulator into the cache.
        Rows ``[u:]`` are zeros, as the JAX package's padded cache.  Returns
        the seconds of the host table's ``begin_pass`` and of the upload."""
        t0 = time.perf_counter()
        cache = self.table.begin_pass(pass_rows)  # (U, 128) float32, host
        t1 = time.perf_counter()
        u = len(pass_rows)
        key, emb = self._tap
        table = emb.embedding
        acc = self.trainer.state.extra[key].acc
        with torch.no_grad():
            for s in range(0, u, _UPLOAD_ROWS):
                e = min(s + _UPLOAD_ROWS, u)
                # copy_ casts on the device: float32 → bf16 rounds to
                # nearest even, as astype does
                table[s:e].copy_(torch.from_numpy(cache[s:e]).to(self.device))
            table[u:].zero_()
            acc[:u].copy_(torch.from_numpy(self.host_acc[pass_rows]).to(self.device))
            acc[u:].zero_()
        self.trainer._sync()
        return {"begin_pass_s": t1 - t0, "upload_s": time.perf_counter() - t1}

    def _flush_pass(self, pass_rows: np.ndarray) -> None:
        """end_pass: persist the trained cache rows and accumulator."""
        u = len(pass_rows)
        key, emb = self._tap
        with torch.no_grad():
            cache = emb.embedding[:u].float().cpu().numpy()
            acc = self.trainer.state.extra[key].acc[:u].cpu().numpy()
        self.table.end_pass(cache)
        self.host_acc[pass_rows] = acc

    def _translate_batch(self, batch: Dict[str, np.ndarray]):
        """Global ids → cache-local ids (slot*pack + sub-index)."""
        ids = np.asarray(batch["sparse"])
        logical = ids % self.vocab
        phys = logical // self.pack
        sub = logical % self.pack
        slots = self.table.translate(phys)
        return dict(batch, sparse=(slots.astype(np.int64) * self.pack + sub))

    # -- the pass loop (PSGPU begin_pass/train/end_pass) ----------------------
    def train(self) -> Dict[str, float]:
        from paddlerec_tpu_torch.data.slot_reader import list_data_files

        cfg = self.config
        t = self.trainer
        epochs = int(cfg.runner("epochs", 1))
        batch_size = int(cfg.runner("train_batch_size", 512))
        data_dir = resolve_path(cfg, "runner.train_data_dir")
        save_path = resolve_path(cfg, "runner.model_save_path")

        if t.state is None:
            t.init_state()
        if t.state.extra is None:
            raise ValueError(
                "use_host_table requires a sparse_update-capable model "
                "(no delta taps found)"
            )
        self._tap = self._find_tap()

        files = list_data_files(data_dir)
        fpp = max(self.files_per_pass, 1)
        passes = [files[i : i + fpp] for i in range(0, len(files), fpp)]
        # the pass loop rides the same compact wire and superbatch staging
        # as Trainer.train
        wire_enc = None
        if str(cfg.runner("wire_format", "")).lower() == "compact":
            wire_enc = WireEncoder(self.cap_rows * self.pack)
        super_k = int(cfg.runner("feed_superbatch", 0) or 0)
        last_metrics: Dict[str, float] = {}

        def _prepare(pass_files):
            """Parse one pass's files and its unique physical rows (the host
            half of the pass build).  Runs on a host thread for pass i+1
            while pass i trains."""
            batches = list(self._pass_dataset(pass_files, batch_size))
            if not batches:
                return None
            phys = np.unique(np.concatenate([
                ((np.asarray(b["sparse"]).reshape(-1) % self.vocab)
                 // self.pack)
                for b in batches
            ]))
            return batches, phys

        for epoch in range(epochs):
            metric_state = t._init_metric_state()
            epoch_begin = time.time()
            total = 0
            loss = None
            prep_wait_s = 0.0
            next_slot: Dict[int, object] = {}
            bg: Optional[threading.Thread] = None

            def _spawn(i):
                def work():
                    prep = _prepare(passes[i])
                    if prep is not None and self.prefetch_on:
                        self.table.prefetch(prep[1])
                    next_slot[i] = prep

                th = threading.Thread(target=work, daemon=True)
                th.start()
                return th

            t_wait = time.time()
            prep = _prepare(passes[0]) if passes else None
            for pass_id, pass_files in enumerate(passes):
                if pass_id > 0:
                    t_wait = time.time()
                    bg.join()
                    prep_wait_s += time.time() - t_wait
                    prep = next_slot.pop(pass_id)
                record = {"epoch": epoch, "pass": pass_id,
                          "prep_wait_s": time.time() - t_wait}
                if pass_id + 1 < len(passes):
                    bg = _spawn(pass_id + 1)
                if prep is None:
                    continue
                batches, phys = prep
                if len(phys) > self.cap_rows:
                    raise ValueError(
                        f"pass {pass_id} touches {len(phys)} physical rows "
                        f"> host_table_cache_rows {self.cap_rows}; raise "
                        "the cache or lower files_per_pass"
                    )
                record.update(self._swap_in_pass(phys))
                t_train = time.perf_counter()
                prepared = []
                for b in batches:
                    b = _count_uniq(t.model_def.augment_batch_host(
                        self._translate_batch(b)))
                    if wire_enc is not None:
                        b = wire_enc(b)
                    prepared.append(b)
                if super_k > 1 and len(prepared) > 1:
                    for sb, i in t._staged_superbatches(iter(prepared), super_k):
                        metric_state, loss = t.super_step(sb, i, metric_state)
                        # rows per sub-batch: dim 0 is the stack axis
                        total += int(next(iter(sb.values())).shape[1])
                else:
                    for b in prepared:
                        metric_state, loss = t.train_step(
                            to_tensors(b, t.device), metric_state)
                        total += t._batch_rows(b)
                if loss is not None:
                    t._sync()
                t_flush = time.perf_counter()
                self._flush_pass(phys)
                record.update(train_s=t_flush - t_train,
                              flush_s=time.perf_counter() - t_flush,
                              rows_cached=len(phys),
                              rows_resident=self.table.rows_resident,
                              rows_in_ram=self.table.rows_in_ram,
                              rows_on_disk=self.table.rows_on_disk)
                self.pass_log.append(record)
                logger.info(
                    f"epoch {epoch} pass {pass_id}: {len(phys)} rows cached, "
                    f"{self.table.rows_resident} resident host rows"
                    + (f" ({self.table.rows_in_ram} RAM / "
                       f"{self.table.rows_on_disk} disk)"
                       if self.table.rows_on_disk else "")
                )
            epoch_time = time.time() - epoch_begin
            last_metrics = (
                t._compute_metrics(metric_state) if t.use_auc else {}
            )
            if t.use_auc:
                logger.info(
                    "epoch: {} done (host_table), {}, epoch time: {:.2f} s, "
                    "ips: {:.2f} ins/s, pass-prep wait: {:.2f} s".format(
                        epoch, t._bundle_str(last_metrics, "train"),
                        epoch_time, total / max(epoch_time, 1e-9),
                        prep_wait_s,
                    )
                )
            last_metrics["pass_prep_wait_s"] = prep_wait_s
            # day-end lifecycle (show decay; optional eviction)
            self.table.end_day()
            thr = cfg.runner("host_table_shrink_threshold")
            if thr is not None:
                evicted = self.table.shrink(float(thr))
                logger.info(f"host table shrink: evicted {evicted} rows")
            if save_path:
                self.save(save_path, epoch)
            last_metrics["epoch_time"] = epoch_time
            last_metrics["ips"] = total / max(epoch_time, 1e-9)
        return last_metrics

    def _pass_dataset(self, pass_files, batch_size):
        from paddlerec_tpu_torch.data.binary import BinarySlotDataset, is_slotbin
        from paddlerec_tpu_torch.data.schema import schema_from_config
        from paddlerec_tpu_torch.data.slot_reader import SlotDataset

        if pass_files and pass_files[0].endswith(".bin") \
                and is_slotbin(pass_files[0]):
            return BinarySlotDataset(pass_files, batch_size)
        return SlotDataset(
            pass_files, schema_from_config(self.config), batch_size,
            drop_last=True,
        )

    # -- persistence ----------------------------------------------------------
    def save(self, root: str, epoch) -> str:
        """Dense params via the normal checkpoint; the host tier as the npz
        of the JAX package (keys ``rows``, ``values``, ``shows``, ``acc``),
        which either package loads."""
        state = self.trainer.state
        path = ckpt_lib.save_model(state.module.state_dict(), state.opt_state,
                                   root, epoch, extra=state.extra)
        self.save_host_tier(os.path.join(path, "host_table.npz"))
        logger.info(f"saved host-table checkpoint to {path}")
        return path

    def save_host_tier(self, path: str) -> None:
        # sparse (ids + values) form: works for both storage modes (a dense
        # dump of a disk-tier vocab would defeat the tier)
        # uncompressed members (the JAX package compresses them; np.load reads
        # both alike): float rows barely compress, and zlib's time grows with
        # every row the table holds
        rows, values = self.table.snapshot_rows()
        np.savez(path, rows=rows, values=values, shows=self.table._shows,
                 acc=self.host_acc)

    def load(self, root: str, tag) -> None:
        self.load_host_tier(os.path.join(root, str(tag), "host_table.npz"))
        if self.trainer.state is None:
            self.trainer.init_state()
        self.trainer.load_checkpoint(root, tag)

    def load_host_tier(self, path: str) -> None:
        z = np.load(path)
        if "table" in z:  # legacy dense dump (pre-disk-tier format)
            init = z["initialized"]
            rows = np.flatnonzero(init)
            self.table.restore_rows(rows, z["table"][rows], shows=z["shows"])
        else:
            self.table.restore_rows(z["rows"], z["values"], shows=z["shows"])
        self.host_acc = z["acc"]
