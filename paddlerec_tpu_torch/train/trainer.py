"""The trainer: the port of ``paddlerec_tpu/train/trainer.py``.

    batch (host) ──> device ──> train_step (eager: decode, forward, loss,
    backward, optimizer step, in-step AUC buckets) ──> per-epoch checkpoint
    + logging.

The JAX trainer jits one SPMD step over a mesh; here one process drives one
device (one rank of the mesh) and the step runs eagerly.  The embedding lookup is kernel K1 and its
gradient kernel K1b (``ops/gather_pool.py``) when the device is a card.  The
step never synchronises with the host: the loss stays on the device until a
log line or the end of an epoch reads it, at the places where the reference
calls ``jax.block_until_ready``.  Throughput telemetry matches the reference
format (avg_reader_cost / avg_batch_cost / ips), letter for letter.

With ``hyper_parameters.sparse_update`` the step is the reference's sparse
one, in its order: backward (the tables take no gradient; the gradient of
the looked-up vectors is captured), one clip over dense and per-position
gradients, the dense optimizer, the row-wise step on the touched rows
(``ModelDef.apply_sparse_updates``; K1b sums the gradient per unique row),
metrics.  The feed thread dedups each batch's rows on the host
(``augment_batch_host``) before the wire encoding, and adds the count of
unique rows as a host value, so the step need not read it from the device.

A model with ``stochastic = True`` (sign's hard-concrete gates) draws its
noise from a ``torch.Generator`` on the device that the step reseeds from
``runner.seed`` and the step count before it runs, as the JAX trainer folds
the step into ``PRNGKey(runner.seed)``: a resumed run draws what it would
have drawn.  The two packages' generators differ, so their noise does too.
Evaluation and serving pass no generator, the deterministic path.
``metrics = "none"`` (deeprec) runs no streaming metric at all.

The feed reads slotbin files (``BinarySlotDataset``), slot text through the
native parser (``reader_type: native``, ``native/reader.py``) or the Python
one, with an optional ``pipe_command`` stage.  ``feed_device_resident``
keeps the staged superbatches on the device after the first epoch and
replays them; ``dump_fields`` writes per-instance JSONL from ``evaluate()``
(``utils/onoff_diff.py`` diffs two of them); ``profiler_options`` traces a
batch range with ``torch.profiler`` and ``use_visual`` appends scalars
(``utils/visual.py``).

**On a ``(dp, mp)`` mesh** (``runner.mesh_dp`` / ``runner.mesh_mp`` /
``hyper_parameters.distributed_embedding`` under ``tools.launch``; one
process a rank) the step is the JAX package's SPMD step written out.  The
trainer announces its mesh in the parallel context, so that every
``SlotEmbedding`` past ``MIN_ROWS_TO_SHARD`` rows holds its rank's shard and
looks up through the all_to_all engine (K1 on the shard, K1b into it).  The
ranks of a dp row read the same file shard (``shard_files`` by dp index)
and hold the same batch; before every step all ranks agree that each has a
batch (an all_reduce MIN: uneven shards stop together).  Each rank weights
its loss by its dp row's share of the rows the loss averages (the mask's
sum, else the rows), so that the sum over dp is the gradient of the global
masked mean; the dense gradients (every leaf but the mp-sharded tables,
whose engine backward sums them over dp already) and the loss are summed
over the dp group.  ``DistributedDataParallel`` would average over the
whole group and count the mp ranks' identical gradients mp times.  The
clip, the dense optimizer and the row rules follow (``mp_tables``: the
sharded tables take the sharded rules over the global batch's unique rows,
which the main thread gathers before the wire encoding,
``ModelDef.global_dedup_arrays``).  The streaming metrics stay per rank and
are summed over dp when read, the engine's dropped-id count over the world
(``embedding_overflow``, with the reference's warning and
``runner.overflow_raise_after``).  Only global rank 0 logs and writes
checkpoints; every rank takes part in every collective, the checkpoint's
gather of each sharded table over mp among them.  The file holds the whole
table at the engine's padded rows; loading cuts each rank's rows.

**``runner.sync_mode: geo`` across processes** is the reference's PS-geo
k-step local training: each process trains its own file shard (``shard_files``
by rank) on a mesh of its own (1×1: no collective inside a step) for
``runner.geo_k_steps`` steps, then every process joins a rendezvous that pushes
the k-step diffs against the base all processes agreed on at the last one.
The dense leaves' diffs are gathered whole and averaged over the workers that
stepped; the tables' diffs only at the rows this process's batches touched
(``train/touched.py``; read off the device with one K1 launch, ``take_rows``),
summed into the base in worker order on the host, and the union of those rows
written back (``index_copy_``).  A worker whose shard ran out keeps joining
with zero steps until no worker has data, so the collective sequence never
diverges.  Optimizer state stays local.  Table updates must stay on touched
rows: geo refuses ``adamw`` and ``embedding_l2`` (at run time too) and turns
Adam lazy.  ``train/fl.py`` ``FLTrainer`` runs FedAvg rounds on the same
rendezvous with example-count weights.  The collectives are ``all_gather``s
over the world group.  At one process geo trains as plain sync and ``fl``
raises, as in the JAX package.

The online day/pass loop (``train/online.py`` ``OnlineTrainer``) subclasses
this trainer; the host-tiered pass loop (``train/host_loop.py``
``HostTableTrainer``) drives one.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddlerec_tpu_torch.core import metrics as metrics_lib
from paddlerec_tpu_torch.core.config import Config, resolve_path
from paddlerec_tpu_torch.core.device import (
    HOST_KEYS, full_float32_matmul, resolve_device, to_tensors,
)
from paddlerec_tpu_torch.data.schema import schema_from_config
from paddlerec_tpu_torch.data.slot_reader import (
    PrefetchIterator, SlotDataset, list_data_files, shard_files,
)
from paddlerec_tpu_torch.data.superbatch import stack_superbatches
from paddlerec_tpu_torch.data.wire import WireEncoder, decode_batch
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.sparse_update import SENTINEL
from paddlerec_tpu_torch.parallel import context
from paddlerec_tpu_torch.parallel.mesh import Mesh, mesh_from_config, world_size
from paddlerec_tpu_torch.parallel.sharding import local_rows
from paddlerec_tpu_torch.train import checkpoint as ckpt_lib
from paddlerec_tpu_torch.train.state import TrainState

# own handler + propagate=False: the environment may have already claimed
# the root logger at WARNING, which would silently swallow the
# reference-format INFO telemetry.
logger = logging.getLogger("paddlerec_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def rank0_info(msg: str) -> None:
    """Log on global rank 0 only: every rank of a launch runs the same code
    (and computes the message: a metric read in it is a collective)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        logger.info(msg)


def check_ported(config: Config, world: Optional[int] = None) -> Mesh:
    """Check the multi-device keys against what the port runs, and return
    the mesh they give at this world size (default: the process group's,
    1 without one), as ``paddlerec_tpu/train/trainer.py`` builds it.  Under
    a process group of that size this creates the mesh's groups (every rank
    calls it).

    Every mesh that ``mesh_from_config`` resolves is accepted for sync
    training.  ``runner.sync_mode: geo`` across processes gives each process
    a local mesh (the config's at one process: 1×1 unless it asks for more,
    which raises), as the JAX trainer's ``jax.local_devices()`` mesh.  At one
    process the reference's rules hold: geo trains as plain sync (it
    averages only across processes; one log line says so) and ``sync_mode:
    fl`` raises its ``ValueError`` (a federated run needs a client a
    process; ``train/fl.py`` runs it across processes).  Every optimizer key
    of ``create_optimizer`` is ported."""
    world = world_size() if world is None else int(world)
    mode = str(config.runner("sync_mode", "") or "").lower()
    if mode == "fl" and world <= 1:
        raise ValueError(
            "sync_mode: fl needs >1 process (each process is one federated "
            "client with a private data shard); launch with tools/launch "
            "and torch.distributed"
        )
    if mode == "geo" and world > 1:
        return mesh_from_config(config, 1)
    mesh = mesh_from_config(config, world)
    if mode == "geo":
        logger.info("sync_mode: geo at one process trains as plain sync "
                    "(parameters are averaged only across processes)")
    return mesh


def all_gather_np(arr: np.ndarray, device: torch.device, group=None) -> np.ndarray:
    """(members, *arr.shape): every member's array of the same shape and
    dtype, in ``group``'s order (the world's by default), crossing on
    ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


def _sum_over(tensors: List[torch.Tensor], group) -> None:
    """Sum tensors over ``group`` in place: one all_reduce a dtype, over
    their concatenation."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class Trainer:
    def __init__(self, config: Config, model_def=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = check_ported(config)
        self.world = world_size()
        self.rank = dist.get_rank() if self.world > 1 else 0
        # runner.sync_mode: geo, k-step local training with a rendezvous
        # that pushes the k-step diffs (reference PS-geo)
        self.geo_k = 0
        if str(config.runner("sync_mode", "") or "").lower() == "geo":
            self.geo_k = int(config.runner("geo_k_steps", 100))
        self._geo_local = bool(self.geo_k and self.world > 1)
        if self._geo_local:
            _geo_optimizer_keys(config)
        self._geo_base: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self._geo_touched: Dict[str, np.ndarray] = {}
        self._geo_pending_rows: collections.deque = collections.deque()
        self._geo_last_sync_bytes = self._geo_max_sync_bytes = 0
        self._geo_untracked_warned: set = set()
        # host-side collectives (has-next flags, row ids) cross on the CPU
        # under gloo; NCCL takes only card tensors
        self._comm_device = (torch.device("cpu") if self.world <= 1
                             or dist.get_backend() == "gloo" else self.device)
        # announce the mesh so that layers with a distributed path
        # (SlotEmbedding) pick it up when the module is built
        context.set_mesh(self.mesh)
        # full float32 products on the card: the parity tolerances against
        # the JAX package assume it
        full_float32_matmul()
        if model_def is None:
            from paddlerec_tpu_torch.core.registry import load_model_def

            model_def = load_model_def(config)
        self.model_def = model_def
        # built here so that an optimizer key that is not ported raises now
        self.tx = model_def.create_optimizer()
        self.state: Optional[TrainState] = None
        self.sparse = bool(model_def.sparse_update_enabled())
        # the noise of a stochastic model and of the stochastic rounding:
        # reseeded from runner.seed and the step before each use, so a
        # resumed run draws what it would have
        self.stochastic = bool(getattr(model_def, "stochastic", False))
        self._step_rng: Optional[torch.Generator] = None
        self.use_auc = bool(config.runner("use_auc", True)) and (
            model_def.metrics in ("auc", "acc")
        )
        # runner.feed_device_resident: staged superbatches kept on the device
        # by corpus key ({"sbs", "replays", "bytes"})
        self._resident: Dict[str, Dict[str, Any]] = {}
        self._overflow_strikes = 0
        self._overflow_seen = 0
        # state_dict names of the parameters row-sharded over mp (the tables
        # the engine holds a shard of), set by init_state
        self._sharded: frozenset = frozenset()

    # -- setup ----------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        context.set_mesh(self.mesh)
        seed = int(self.config.runner("seed", 2023) if seed is None else seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        module = self.model_def.make_module(device=self.device,
                                            generator=generator)
        self._sharded = frozenset(
            ".".join(filter(None, [name, "embedding"]))
            for name, m in module.named_modules()
            if isinstance(m, SlotEmbedding) and m.engine is not None)
        # the sharded tables' Adam moments and row state are shards too:
        # they are built from the shards
        self.state = TrainState.create(
            module, self.tx, extra=self.model_def.init_sparse_state(module))
        self._step_rng = torch.Generator(device=self.device)
        return self.state

    def _mp_table_paths(self) -> frozenset:
        """The "/"-joined paths of the tables row-sharded over mp, read off
        the live modules (the JAX trainer reads the live shardings); they
        route the row-wise step to the sharded rules."""
        return frozenset(name.replace(".", "/") for name in self._sharded)

    def set_hyperparams(self, **values: float) -> None:
        """Retune the injected optimizer hyperparameters (learning_rate,
        embedding_l2) in place.  Requires the optimizer to have been built
        with hyper_parameters.optimizer.runtime_inject."""
        if self.state is None:
            self.init_state()
        hp = self.state.opt_state.get("hyperparams")
        if hp is None:
            raise ValueError(
                "set_hyperparams needs optimizer.runtime_inject: true "
                "(the default optimizer reads lr/el2 from the config)"
            )
        unknown = set(values) - set(hp)
        if unknown:
            raise KeyError(f"not injected hyperparams: {sorted(unknown)}")
        if self._geo_local and float(values.get("embedding_l2", 0.0) or 0.0):
            # the refusal at construction sees only the static config; a
            # decay raised at run time would move every row each local step
            # while the rendezvous ships touched-row diffs only
            raise ValueError(
                "sync_mode: geo does not compose with embedding_l2 "
                "(runtime-injected or static) — untouched rows would "
                "decay by different amounts on workers with uneven shards"
            )
        hp.update({k: float(v) for k, v in values.items()})

    def load_checkpoint(self, root: str, tag, params_only: bool = False) -> None:
        """Restore params(+opt) from a checkpoint onto the device.

        params_only skips the optimizer-state restore so export/inference
        tools can load checkpoints saved under ANY optimizer config.  On a
        mesh each rank takes its rows of every sharded table, moment and row
        state (a checkpoint saved on the same mesh)."""
        if self.state is None:
            self.init_state()
        if params_only:
            self.state.module.load_state_dict(self._local(
                ckpt_lib.load_params_from_state(root, tag), self._sharded))
            return
        params, opt_state, extra = ckpt_lib.load_model(root, tag)
        self.state.module.load_state_dict(self._local(params, self._sharded))
        _copy_into(self.state.opt_state, self._local(opt_state, self._sharded),
                   "opt_state")
        if self.state.extra is None:
            return
        if extra is None:
            # checkpoint predates sparse_update (no side state on disk):
            # restore params+opt and keep freshly-initialized moments
            logger.warning(
                "checkpoint has no sparse-update side state; row-wise "
                "optimizer moments start fresh"
            )
            return
        extra = {k: self._local(v, self._sharded_extra(k)) for k, v in extra.items()}
        _copy_into({k: v._asdict() for k, v in self.state.extra.items()},
                   extra, "extra")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- sharded checkpoints ------------------------------------------------------
    def _sharded_extra(self, key: str) -> frozenset:
        """The fields of row state ``key`` that are shards: all of them
        where its table is row-sharded over mp."""
        table = key.rpartition("/")[0].replace("/", ".") + ".embedding"
        return (frozenset(("acc", "m", "v", "count")) if table.lstrip(".") in self._sharded
                else frozenset())

    def _local(self, tree, names: frozenset):
        """A loaded tree with each sharded leaf (a tensor keyed by one of
        ``names``, anywhere in it) cut to this rank's rows."""
        if not names:
            return tree
        if isinstance(tree, dict):
            return {k: (local_rows(v, self.mesh.mp_index, self.mesh.mp).clone()
                        if k in names and isinstance(v, torch.Tensor)
                        else self._local(v, names)) for k, v in tree.items()}
        return tree

    def _whole(self, tree, names: frozenset):
        """A tree with each sharded leaf gathered whole over the mesh row
        (the row's first rank gets it; the others get their shard back)."""
        if not names:
            return tree
        if hasattr(tree, "_asdict"):
            tree = tree._asdict()
        if isinstance(tree, dict):
            return {k: (self._gather_row(v) if k in names and isinstance(v, torch.Tensor)
                        else self._whole(v, names)) for k, v in tree.items()}
        return tree

    def _gather_row(self, t: torch.Tensor) -> torch.Tensor:
        group = self.mesh.mp_group
        t = t.detach().to(self._comm_device).contiguous()
        first = int(self.mesh.grid[self.mesh.dp_index, 0])
        parts = ([torch.empty_like(t) for _ in range(self.mesh.mp)]
                 if self.rank == first else None)
        dist.gather(t, parts, dst=first, group=group)
        return torch.cat(parts) if parts is not None else t

    def save_checkpoint(self, root: str, tag) -> Optional[str]:
        """Save params+opt(+extra) under root/tag (``ckpt_lib.save_model``).
        On a mesh every rank takes part (the sharded tables, their moments
        and row state gathered whole over mp) and global rank 0 writes;
        returns the path there, None on the other ranks."""
        state = self.state
        params, opt_state, extra = state.module.state_dict(), state.opt_state, state.extra
        if self._sharded:
            params = self._whole(params, self._sharded)
            opt_state = self._whole(opt_state, self._sharded)
            if extra is not None:
                extra = {k: self._whole(v, self._sharded_extra(k)) for k, v in extra.items()}
        path = None
        if self.rank == 0:
            path = ckpt_lib.save_model(params, opt_state, root, tag, extra=extra)
        if self.world > 1:
            dist.barrier()  # the file is whole before any rank reads it
        return path

    # -- steps ------------------------------------------------------------------
    def train_step(self, batch, metric_state):
        """One optimizer step on a device batch.  Returns (metric_state,
        loss); the loss is a device scalar and nothing here waits for it.
        On a mesh with dp > 1 the loss is the global batch's (the dp sum of
        the weighted rows' losses)."""
        state, model_def = self.state, self.model_def
        batch = decode_batch(batch)  # no-op unless wire-encoded
        state.module.zero_grad(set_to_none=True)
        seed = int(self.config.runner("seed", 2023))
        if self.stochastic:
            # the step before this update, as JAX's fold_in(key, state.step)
            self._step_rng.manual_seed(step_seed(seed, state.step))
            loss, aux = model_def.train_forward(state.module, batch,
                                                generator=self._step_rng)
        else:
            loss, aux = model_def.train_forward(state.module, batch)
        dp_group = self.mesh.dp_group if self.mesh.dp > 1 else None
        if dp_group is not None:
            # this dp row's share of the global loss: its rows that the loss
            # averages over the dp row's total, so that the dp sum of the
            # gradients is the global masked mean's
            rows = (batch["mask"].sum().to(torch.float32) if "mask" in batch
                    else torch.tensor(float(self._batch_rows(batch)), device=loss.device))
            total = rows.clone()
            dist.all_reduce(total, group=dp_group)
            loss = loss * (torch.clamp(rows, min=1.0) / torch.clamp(total, min=1.0))
        loss.backward()
        if dp_group is not None:
            # the dense gradients and the loss, summed over dp; the sharded
            # tables' gradients are the engine's dp sums already
            grads = [p.grad for k, p in state.params.items()
                     if p.grad is not None and k not in self._sharded]
            loss = loss.detach().reshape(1)
            _sum_over(grads + [loss], dp_group)
            loss = loss[0]
        delta_grads = {}
        if self.sparse:
            delta_grads = {
                key: g for key, emb in model_def.sparse_taps(state.module).items()
                if (g := emb.take_delta_grad()) is not None}
            # one shared global-norm clip for dense AND row-wise: the
            # optimizer's own clip is left out whenever sparse_update is on
            model_def.clip_grads(state.params, delta_grads, self.mesh)
        state.apply_gradients(self._global_grad_norm()
                              if self._sharded and getattr(state.tx, "clip", None) else None)
        if state.extra is not None:
            # row-wise sparse embedding update (the dense optimizer above
            # never sees the tapped tables)
            self._step_rng.manual_seed(step_seed(seed, state.step))
            model_def.apply_sparse_updates(
                state.module, state.extra, delta_grads, batch,
                rng=self._step_rng, mp_tables=self._mp_table_paths())
        if self.use_auc:
            metric_state = model_def.update_metric_state(metric_state, aux)
        return self._accumulate_overflow(metric_state, aux), loss.detach()

    @torch.no_grad()
    def _global_grad_norm(self) -> torch.Tensor:
        """The gradients' global norm where some leaves are mp shards: their
        squares summed over the mesh row, so that the dense optimizer's clip
        sees the whole table (``optax.clip_by_global_norm`` on the JAX mesh)."""
        params = self.state.params
        shard_sq = sum(torch.sum(p.grad * p.grad).to(torch.float32)
                       for k, p in params.items() if k in self._sharded)
        dist.all_reduce(shard_sq, group=self.mesh.mp_group)
        return torch.sqrt(shard_sq + sum(torch.sum(p.grad * p.grad).to(torch.float32)
                                         for k, p in params.items() if k not in self._sharded))

    def super_step(self, sb, i: int, metric_state):
        # index sub-batch i out of a staged superbatch ON DEVICE
        # (runner.feed_superbatch): a view, no copy
        return self.train_step({k: v[i] for k, v in sb.items()}, metric_state)

    def infer_step(self, batch, metric_state):
        batch = decode_batch(batch)
        with self.model_def.infer_context():
            aux = self.model_def.infer_forward(self.state.module, batch)
        if self.use_auc:
            metric_state = self.model_def.update_metric_state(metric_state, aux)
        return metric_state, aux

    def infer_super(self, sb, i: int, metric_state):
        # the eval twin of super_step, so evaluate() rides the same
        # K-batches-per-transfer feed
        return self.infer_step({k: v[i] for k, v in sb.items()}, metric_state)

    # -- data ---------------------------------------------------------------------
    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False,
                     drop_last: bool = True):
        if hasattr(self.model_def, "make_dataset"):
            # a model with its own text format reads it (din, dsin, dmr, ...)
            try:
                return self.model_def.make_dataset(
                    data_dir, batch_size, shuffle, drop_last=drop_last
                )
            except TypeError:
                # the models' datasets take no drop_last (their own tail
                # policy applies), as in the JAX package
                return self.model_def.make_dataset(data_dir, batch_size,
                                                   shuffle)
        schema = schema_from_config(self.config)
        files = shard_files(list_data_files(data_dir), *self._data_shard())
        reader_type = str(self.config.runner("reader_type", "")).lower()
        from paddlerec_tpu_torch.data.binary import BinarySlotDataset, is_slotbin

        bin_files = [f for f in files if f.endswith(".bin")]
        if reader_type == "binary" or (
            reader_type == "" and bin_files and is_slotbin(bin_files[0])
        ):
            # converted slotbin data: mmap views, zero parse work on the
            # hot path
            return BinarySlotDataset(
                bin_files or files,
                batch_size,
                drop_last=drop_last,
                shuffle_files=bool(shuffle),
                shuffle_batches=bool(
                    self.config.runner("shuffle_batches", False)
                ),
                seed=int(self.config.runner("seed", 2023)),
            )
        if reader_type == "native":
            # C++ thread-pool parser (the QueueDataset analog); falls back
            # to the Python reader when no toolchain is available
            from paddlerec_tpu_torch.native import NativeUnavailable, fastreader
            from paddlerec_tpu_torch.native.reader import NativeSlotDataset

            try:
                fastreader()  # built here, so that a missing toolchain falls back
                return NativeSlotDataset(
                    files,
                    num_sparse=len(schema.sparse_slots),
                    dense_dim=schema.dense_dim,
                    batch_size=batch_size,
                    drop_last=drop_last,
                    num_threads=int(self.config.runner("reader_threads", 8)),
                    shuffle_files=bool(shuffle),
                    seed=int(self.config.runner("seed", 2023)),
                )
            except NativeUnavailable as e:
                logger.warning(f"native reader unavailable ({e}); "
                               "falling back to the Python reader")
        return SlotDataset(
            files,
            schema,
            batch_size,
            drop_last=drop_last,
            shuffle_files=shuffle,
            seed=int(self.config.runner("seed", 2023)),
            pipe_command=self.config.runner("pipe_command") or None,
        )

    def _data_shard(self) -> tuple:
        """(index, count) of this process's share of the files or rows: its
        dp row's on a mesh (the ranks of a dp row read the same shard, one
        batch a row), its own in geo (each worker a private shard)."""
        if self._geo_local:
            return self.rank, self.world
        return self.mesh.dp_index, self.mesh.dp

    def _wire_encoder(self):
        """The compact wire encoding of a stream (runner.wire_format:
        compact; shrinks host→device bytes ~1.6x; decoded at the head of the
        step), or None.  ONE stateful encoder per stream: the sparse
        representation is pinned after the first batch (escalate-only), so
        boundary-straddling streams can't flip dtypes batch to batch."""
        if str(self.config.runner("wire_format", "")).lower() != "compact":
            return None
        return WireEncoder(int(self.config.hyper("sparse_feature_number", 0)))

    def _wire_encode(self, dataset):
        enc = self._wire_encoder()
        return dataset if enc is None else (enc(b) for b in dataset)

    def _device_batches(self, dataset, allow_super: bool = False,
                        augment: bool = False,
                        resident_key: Optional[str] = None) -> Iterable:
        # allow_super: ONLY the train and evaluate loops understand the
        # (superbatch, index) tuples; every other consumer gets plain
        # batches.  augment: the train loop's batches get the host dedup of
        # a sparse run (evaluation has no use for it).  resident_key: the
        # corpus key of runner.feed_device_resident
        if augment and self.sparse and self.mesh.dp > 1:
            # the row update wants the GLOBAL batch's unique rows: a
            # collective in the main thread, then the wire encoding
            yield from self._global_dedup_batches(dataset)
            return
        if augment and self.sparse:
            dataset = (_count_uniq(self.model_def.augment_batch_host(b))
                       for b in dataset)
        batches = self._rank_batches(self._wire_encode(dataset), allow_super,
                                     resident_key)
        # geo workers feed their own shard only: no global batches
        global_batches = self.world > 1 and not self._geo_local
        yield from (self._unanimous(batches) if global_batches else batches)

    def _all_have(self, has: bool) -> bool:
        """Whether every rank has a next batch: an all_reduce MIN over the
        world (file shards may hold different batch counts; without it the
        shorter rank leaves while its peers wait in a collective)."""
        flag = torch.tensor([int(has)], dtype=torch.int32, device=self._comm_device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def _unanimous(self, items):
        it = iter(items)
        while True:
            try:
                item, has = next(it), True
            except StopIteration:
                item, has = None, False
            if not self._all_have(has):
                return
            yield item

    def _global_dedup_batches(self, dataset):
        """Host batches + the global dedup (``global_dedup_arrays``), then
        the wire encoding, one batch at a time after the unanimous has-next
        (the dedup's gather is a collective: all ranks reach it in step)."""
        enc = self._wire_encoder()
        for batch in self._unanimous(PrefetchIterator(iter(dataset), depth=4)):
            ded = self.model_def.global_dedup_arrays(batch, self.mesh, self._comm_device)
            if ded is not None:
                batch = _count_uniq(dict(batch, sparse_uniq=ded[0], sparse_slot=ded[1]))
            yield to_tensors(batch if enc is None else enc(batch), self.device)

    def _rank_batches(self, dataset, allow_super: bool, resident_key: Optional[str]):
        """This rank's device batches (or superbatch items) of a dataset."""
        k = int(self.config.runner("feed_superbatch", 0) or 0)
        if k > 1 and allow_super:
            # superbatch staging: K host batches ride ONE host→device
            # transfer; the step indexes batch i on device.  Yields
            # (superbatch, i) pairs consumed by the superbatch step.
            if (resident_key is not None
                    and bool(self.config.runner("feed_device_resident", False))):
                yield from self._resident_superbatches(dataset, k, resident_key)
                return
            yield from self._staged_superbatches(dataset, k)
            return
        for batch in PrefetchIterator(iter(dataset), depth=4):
            yield to_tensors(batch, self.device)

    def _resident_key(self, kind: str, data_dir: str, batch_size: int) -> str:
        """Resident-store key including a corpus content signature (file
        names, sizes and mtimes), so refreshed on-disk data is restaged
        instead of replaying the old corpus from the device; entries of a
        superseded signature are dropped (freeing their device memory)."""
        import hashlib

        prefix = f"{kind}:{data_dir}:{batch_size}"
        try:
            stats = [
                (f, os.stat(f).st_size, os.stat(f).st_mtime_ns)
                for f in list_data_files(data_dir)
            ]
            sig = hashlib.md5(repr(stats).encode()).hexdigest()[:12]
        except OSError:
            sig = "nosig"  # unlistable dir: no staleness detection
        key = f"{prefix}:{sig}"
        stale = [c for c in self._resident
                 if c.startswith(prefix + ":") and c != key]
        for c in stale:
            del self._resident[c]
            logger.info(
                "feed_device_resident: dropped stale resident corpus %r "
                "(data under %r changed)", c, data_dir,
            )
        return key

    def _resident_superbatches(self, dataset, k: int, key: str):
        """Device-RESIDENT feed (``runner.feed_device_resident``): the staged
        superbatches stay on the device after the first pass and replay in a
        reshuffled order on every later epoch, so from epoch 1 on nothing
        crosses the host→device link.  Corpora larger than
        ``runner.resident_max_gb`` (default 8) stream instead (one warning;
        behaviour identical to plain superbatch staging).  Replay order is
        reshuffled across superbatches per epoch
        (``RandomState(replays).permutation``); rows within a staged
        superbatch keep their composition."""
        ent = self._resident.get(key)
        if ent is None:
            cap = float(self.config.runner("resident_max_gb", 8.0)) * (1 << 30)
            sbs, total, spilled = [], 0, False
            for sb, i in self._staged_superbatches(dataset, k):
                if not spilled and i == 0:
                    nbytes = self._device_bytes(sb)
                    if total + nbytes > cap:
                        spilled = True
                        sbs = None
                        logger.warning(
                            "feed_device_resident: corpus exceeds "
                            "resident_max_gb=%.1f — falling back to "
                            "streaming staging", cap / (1 << 30),
                        )
                    else:
                        total += nbytes
                        sbs.append(sb)
                yield sb, i
            self._resident[key] = {"sbs": sbs, "replays": 0, "bytes": total}
            if sbs is not None:
                logger.info(
                    "feed_device_resident: %d superbatches (%.2f GB) "
                    "resident on the device for %r",
                    len(sbs), total / (1 << 30), key,
                )
            return
        if ent["sbs"] is None:  # spilled on first pass: keep streaming
            yield from self._staged_superbatches(dataset, k)
            return
        ent["replays"] += 1
        order = np.random.RandomState(ent["replays"]).permutation(len(ent["sbs"]))
        for j in order:
            sb = ent["sbs"][int(j)]
            for i in range(int(next(iter(sb.values())).shape[0])):
                yield sb, i

    @staticmethod
    def _device_bytes(batch) -> int:
        return sum(int(v.numel()) * v.element_size() for k, v in batch.items()
                   if k not in HOST_KEYS and isinstance(v, torch.Tensor))

    def _staged_superbatches(self, dataset, k: int, depth: int = 3):
        stacks = stack_superbatches(dataset, k)
        if self.device.type != "cuda":
            staged = (to_tensors(sb, self.device) for sb in stacks)
            for sb in PrefetchIterator(staged, depth=depth):
                for i in range(int(next(iter(sb.values())).shape[0])):
                    yield sb, i
            return
        # A feeder thread stages each superbatch in pinned host memory and
        # starts its copy on a side stream; the step's stream waits on the
        # copy's event, so the copy of superbatch n+1 overlaps the steps of
        # superbatch n.  The pinned buffers form a ring, each reused only
        # after the copy that last read it has finished.
        device = self.device
        side = torch.cuda.Stream(device)
        ring = [{} for _ in range(depth + 2)]

        def stage():
            for n, host in enumerate(stacks):
                slot = ring[n % len(ring)]
                if "event" in slot:
                    slot["event"].synchronize()
                out = {}
                with torch.cuda.device(device), torch.cuda.stream(side):
                    for key, src in to_tensors(host, torch.device("cpu")).items():
                        if key in HOST_KEYS:
                            out[key] = src
                            continue
                        pin = slot.get(key)
                        if (pin is None or pin.shape != src.shape
                                or pin.dtype != src.dtype):
                            pin = slot[key] = torch.empty(
                                src.shape, dtype=src.dtype, pin_memory=True)
                        pin.copy_(src)
                        out[key] = pin.to(device, non_blocking=True)
                    slot["event"] = torch.cuda.Event()
                    slot["event"].record(side)
                yield out, slot["event"]

        for sb, copied in PrefetchIterator(stage(), depth=depth):
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in sb.values():
                if t.is_cuda:
                    t.record_stream(current)
            for i in range(int(next(iter(sb.values())).shape[0])):
                yield sb, i

    @staticmethod
    def _batch_rows(batch) -> int:
        lead = batch.get("mask", next(iter(batch.values())))
        return int(lead.shape[0])

    def _init_metric_state(self):
        ms = self.model_def.init_metric_state(device=self.device)
        if isinstance(ms, dict) and self.mesh.mp > 1:
            # mp meshes route lookups through the all_to_all exchange: carry
            # its dropped-id counter (this rank's) alongside the metrics
            ms = dict(ms, embedding_overflow=torch.zeros((), dtype=torch.int32,
                                                         device=self.device))
        self._overflow_seen = 0
        return ms

    def _global_metrics(self, metric_state):
        """The metric state of the whole mesh, for reading: each rank's
        streaming state summed over the dp group (the mp ranks of a row
        hold the same one) and the dropped-id counter over the world, on
        copies (the live state keeps counting this rank's).  A collective:
        every rank reads at the same steps.  The state itself at one
        process."""
        if self.world <= 1 or self._geo_local or not isinstance(metric_state, dict):
            return metric_state
        out = {k: v for k, v in metric_state.items() if k != "embedding_overflow"}
        copies = _clone_tree(out)
        if self.mesh.dp > 1:
            _sum_over(_tensors(copies), self.mesh.dp_group)
        if "embedding_overflow" in metric_state:
            total = metric_state["embedding_overflow"].clone()
            dist.all_reduce(total)
            copies["embedding_overflow"] = total
        return copies

    def _compute_metrics(self, metric_state):
        metric_state = self._global_metrics(metric_state)
        out = self.model_def.compute_metric_bundle(metric_state)
        if isinstance(metric_state, dict) and "embedding_overflow" in metric_state:
            out["embedding_overflow"] = int(metric_state["embedding_overflow"])
        return out

    def _auc_str(self, metric_state):
        return self.model_def.metric_log_str(self._global_metrics(metric_state))

    # -- overflow observability --------------------------------------------------
    # The all_to_all exchange drops ids when a bucket overflows.  The count
    # is taken in the step (the model's aux) and folded into the metric
    # state, so it works on any mesh.
    @staticmethod
    def _accumulate_overflow(metric_state, aux):
        """Fold this step's dropped-id count into the counter."""
        if (isinstance(aux, dict) and isinstance(metric_state, dict)
                and "embedding_overflow" in aux
                and "embedding_overflow" in metric_state):
            metric_state = dict(
                metric_state,
                embedding_overflow=metric_state["embedding_overflow"]
                + aux["embedding_overflow"],
            )
        return metric_state

    def _check_overflow(self, metric_state) -> None:
        """At the print interval, on every rank: warn on counter growth;
        ``runner.overflow_raise_after: N`` raises after N consecutive
        growing intervals (skewed, non-hashed id distributions degrade
        quality invisibly otherwise — raise
        ``hyper_parameters.embedding_capacity_factor`` when it fires)."""
        if not (isinstance(metric_state, dict)
                and "embedding_overflow" in metric_state):
            return
        total = int(self._global_metrics(metric_state)["embedding_overflow"])
        if total > self._overflow_seen:
            dropped = total - self._overflow_seen
            self._overflow_seen = total
            self._overflow_strikes += 1
            if self.rank == 0:
                logger.warning(
                    f"embedding exchange overflow: {dropped} ids dropped "
                    f"since the last check (strike {self._overflow_strikes}); "
                    "raise hyper_parameters.embedding_capacity_factor"
                )
            limit = self.config.runner("overflow_raise_after")
            if limit is not None and self._overflow_strikes >= int(limit):
                raise RuntimeError(
                    f"embedding exchange overflowed on "
                    f"{self._overflow_strikes} consecutive checks "
                    f"({total} ids dropped in total); ids are too skewed "
                    "for the configured bucket capacity"
                )
        else:
            self._overflow_strikes = 0
        self._overflow_seen = total

    def _bundle_str(self, metrics: Dict[str, float], prefix: str) -> str:
        if "auc" in metrics:
            return metrics_lib.metrics_str(metrics, prefix)
        return prefix + " " + ", ".join(
            f"{k}={v:.6f}" for k, v in metrics.items()
        )

    # -- geo (k-step local training with a touched-row diff push) ------------
    def _geo_entries(self) -> Dict[str, torch.Tensor]:
        """name → tensor of every leaf of the module's state (the flax-form
        "/"-joined name; the tensors share the parameters' storage)."""
        return {k.replace(".", "/"): v for k, v in self.state.module.state_dict().items()}

    @torch.no_grad()
    def _init_geo_state(self) -> None:
        """The host-side base: the parameters every process agreed on at the
        last rendezvous (the same everywhere: the same-seed start, then moved
        in lockstep by ``_geo_sync``).  The diffs are taken against it."""
        from paddlerec_tpu_torch.convert import is_embedding_path

        self._geo_base = {"tables": {}, "dense": {}}
        self._geo_touched = {}
        for name, leaf in self._geo_entries().items():
            if is_embedding_path(name) and leaf.dim() >= 2:
                self._geo_base["tables"][name] = leaf.float().cpu().numpy().copy()
                self._geo_touched[name] = np.zeros(leaf.shape[0], bool)
            else:
                self._geo_base["dense"][name] = _host(leaf).copy()
        self._geo_last_sync_bytes = self._geo_max_sync_bytes = 0
        self._geo_untracked_warned = set()

    def _geo_observing(self, dataset):
        """The rows each host batch touches, by table, queued in the feed's
        thread and marked only when the loop takes the batch
        (``_geo_mark_consumed``): the feed runs batches ahead, and marking
        when a batch is read would let a rendezvous clear rows whose batch
        is still queued, whose diffs would then never be pushed."""
        from paddlerec_tpu_torch.train.touched import batch_rows_by_table

        def warn(name, why):
            if name not in self._geo_untracked_warned:
                self._geo_untracked_warned.add(name)
                logger.warning(
                    f"geo: table {name!r} gets NO touched-row tracking "
                    f"({why}) — its local updates will NEVER be pushed "
                    "at rendezvous and workers WILL diverge on it; "
                    "override ModelDef.touched_tables")

        for batch in dataset:
            rows_of = {}
            if self._geo_touched:
                rows_of = batch_rows_by_table(
                    self.model_def, batch,
                    {n: len(m) for n, m in self._geo_touched.items()}, warn=warn)
            self._geo_pending_rows.append(rows_of)
            yield batch

    def _geo_mark_consumed(self) -> None:
        """Mark the next queued batch's touched rows (FIFO, one entry a
        batch)."""
        if self._geo_pending_rows:
            for name, rows in self._geo_pending_rows.popleft().items():
                self._geo_touched[name][rows] = True

    def _all_gather_np(self, arr: np.ndarray) -> np.ndarray:
        return all_gather_np(arr, self._comm_device)

    @torch.no_grad()
    def _geo_sync(self, step_counts: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> None:
        """One rendezvous: gather the k-step diffs, apply them to the base,
        write the base back.  Every process calls it in lockstep.

        * dense leaves: every worker's (current - base), gathered whole;
          base += their mean over the workers that stepped (a worker with no
          steps ships zeros and leaves the denominator).
        * tables: only the rows this worker touched since the last
          rendezvous, padded to the largest worker's count, (ids, diffs)
          gathered; base += each worker's diffs in worker order on the host
          (``np.add.at``, so that every process gets the same bits), and the
          union of the rows written back to the device table.

        ``weights`` (FedAvg, ``train/fl.py``): base += Σ w_k·Δ_k for the dense
        leaves and the tables both."""
        from paddlerec_tpu_torch.ops.embedding import take_rows

        counts = np.asarray(step_counts)
        n_active = int((counts > 0).sum())
        self._geo_last_sync_bytes = 0
        if n_active == 0:
            return
        if weights is None:
            active = (counts > 0).astype(np.float32)
            dense_w = active / n_active
            table_w = np.ones_like(active)
        else:
            dense_w = table_w = np.asarray(weights, np.float32)
        tables = self._geo_base["tables"]
        entries = self._geo_entries()

        # dense: one gather of the float diffs, concatenated
        names = [n for n, b in self._geo_base["dense"].items()
                 if np.issubdtype(b.dtype, np.floating)]
        diffs = [_host(entries[n]).astype(np.float32)
                 - self._geo_base["dense"][n].astype(np.float32) for n in names]
        if names:
            flat = np.concatenate([d.reshape(-1) for d in diffs])
            gathered = self._all_gather_np(flat)
            offset = 0
            for n, d in zip(names, diffs):
                stack = gathered[:, offset:offset + d.size].reshape((self.world,) + d.shape)
                offset += d.size
                self._geo_last_sync_bytes += stack.nbytes
                upd = (self._geo_base["dense"][n].astype(np.float32)
                       + np.tensordot(dense_w, stack, axes=1))
                self._geo_base["dense"][n] = upd
                leaf = entries[n]
                leaf.copy_(torch.as_tensor(upd).reshape(leaf.shape).to(leaf.device, leaf.dtype))

        # tables: the touched-row exchange, padded to the largest count
        for name, base in tables.items():
            leaf = entries[name]
            mask = self._geo_touched[name]
            rows = np.nonzero(mask)[0].astype(np.int64)
            cnts = self._all_gather_np(np.asarray([len(rows)], np.int64)).reshape(-1)
            cap = int(cnts.max())
            mask[:] = False
            if cap == 0:
                continue
            # the ids cross as int32, as the JAX package's allgather (without
            # x64) ships them
            rows_pad = np.zeros(cap, np.int32)
            rows_pad[:len(rows)] = rows
            diff_pad = np.zeros((cap,) + base.shape[1:], np.float32)
            if len(rows):
                idx = torch.from_numpy(rows).to(leaf.device)
                vals = take_rows(leaf, idx, out_dtype=torch.float32).cpu().numpy()
                diff_pad[:len(rows)] = vals - base[rows]
            g_rows = self._all_gather_np(rows_pad)
            g_diff = self._all_gather_np(diff_pad)
            self._geo_last_sync_bytes += g_rows.nbytes + g_diff.nbytes
            for w in range(self.world):
                nw = int(cnts[w])
                if nw and table_w[w]:
                    # geo: each worker's k-step progress adds; fl: its
                    # weighted FedAvg share
                    np.add.at(base, g_rows[w, :nw], g_diff[w, :nw] * table_w[w])
            union = np.unique(np.concatenate(
                [g_rows[w, :int(cnts[w])] for w in range(self.world) if int(cnts[w])])
                ).astype(np.int64)
            idx = torch.from_numpy(union).to(leaf.device)
            leaf.index_copy_(0, idx, torch.from_numpy(base[union]).to(leaf.device, leaf.dtype))
        self._geo_max_sync_bytes = max(self._geo_max_sync_bytes, self._geo_last_sync_bytes)

    def _geo_merge_metrics(self, metric_state):
        """Every worker's metric state summed (the counts are additive), so
        that the epoch's metrics cover all workers' data."""
        if not isinstance(metric_state, dict):
            return metric_state
        merged = _clone_tree(metric_state)
        _sum_over(_tensors(merged), None)
        return merged

    def _geo_rendezvous(self, has_more: bool, local_steps: int) -> bool:
        """The k-step barrier: sync the parameters and learn whether any
        worker still has data.  Every worker calls it in lockstep (an
        exhausted one with ``has_more=False`` and zero steps)."""
        flags = self._all_gather_np(
            np.asarray([1 if has_more else 0, local_steps], np.int64)).reshape(-1, 2)
        self._geo_sync(flags[:, 1])
        return bool(flags[:, 0].max() > 0)

    def _train_epoch_geo(self, dataset, metric_state, epoch: int, print_interval: int):
        """One geo epoch: rounds of up to k local steps, each followed by a
        rendezvous.  An exhausted worker keeps joining the rendezvous with
        zero steps until every worker is done."""
        if self._geo_base is None:
            self._init_geo_state()
        self._geo_pending_rows = collections.deque()
        it = iter(self._device_batches(self._geo_observing(dataset), augment=True))
        total = steps = 0
        exhausted = False
        round_begin = time.time()
        while True:
            done_in_round = 0
            while done_in_round < self.geo_k and not exhausted:
                try:
                    batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self._geo_mark_consumed()
                metric_state, loss = self.train_step(batch, metric_state)
                total += self._batch_rows(batch)
                steps += 1
                done_in_round += 1
                if steps % print_interval == 0:
                    auc_str = self._auc_str(metric_state) if self.use_auc else ""
                    logger.info(f"epoch: {epoch}, batch_id: {steps - 1}, {auc_str}"
                                f"loss: {float(loss):.6f} (geo local, worker {self.rank})")
            self._sync()
            more = self._geo_rendezvous(not exhausted, done_in_round)
            logger.info(f"geo sync: worker {self.rank} after {done_in_round} local steps "
                        f"({time.time() - round_begin:.2f} s round)")
            round_begin = time.time()
            if not more:
                break
        return metric_state, total

    # -- loops ---------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        context.set_mesh(self.mesh)
        cfg = self.config
        epochs = int(cfg.runner("epochs", 1))
        batch_size = int(cfg.runner("train_batch_size", 32))
        print_interval = int(cfg.runner("print_interval", 10))
        save_path = resolve_path(cfg, "runner.model_save_path")
        data_dir = resolve_path(cfg, "runner.train_data_dir")
        start_epoch = 0

        if self.state is None:
            self.init_state()
            init_path = resolve_path(cfg, "runner.model_init_path")
            if init_path:
                self.load_checkpoint(
                    os.path.dirname(init_path), os.path.basename(init_path)
                )
                start_epoch = int(cfg.runner("last_epoch", -1)) + 1

        # VisualDL-analog scalar telemetry
        visual = None
        if bool(cfg.runner("use_visual", False)) and self.rank == 0:
            from paddlerec_tpu_torch.utils.visual import ScalarWriter

            visual = ScalarWriter(
                resolve_path(cfg, "runner.train_visual_path") or "visual_log")
        global_step = 0
        profiler_options = cfg.runner("profiler_options")

        last_metrics: Dict[str, float] = {}
        # ONE dataset object for all epochs: re-iterating bumps its
        # internal epoch counter, so shuffle_files gets a fresh
        # permutation each epoch (a per-epoch object would reshuffle
        # with the same seed every time)
        dataset = self.make_dataset(
            data_dir, batch_size,
            shuffle=bool(cfg.runner("shuffle_files", False)),
        )
        for epoch in range(start_epoch, epochs):
            metric_state = self._init_metric_state()
            epoch_begin = time.time()
            if self._geo_local:
                metric_state, total_samples = self._train_epoch_geo(
                    dataset, metric_state, epoch, print_interval)
                epoch_time = time.time() - epoch_begin
                # the counts are additive: the workers' states summed
                merged = self._geo_merge_metrics(metric_state)
                last_metrics = self._compute_metrics(merged) if self.use_auc else {}
                if self.use_auc:
                    rank0_info("epoch: {} done (geo, k={}), {}, epoch time: {:.2f} s".format(
                        epoch, self.geo_k, self._bundle_str(last_metrics, "train"),
                        epoch_time))
                if save_path:
                    path = self.save_checkpoint(save_path, epoch)
                    rank0_info(f"saved checkpoint to {path}")
                last_metrics["epoch_time"] = epoch_time
                last_metrics["ips"] = total_samples / max(epoch_time, 1e-9)
                continue
            reader_start = time.time()
            reader_cost = train_cost = 0.0
            interval_samples = 0
            total_samples = 0
            loss = None
            for batch_id, batch in enumerate(
                    self._device_batches(
                        dataset, allow_super=True, augment=True,
                        resident_key=self._resident_key(
                            "train", data_dir, batch_size))):
                if profiler_options:
                    from paddlerec_tpu_torch.utils.profiler import add_profiler_step

                    add_profiler_step(profiler_options)
                reader_cost += time.time() - reader_start
                step_start = time.time()
                if isinstance(batch, tuple):  # (superbatch, index)
                    sb, idx = batch
                    metric_state, loss = self.super_step(sb, idx, metric_state)
                    n = int(next(iter(sb.values())).shape[1])
                else:
                    metric_state, loss = self.train_step(batch, metric_state)
                    n = self._batch_rows(batch)
                n *= self.mesh.dp  # the global batch: every dp row's
                interval_samples += n
                total_samples += n
                global_step += 1
                if (batch_id + 1) % print_interval == 0:
                    self._sync()
                    train_cost += time.time() - step_start
                    if visual is not None:
                        visual.add_scalars(
                            {
                                "train/loss": float(loss),
                                "train/ips": interval_samples
                                / max(reader_cost + train_cost, 1e-9),
                            },
                            global_step,
                        )
                    auc_str = self._auc_str(metric_state) if self.use_auc else ""
                    rank0_info(
                        f"epoch: {epoch}, batch_id: {batch_id}, {auc_str}"
                        f"loss: {float(loss):.6f}, "
                        f"avg_reader_cost: {reader_cost / print_interval:.5f} sec, "
                        f"avg_batch_cost: {(reader_cost + train_cost) / print_interval:.5f} sec, "
                        f"avg_samples: {interval_samples / print_interval:.1f}, "
                        f"ips: {interval_samples / max(reader_cost + train_cost, 1e-9):.2f} ins/s"
                    )
                    reader_cost = train_cost = 0.0
                    interval_samples = 0
                    self._check_overflow(metric_state)
                else:
                    train_cost += time.time() - step_start
                reader_start = time.time()

            if loss is not None:
                self._sync()
            epoch_time = time.time() - epoch_begin
            last_metrics = (
                self._compute_metrics(metric_state) if self.use_auc else {}
            )
            if self.use_auc:
                rank0_info(
                    "epoch: {} done, {}, epoch time: {:.2f} s, ips: {:.2f} ins/s".format(
                        epoch,
                        self._bundle_str(last_metrics, "train"),
                        epoch_time,
                        total_samples / max(epoch_time, 1e-9),
                    )
                )
            else:
                rank0_info(f"epoch: {epoch} done, epoch time: {epoch_time:.2f} s")
            if save_path:
                path = self.save_checkpoint(save_path, epoch)
                rank0_info(f"saved checkpoint to {path}")
            last_metrics["epoch_time"] = epoch_time
            last_metrics["ips"] = total_samples / max(epoch_time, 1e-9)
        if visual is not None:
            visual.close()
        return last_metrics

    def evaluate(self, epoch_tag=None) -> Dict[str, float]:
        context.set_mesh(self.mesh)
        cfg = self.config
        batch_size = int(cfg.runner("infer_batch_size", 32))
        print_interval = int(cfg.runner("print_interval", 10))
        data_dir = resolve_path(cfg, "runner.test_data_dir")
        load_path = resolve_path(cfg, "runner.infer_load_path")

        if self.state is None:
            self.init_state()
        if epoch_tag is not None and load_path:
            self.load_checkpoint(load_path, epoch_tag)

        dataset = self.make_dataset(data_dir, batch_size, drop_last=False)
        # dump_fields: per-instance variable dumps for the on/off-line
        # consistency diff (JSONL read by utils/onoff_diff.py).  It needs
        # each batch's aux on the host, so it keeps the single-batch path;
        # everything else evaluates through superbatch staging
        dump_fields = cfg.runner("dump_fields") or []
        if isinstance(dump_fields, str):
            # CLI overrides arrive as "[predictions,labels]" strings
            dump_fields = [f.strip() for f in dump_fields.strip("[]").split(",")
                           if f.strip()]
        dump_path = resolve_path(cfg, "runner.dump_fields_path")
        dumping = bool(dump_fields) and bool(dump_path)
        eval_batches = self._device_batches(
            dataset, allow_super=not dumping,
            resident_key=None if dumping
            else self._resident_key("eval", data_dir, batch_size))
        dump_file = None
        if dumping and self.rank == 0:  # on a mesh: dp row 0's instances
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            dump_file = open(dump_path, "w")
        metric_state = self._init_metric_state()
        begin = time.time()
        total = 0
        for batch_id, batch in enumerate(eval_batches):
            if isinstance(batch, tuple):  # (superbatch, index)
                sb, idx = batch
                metric_state, _ = self.infer_super(sb, idx, metric_state)
                total += int(next(iter(sb.values())).shape[1])
            else:
                metric_state, aux = self.infer_step(batch, metric_state)
                if dump_file is not None:
                    _dump_batch(dump_file, batch_id, batch, aux, dump_fields)
                total += self._batch_rows(batch)
            if (batch_id + 1) % print_interval == 0 and self.use_auc:
                rank0_info(
                    f"infer batch_id: {batch_id}, {self._auc_str(metric_state)}"
                )
        if dump_file is not None:
            dump_file.close()
            rank0_info(f"dumped fields {dump_fields} to {dump_path}")
        self._sync()  # the steps are only queued: wait, so the time is theirs
        elapsed = time.time() - begin
        total *= self.mesh.dp  # every dp row's rows
        metrics = self._compute_metrics(metric_state) if self.use_auc else {}
        if self.use_auc:
            rank0_info(
                "{}, infer time: {:.2f} s, ips: {:.2f} ins/s".format(
                    self._bundle_str(metrics, "infer"),
                    elapsed,
                    total / max(elapsed, 1e-9),
                )
            )
        metrics["ips"] = total / max(elapsed, 1e-9)
        return metrics


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's generator from ``runner.seed`` and the step: the
    splitmix64 mix of ``(seed << 32) + step``.  Mixed, because the CPU
    generator keeps only the low 32 bits of its seed (the card's keeps all
    64): unmixed, every ``runner.seed`` would draw the same noise there."""
    mask = (1 << 64) - 1
    z = (((seed << 32) + step) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) % (1 << 63)


def _dump_batch(out, batch_id: int, batch, aux, fields) -> None:
    """One JSONL record per unmasked row of a batch: ``ins_id`` is
    ``"<batch_id>_<row>"`` and ``vars`` holds each dumped aux field's values
    of the row."""
    host = {k: aux[k].detach().double().cpu().numpy() for k in fields if k in aux}
    mask = batch["mask"].cpu().numpy() if "mask" in batch else None
    for r in range(Trainer._batch_rows(batch)):
        if mask is not None and mask[r] == 0:
            continue
        rec = {"ins_id": f"{batch_id}_{r}",
               "vars": {k: [float(x) for x in v[r].reshape(-1)]
                        for k, v in host.items()}}
        out.write(json.dumps(rec) + "\n")


def _geo_optimizer_keys(config: Config) -> None:
    """Refuse the optimizer keys geo cannot push, and turn Adam lazy.  The
    rendezvous ships touched-row diffs only, so table updates must stay on
    the rows with gradients: plain Adam's momentum moves every row once its
    moments are non-zero (lazy Adam steps only the touched rows); adamw's
    decay and embedding_l2 move every row every step."""
    opt = str(config.hyper("optimizer.class", "Adam")).lower()
    if opt == "adamw":
        raise ValueError(
            "sync_mode: geo needs update-on-touch table optimizers (touched-row "
            "diff push); adamw's weight decay moves every row each step — use "
            "adam (lazy), sgd, or adagrad")
    if float(config.hyper("embedding_l2", 0.0) or 0.0):
        raise ValueError(
            "sync_mode: geo does not compose with embedding_l2 for the same "
            "reason as adamw: the decoupled decay moves EVERY table row each "
            "local step, but the rendezvous only ships touched-row diffs — "
            "untouched rows would decay by different amounts on workers with "
            "uneven shards and silently diverge")
    if (opt == "adam" and not bool(config.hyper("optimizer.lazy_mode", False))
            and not bool(config.hyper("sparse_update", False))):
        config["hyper_parameters.optimizer.lazy_mode"] = True
        logger.info("geo mode: forcing Adam lazy_mode so embedding updates stay "
                    "confined to touched rows")


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array (bfloat16 as float32: numpy has no
    bfloat16)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _count_uniq(batch):
    """A host batch with ``sparse_uniq`` (ascending, SENTINEL-padded) gets
    ``sparse_num_uniq``, the count of its real rows: a host value that rides
    beside the device batch (``HOST_KEYS``)."""
    if "sparse_uniq" not in batch:
        return batch
    count = np.searchsorted(batch["sparse_uniq"], SENTINEL)
    return dict(batch, sparse_num_uniq=np.int64(count))


def _copy_into(target, source, path: str) -> None:
    """Copy a loaded optimizer or row-wise state into the live state's:
    tensors in place, plain values (the count, injected hyperparameters) by
    assignment; same nesting and names, or raise."""
    if isinstance(target, torch.Tensor):
        if not isinstance(source, torch.Tensor) or source.shape != target.shape:
            raise ValueError(f"checkpoint {path} does not match the optimizer")
        with torch.no_grad():
            target.copy_(source)
    elif isinstance(target, dict):
        if not isinstance(source, dict) or set(source) != set(target):
            raise ValueError(
                f"checkpoint {path} does not match the optimizer's state: "
                f"{sorted(source) if isinstance(source, dict) else source!r} "
                f"against {sorted(target)}"
            )
        for k, v in target.items():
            if isinstance(v, (torch.Tensor, dict)):
                _copy_into(v, source[k], f"{path}.{k}")
            else:
                target[k] = type(v)(source[k])
