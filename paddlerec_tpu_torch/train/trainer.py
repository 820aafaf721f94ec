"""The trainer: the single-device subset of ``paddlerec_tpu/train/trainer.py``.

    batch (host) ──> device ──> train_step (eager: decode, forward, loss,
    backward, optimizer step, in-step AUC buckets) ──> per-epoch checkpoint
    + logging.

The JAX trainer jits one SPMD step over a mesh; here one process drives one
device and the step runs eagerly.  The embedding lookup is kernel K1 and its
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

The online day/pass loop (``train/online.py`` ``OnlineTrainer``) subclasses
this trainer; the host-tiered pass loop (``train/host_loop.py``
``HostTableTrainer``) drives one.  Not ported yet (their config keys raise
``NotImplementedError`` when the trainer is built, ``check_ported``): meshes
with ``mp > 1`` or ``dp > 1`` and multi-process runs (and with them the
row-sharded sparse rules and the global dedup), and the geo and fl sync
modes across processes.  At one process geo trains as plain sync and a
1×1 ``distributed_embedding`` mesh is accepted, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from paddlerec_tpu_torch.core import metrics as metrics_lib
from paddlerec_tpu_torch.core.config import Config, resolve_path
from paddlerec_tpu_torch.core.device import (
    HOST_KEYS, full_float32_matmul, resolve_device, to_tensors,
)
from paddlerec_tpu_torch.data.schema import schema_from_config
from paddlerec_tpu_torch.data.slot_reader import (
    PrefetchIterator, SlotDataset, list_data_files,
)
from paddlerec_tpu_torch.data.superbatch import stack_superbatches
from paddlerec_tpu_torch.data.wire import WireEncoder, decode_batch
from paddlerec_tpu_torch.ops.sparse_update import SENTINEL
from paddlerec_tpu_torch.parallel.mesh import Mesh, mesh_from_config, world_size
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


def check_ported(config: Config, world: Optional[int] = None) -> Mesh:
    """Check the multi-device keys against what the port runs, and return
    the mesh they give at this world size (default: the process group's,
    1 without one), as ``paddlerec_tpu/train/trainer.py`` builds it.

    At one process the reference's rules hold: ``runner.sync_mode: geo``
    trains as plain sync (it averages only across processes; one log line
    says so), ``sync_mode: fl`` raises its ``ValueError`` (a federated run
    needs a client a process), and ``distributed_embedding``, ``mesh_dp``
    and ``mesh_mp`` that resolve to the 1×1 mesh are accepted (the table
    takes its local path).  Still ``NotImplementedError``, naming the key:
    ``mesh_dp`` or ``mesh_mp`` above 1, any mesh with dp or mp above 1, and
    geo or fl across processes.  The online loop's ``OnlineTrainer`` is
    held to the same rules.  Every optimizer key of ``create_optimizer`` is
    ported."""
    def refuse(key: str, what: str = "") -> None:
        raise NotImplementedError(
            f"{key}{what} is not ported to paddlerec_tpu_torch yet"
        )

    world = world_size() if world is None else int(world)
    mode = str(config.runner("sync_mode", "") or "").lower()
    if mode == "fl" and world <= 1:
        raise ValueError(
            "sync_mode: fl needs >1 process (each process is one federated "
            "client with a private data shard); launch with tools/launch "
            "and torch.distributed"
        )
    if mode in ("geo", "fl") and world > 1:
        refuse("runner.sync_mode", f": {mode} across processes")
    for key in ("mesh_mp", "mesh_dp"):
        if config.runner(key) not in (None, 1, -1):
            refuse(f"runner.{key}", " > 1")
    mesh = mesh_from_config(config, world)
    if mesh.dp > 1 or mesh.mp > 1:
        refuse("runner.mesh_dp / runner.mesh_mp / "
               "hyper_parameters.distributed_embedding",
               f" (a {mesh.dp}x{mesh.mp} mesh)")
    if mode == "geo":
        logger.info("sync_mode: geo at one process trains as plain sync "
                    "(parameters are averaged only across processes)")
    return mesh


class Trainer:
    def __init__(self, config: Config, model_def=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = check_ported(config)
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

    # -- setup ----------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = int(self.config.runner("seed", 2023) if seed is None else seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        module = self.model_def.make_module(device=self.device,
                                            generator=generator)
        self.state = TrainState.create(
            module, self.tx, extra=self.model_def.init_sparse_state(module))
        self._step_rng = torch.Generator(device=self.device)
        return self.state

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
        hp.update({k: float(v) for k, v in values.items()})

    def load_checkpoint(self, root: str, tag, params_only: bool = False) -> None:
        """Restore params(+opt) from a checkpoint onto the device.

        params_only skips the optimizer-state restore so export/inference
        tools can load checkpoints saved under ANY optimizer config."""
        if self.state is None:
            self.init_state()
        if params_only:
            self.state.module.load_state_dict(
                ckpt_lib.load_params_from_state(root, tag))
            return
        params, opt_state, extra = ckpt_lib.load_model(root, tag)
        self.state.module.load_state_dict(params)
        _copy_into(self.state.opt_state, opt_state, "opt_state")
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
        _copy_into({k: v._asdict() for k, v in self.state.extra.items()},
                   extra, "extra")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- steps ------------------------------------------------------------------
    def train_step(self, batch, metric_state):
        """One optimizer step on a device batch.  Returns (metric_state,
        loss); the loss is a device scalar and nothing here waits for it."""
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
        loss.backward()
        if self.sparse:
            delta_grads = {
                key: g for key, emb in model_def.sparse_taps(state.module).items()
                if (g := emb.take_delta_grad()) is not None}
            # one shared global-norm clip for dense AND row-wise: the
            # optimizer's own clip is left out whenever sparse_update is on
            model_def.clip_grads(state.params, delta_grads)
        state.apply_gradients()
        if state.extra is not None:
            # row-wise sparse embedding update (the dense optimizer above
            # never sees the tapped tables)
            self._step_rng.manual_seed(step_seed(seed, state.step))
            model_def.apply_sparse_updates(
                state.module, state.extra, delta_grads, batch,
                rng=self._step_rng)
        if self.use_auc:
            metric_state = model_def.update_metric_state(metric_state, aux)
        return metric_state, loss.detach()

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
        files = list_data_files(data_dir)
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

    def _wire_encode(self, dataset):
        """Optional compact wire encoding (runner.wire_format: compact):
        shrinks host→device bytes ~1.6x; decoded at the head of the step."""
        if str(self.config.runner("wire_format", "")).lower() != "compact":
            return dataset
        # ONE stateful encoder per stream: the sparse representation is
        # pinned after the first batch (escalate-only), so boundary-
        # straddling streams can't flip dtypes batch to batch
        enc = WireEncoder(int(self.config.hyper("sparse_feature_number", 0)))
        return (enc(b) for b in dataset)

    def _device_batches(self, dataset, allow_super: bool = False,
                        augment: bool = False,
                        resident_key: Optional[str] = None) -> Iterable:
        # allow_super: ONLY the train and evaluate loops understand the
        # (superbatch, index) tuples; every other consumer gets plain
        # batches.  augment: the train loop's batches get the host dedup of
        # a sparse run (evaluation has no use for it).  resident_key: the
        # corpus key of runner.feed_device_resident
        if augment and self.sparse:
            dataset = (_count_uniq(self.model_def.augment_batch_host(b))
                       for b in dataset)
        dataset = self._wire_encode(dataset)
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
        return self.model_def.init_metric_state(device=self.device)

    def _compute_metrics(self, metric_state):
        return self.model_def.compute_metric_bundle(metric_state)

    def _auc_str(self, metric_state):
        return self.model_def.metric_log_str(metric_state)

    def _bundle_str(self, metrics: Dict[str, float], prefix: str) -> str:
        if "auc" in metrics:
            return metrics_lib.metrics_str(metrics, prefix)
        return prefix + " " + ", ".join(
            f"{k}={v:.6f}" for k, v in metrics.items()
        )

    # -- loops ---------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
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
        if bool(cfg.runner("use_visual", False)):
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
                    logger.info(
                        f"epoch: {epoch}, batch_id: {batch_id}, {auc_str}"
                        f"loss: {float(loss):.6f}, "
                        f"avg_reader_cost: {reader_cost / print_interval:.5f} sec, "
                        f"avg_batch_cost: {(reader_cost + train_cost) / print_interval:.5f} sec, "
                        f"avg_samples: {interval_samples / print_interval:.1f}, "
                        f"ips: {interval_samples / max(reader_cost + train_cost, 1e-9):.2f} ins/s"
                    )
                    reader_cost = train_cost = 0.0
                    interval_samples = 0
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
                logger.info(
                    "epoch: {} done, {}, epoch time: {:.2f} s, ips: {:.2f} ins/s".format(
                        epoch,
                        self._bundle_str(last_metrics, "train"),
                        epoch_time,
                        total_samples / max(epoch_time, 1e-9),
                    )
                )
            else:
                logger.info(f"epoch: {epoch} done, epoch time: {epoch_time:.2f} s")
            if save_path:
                path = ckpt_lib.save_model(
                    self.state.module.state_dict(),
                    self.state.opt_state,
                    save_path,
                    epoch,
                    extra=self.state.extra,
                )
                logger.info(f"saved checkpoint to {path}")
            last_metrics["epoch_time"] = epoch_time
            last_metrics["ips"] = total_samples / max(epoch_time, 1e-9)
        if visual is not None:
            visual.close()
        return last_metrics

    def evaluate(self, epoch_tag=None) -> Dict[str, float]:
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
        if dumping:
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
                logger.info(
                    f"infer batch_id: {batch_id}, {self._auc_str(metric_state)}"
                )
        if dump_file is not None:
            dump_file.close()
            logger.info(f"dumped fields {dump_fields} to {dump_path}")
        self._sync()  # the steps are only queued: wait, so the time is theirs
        elapsed = time.time() - begin
        metrics = self._compute_metrics(metric_state) if self.use_auc else {}
        if self.use_auc:
            logger.info(
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
