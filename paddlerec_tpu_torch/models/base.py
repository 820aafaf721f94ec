"""ModelDef: the per-model contract.

Counterpart of ``paddlerec_tpu/models/base.py`` (``ModelDef`` /
``CTRModelDef``).  A ModelDef reads its hyper-parameters from a ``Config``,
builds its ``nn.Module`` (``make_module``), maps a batch through it
(``train_forward(module, batch)`` / ``infer_forward(module, batch)``, the
JAX functions of ``(params, batch)`` with the parameters held by the
module), builds its optimizer (``create_optimizer``) and owns the streaming
metric hooks the trainer calls.  With ``hyper_parameters.sparse_update`` it
also owns the row-wise side of a step: the host dedup of a batch
(``augment_batch_host``), the one clip over dense and per-position
gradients (``clip_grads``) and the row-wise optimizer step on every table
in external-update mode (``apply_sparse_updates``).

``AccuracyModelDef`` swaps the AUC hooks for the streaming accuracy of the
classification models.  A model with ``stochastic = True`` takes the
trainer's per-step ``torch.Generator`` in ``train_forward(module, batch,
generator=...)``; evaluation and serving pass none, the deterministic path.

``touched_tables`` maps a host batch onto the rows each table touches, for
the online trainer's deltas and feature lifecycle (``train/touched.py``).

On a ``(dp, mp)`` mesh (``train/trainer.py``): ``global_dedup_arrays`` dedups
the rows of the global batch (every dp row's) on every rank alike, the
row-wise step routes the tables row-sharded over mp (``mp_tables``) to the
sharded rules of ``ops/sparse_update.py``, ``clip_grads`` adds the
per-position gradients' squares over the dp group, and the CTR models' aux
carries the step's dropped-id count of the engine (``embedding_overflow``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core import metrics as metrics_lib
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.ops import sparse_update as su
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.packed_embedding import sub_width
from paddlerec_tpu_torch.parallel import context
from paddlerec_tpu_torch.train.optimizers import Optimizer

Batch = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


def all_gather_rows(a: np.ndarray, group, device: torch.device) -> np.ndarray:
    """A host array's rows from every rank of ``group``, concatenated in the
    group's rank order (the array itself without a group).  The lengths may
    differ; the tensors cross on ``device`` (NCCL wants the card)."""
    if group is None:
        return a
    n = dist.get_world_size(group)
    size = torch.tensor([a.shape[0]], dtype=torch.int64, device=device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(x) for x in sizes]
    t = torch.zeros((max(sizes),) + a.shape[1:], dtype=torch.from_numpy(a[:0]).dtype,
                    device=device)
    t[:a.shape[0]] = torch.from_numpy(a).to(device)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return np.concatenate([p[:k].cpu().numpy() for p, k in zip(parts, sizes)])


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable), as
    ``optax.sigmoid_binary_cross_entropy``: ``-y·log σ(x) - (1-y)·log σ(-x)``.
    With a mask: the masked sum over ``max(mask.sum(), 1)``."""
    per = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    return masked_mean(per, mask)


def pair_metric(pos: torch.Tensor, neg: torch.Tensor, mask: Optional[torch.Tensor],
                neg_mask: Optional[torch.Tensor] = None):
    """(preds, labels, mask) of the AUC over positives (label 1) and
    negatives (label 0): ``pos`` (B,), ``neg`` (B, N); each negative takes its
    row's mask unless ``neg_mask`` (B·N,) is given."""
    neg = neg.reshape(-1)
    preds = torch.cat([pos, neg])
    labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
    if mask is not None:
        if neg_mask is None:
            n = neg.shape[0] // pos.shape[0]
            neg_mask = mask[:, None].expand(-1, n).reshape(-1)
        mask = torch.cat([mask, neg_mask])
    return preds, labels, mask


def masked_mean(per: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of per-row losses, or with a mask their masked sum over
    ``max(mask.sum(), 1)``, as the JAX models average."""
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class ModelDef:
    """Base contract.  Subclasses implement ``make_module``,
    ``model_inputs``, ``example_batch`` and ``train_forward``."""

    # which streaming metric family the trainer should run
    metrics: str = "auc"
    # per-task metric names; multitask models override
    metric_names = ("auc",)
    # models with stochastic layers (sign's L0 gates) take the trainer's
    # per-step generator in train_forward
    stochastic: bool = False
    # models that adapt to each task by gradient steps (maml, metaheac) need
    # gradients in their inference too: the trainer's evaluation and the
    # serving entry points then enable them (``infer_context``)
    infer_needs_grad: bool = False

    def __init__(self, config: Config):
        self.config = config

    def metric_updates(self, aux: Aux):
        """name → (preds, labels, mask) for each streaming AUC to update."""
        return {
            self.metric_names[0]: (
                aux["predictions"],
                aux["labels"],
                aux.get("mask"),
            )
        }

    # -- streaming-metric hooks (the trainer delegates; AUC family) -----------
    def init_metric_state(self, device=None):
        return {
            name: metrics_lib.init_auc_state(device=device)
            for name in self.metric_names
        }

    def update_metric_state(self, metric_state, aux: Aux):
        out = dict(metric_state)
        for name, (preds, labels, mask) in self.metric_updates(aux).items():
            out[name] = metrics_lib.update_auc_state(out[name], preds, labels, mask)
        return out

    def compute_metric_bundle(self, metric_state) -> Dict[str, float]:
        """Host-side bundle; primary task flattened to top-level keys."""
        names = list(self.metric_names)
        out = dict(metrics_lib.compute_metrics(metric_state[names[0]]))
        for name in names[1:]:
            out[f"auc_{name}"] = metrics_lib.compute_metrics(
                metric_state[name]
            )["auc"]
        return out

    def metric_log_str(self, metric_state) -> str:
        names = self.metric_names
        if len(names) == 1:
            m = metrics_lib.compute_metrics(metric_state[names[0]])
            return f"auc: {m['auc']:.6f}, "
        parts = [
            f"auc_{n}: {metrics_lib.compute_metrics(metric_state[n])['auc']:.6f}"
            for n in names
        ]
        return ", ".join(parts) + ", "

    # -- sparse (row-wise) embedding updates -----------------------------------
    # hyper_parameters.sparse_update: true puts the embedding tables in
    # external-update mode (ops/embedding.py) so the optimizer touches ONLY
    # the rows a batch used, essential at vocab >= 10^7.
    def sparse_update_enabled(self) -> bool:
        return bool(self.config.hyper("sparse_update", False))

    def _sparse_update_rule(self) -> str:
        # "adam": element-wise moments, parity with dense Adam on touched
        # rows.  "adagrad": scalar per-row accumulator.
        return str(self.config.hyper("sparse_update_rule", "adam")).lower()

    @staticmethod
    def sparse_taps(module: nn.Module) -> Dict[str, SlotEmbedding]:
        """The tables in external-update mode, keyed as the JAX package keys
        its side state: ``"<module path>/embedding_delta"``."""
        return {
            "/".join(filter(None, [*name.split("."), "embedding_delta"])): m
            for name, m in module.named_modules()
            if isinstance(m, SlotEmbedding) and m.external_update
        }

    def init_sparse_state(self, module: nn.Module):
        """Row-wise optimizer state for every tapped table (or None)."""
        taps = self.sparse_taps(module)
        if not taps:
            return None
        init = (su.rowwise_adagrad_init
                if self._sparse_update_rule() == "adagrad"
                else su.rowwise_adam_init)
        return {key: init(m.embedding) for key, m in taps.items()}

    def sparse_update_ids(self, batch: Batch):
        return batch["sparse"]

    def touched_tables(self, batch: Dict[str, np.ndarray]):
        """Host-side map of table name → physical row ids this batch
        touches, for delta publishing and the feature lifecycle
        (``OnlineTrainer``).  Names are the flax-form parameter paths
        (``"item_emb/embedding"``).  ``None`` selects the fused-CTR default
        (``batch["sparse"]`` mapped through the pack arithmetic onto every
        table with the fused geometry); models with several independent
        tables (din, dien) override it so that every table gets exact
        bookkeeping."""
        return None

    def _default_pack(self) -> int:
        # models whose fused table is wider than sparse_feature_dim (e.g.
        # deepfm's E+1 lanes) set sparse_embed_logical_dim
        dim = int(getattr(
            self, "sparse_embed_logical_dim",
            int(self.config.hyper("sparse_feature_dim", 9)),
        ))
        return 128 // sub_width(dim)

    def augment_batch_host(self, batch: Dict[str, np.ndarray]):
        """Host-side batch enrichment (runs in the input pipeline): dedup
        the batch's physical rows so the device never needs an O(vocab)
        grad scratch or a device-side sort."""
        if not self.sparse_update_enabled() or "sparse_uniq" in batch:
            return batch
        vocab = int(self.config.hyper("sparse_feature_number", 1000001))
        uniq, slot = su.host_dedup(
            self.sparse_update_ids(batch), vocab, self._default_pack())
        return dict(batch, sparse_uniq=uniq, sparse_slot=slot)

    def global_dedup_arrays(self, batch: Dict[str, np.ndarray], mesh,
                            device: torch.device):
        """The dp analog of ``augment_batch_host``: dedup the GLOBAL batch's
        physical rows, so that the row update stays exact when each dp row
        holds only its part.  The int32 physical row ids (one per lookup
        position; vectors never move) are gathered over ``mesh``'s dp group
        (the mp ranks of a row hold the same positions: a gather over the
        world would count each of them mp times) and every rank runs the
        same ``np.unique``, so (uniq, slot) are bitwise equal on all of them.
        ``slot`` indexes the positions in dp-major order.  A collective:
        every rank calls it, in step (the trainer's main thread, after the
        unanimous has-next)."""
        if not self.sparse_update_enabled():
            return None
        vocab = int(self.config.hyper("sparse_feature_number", 1000001))
        phys = ((np.asarray(self.sparse_update_ids(batch)).reshape(-1) % vocab)
                // self._default_pack()).astype(np.int32)
        phys_global = all_gather_rows(phys, mesh.dp_group, device)
        uniq_vals, slot = np.unique(phys_global, return_inverse=True)
        uniq = np.full(phys_global.size, su.SENTINEL, np.int32)
        uniq[: len(uniq_vals)] = uniq_vals
        return uniq, slot.reshape(-1).astype(np.int32)

    @torch.no_grad()
    def clip_grads(self, params: Dict[str, torch.Tensor],
                   delta_grads: Dict[str, torch.Tensor], mesh=None) -> None:
        """One global-norm clip over the dense leaves' ``.grad`` AND the
        per-position gradients of the tapped tables (not their per-row
        sums), in place — used by the trainer for sparse runs, where the
        optimizer's own clip would only see the dense leaves.  On a mesh the
        dense gradients are the dp sums already, and each dp row's
        per-position squares are added over the dp group."""
        clip = self.config.hyper("clip_by_norm")
        if not clip:
            return
        grads = [p.grad for p in params.values() if p.grad is not None]
        deltas = list(delta_grads.values())
        sq = sum(torch.sum(g.float() ** 2) for g in grads)
        if deltas:
            dsq = sum(torch.sum(g.float() ** 2) for g in deltas)
            if mesh is not None and mesh.dp_group is not None:
                dist.all_reduce(dsq, group=mesh.dp_group)
            sq = sq + dsq
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(float(clip) / torch.clamp(gnorm, min=1e-12), max=1.0)
        torch._foreach_mul_(grads + deltas, scale)

    def apply_sparse_updates(self, module: nn.Module, extra: Dict[str, Any],
                             delta_grads: Dict[str, torch.Tensor],
                             batch: Batch,
                             rng: Optional[torch.Generator] = None,
                             mp_tables: frozenset = frozenset()) -> None:
        """Consume the captured per-position gradients → row-wise step on
        the tapped tables, in place.  Runs after the dense optimizer, which
        never sees those tables.  With ``sparse_uniq`` in the batch and the
        default pack the compact rules run; otherwise the sort-free rules
        with their dense scratch.  ``sparse_num_uniq``, where the feed put
        it into the batch (a host value), spares the compact rules their
        read of the count from the device.

        ``mp_tables``: the "/"-joined paths of the tables row-sharded over
        the context mesh's mp axis (the trainer reads them off the live
        modules); those, and every table under a dp-sharded batch, take
        the sharded rules over the global batch's unique rows
        (``global_dedup_arrays`` at dp > 1; without ``sparse_uniq`` the rows
        are gathered and deduped on the device)."""
        adagrad = self._sparse_update_rule() == "adagrad"
        if not bool(self.config.hyper("sparse_update_stochastic_round", False)):
            rng = None  # round-to-nearest (deterministic) by default
        lr = float(self.config.hyper("optimizer.learning_rate", 0.001))
        vocab = int(self.config.hyper("sparse_feature_number", 1000001))
        default_pack = self._default_pack()
        ids = self.sparse_update_ids(batch)
        for key, emb in self.sparse_taps(module).items():
            dgrad = delta_grads.get(key)
            if dgrad is None:
                continue  # the table was not looked up in this step
            table = emb.embedding
            hashed = (ids % vocab).reshape(-1)
            num_uniq = batch.get("sparse_num_uniq")
            num_uniq = None if num_uniq is None else int(num_uniq)
            mesh = context.get_mesh()
            sharded = key.rpartition("/")[0] + "/embedding" in mp_tables
            if sharded or (mesh is not None and mesh.dp > 1):
                # over the global batch's unique rows: a table row-sharded
                # over mp, or any table under a dp-sharded batch
                mp = mesh.mp if sharded else 1
                pack = su.infer_pack(vocab, table.shape[0] * mp, mp)
                # the engine's delta is 128 lanes a position; the local tap w
                sub = None if sharded else (hashed % pack).to(torch.int32)
                if "sparse_uniq" in batch and pack == default_pack:
                    uniq, slot = batch["sparse_uniq"], batch["sparse_slot"]
                else:
                    # device dedup of the global batch's rows (the host dedup
                    # of the feed is the fast path)
                    phys = torch.div(hashed, pack, rounding_mode="floor").to(torch.int32)
                    if mesh.dp > 1:
                        phys = torch.from_numpy(all_gather_rows(
                            phys.cpu().numpy(), mesh.dp_group, phys.device)).to(phys.device)
                    uniq, slot = su.dedup_rows(phys, su.SENTINEL)
                    num_uniq = None
                n = hashed.shape[0]
                if slot.shape[0] != mesh.dp * n:
                    raise ValueError(
                        f"sparse_slot has {slot.shape[0]} positions; the global "
                        f"batch of a {mesh.dp}x{mesh.mp} mesh has {mesh.dp * n}")
                apply_fn = (su.apply_sparse_adagrad_sharded if adagrad
                            else su.apply_sparse_adam_sharded)
                apply_fn(mesh, table, extra[key], dgrad, uniq,
                         slot[mesh.dp_index * n:(mesh.dp_index + 1) * n], lr,
                         rng=rng, sub=sub, num_uniq=num_uniq, sharded=sharded)
                continue
            pack = su.infer_pack(vocab, table.shape[0])
            sub = (hashed % pack).to(torch.int32)
            if "sparse_uniq" in batch and pack == default_pack:
                # host-deduped fast path: O(batch) scratch
                apply_fn = (su.apply_sparse_adagrad_compact if adagrad
                            else su.apply_sparse_adam_compact)
                apply_fn(table, extra[key], dgrad, batch["sparse_uniq"],
                         batch["sparse_slot"], lr, rng=rng, sub=sub,
                         num_uniq=num_uniq)
            else:
                apply_fn = (su.apply_sparse_adagrad if adagrad
                            else su.apply_sparse_update)
                phys = torch.div(hashed, pack, rounding_mode="floor").to(torch.int32)
                apply_fn(table, extra[key], dgrad, phys, lr, rng=rng, sub=sub)

    def infer_context(self, default=torch.no_grad):
        """The grad mode inference runs in: ``default()`` (``torch.no_grad``
        in evaluation, ``torch.inference_mode`` in serving), or
        ``torch.enable_grad()`` for a model with ``infer_needs_grad``."""
        return torch.enable_grad() if self.infer_needs_grad else default()

    # -- optimizer -------------------------------------------------------------
    def _base_optimizer(self) -> Dict[str, Any]:
        """The optimizer's class and its own settings, as keyword arguments
        of ``Optimizer``: from hyper_parameters.optimizer.* (Adam(lr) by
        default).  The override point of the JAX package's method of the
        same name: maml and metaheac force Adam at their meta learning
        rate."""
        cfg = self.config
        name = str(cfg.hyper("optimizer.class", "Adam")).lower()
        if name == "gradientdescent":
            name = "sgd"
        return {
            "name": name,
            "lr": float(cfg.hyper("optimizer.learning_rate", 0.001)),
            "initial_accumulator_value": float(
                cfg.hyper("optimizer.initial_accumulator_value", 0.1)),
            "lazy": bool(cfg.hyper("optimizer.lazy_mode", False)),
            "weight_decay": float(cfg.hyper("optimizer.weight_decay", 1e-4)),
        }

    def create_optimizer(self) -> Optimizer:
        """Optimizer from hyper_parameters.optimizer.* (Adam(lr) by
        default).  ``clip_by_norm`` is chained before it and
        ``embedding_l2`` after it, except in sparse runs: those clip once
        over the whole gradient in the trainer (``clip_grads``), and their
        tables, which the row-wise rules step, never reach this optimizer."""
        cfg = self.config
        sparse = self.sparse_update_enabled()
        inject = bool(cfg.hyper("optimizer.runtime_inject", False))
        if inject and sparse:
            raise ValueError(
                "optimizer.runtime_inject does not compose with "
                "sparse_update (row-wise updates read lr statically)"
            )
        return Optimizer(
            **self._base_optimizer(),
            clip=None if sparse else cfg.hyper("clip_by_norm"),
            embedding_l2=0.0 if sparse else float(
                cfg.hyper("embedding_l2", 0.0) or 0.0),
            runtime_inject=inject,
        )

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        """A freshly initialized module on ``device``; ``generator`` (on the
        same device) makes the init reproducible."""
        raise NotImplementedError

    def example_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def model_inputs(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """Map a reader batch to the module's forward positional args."""
        raise NotImplementedError

    def train_forward(self, module: nn.Module,
                      batch: Batch) -> Tuple[torch.Tensor, Aux]:
        raise NotImplementedError

    def infer_forward(self, module: nn.Module, batch: Batch) -> Aux:
        _, aux = self.train_forward(module, batch)
        return aux


class AccuracyModelDef(ModelDef):
    """Base for classification models tracked by streaming accuracy
    (bert4rec).  ``metric_updates`` must return name → (correct_flags,
    mask)."""

    metrics = "acc"

    def init_metric_state(self, device=None):
        return {name: metrics_lib.init_acc_state(device=device)
                for name in self.metric_names}

    def update_metric_state(self, metric_state, aux: Aux):
        out = dict(metric_state)
        for name, (correct, mask) in self.metric_updates(aux).items():
            out[name] = metrics_lib.update_acc_state(out[name], correct, mask)
        return out

    def compute_metric_bundle(self, metric_state) -> Dict[str, float]:
        return {
            f"acc_{name}" if len(self.metric_names) > 1 else "acc":
                metrics_lib.compute_acc(metric_state[name])
            for name in self.metric_names
        }

    def metric_log_str(self, metric_state) -> str:
        bundle = self.compute_metric_bundle(metric_state)
        return ", ".join(f"{k}: {v:.6f}" for k, v in bundle.items()) + ", "


class LogitModelDef(ModelDef):
    """A binary-CTR model whose module maps ``model_inputs(batch)`` to logits
    (B,), trained with ``binary_logloss`` under the batch's mask: what the JAX
    package's ``CTRModelDef`` and the sequence models (din, bst, dsin) each
    write out in their ``train_forward``."""

    @staticmethod
    def _aux(logits: torch.Tensor, batch: Batch) -> Aux:
        aux = {
            "predictions": torch.sigmoid(logits),
            "labels": batch["label"].reshape(-1).to(torch.float32),
        }
        if "mask" in batch:
            aux["mask"] = batch["mask"]
        return aux

    def _logits_and_aux(self, module: nn.Module,
                        batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits = module(*self.model_inputs(batch)).reshape(-1)
        aux = self._aux(logits, batch)
        overflow = [o for m in module.modules() if isinstance(m, SlotEmbedding)
                    and (o := m.take_overflow()) is not None]
        if overflow:
            # the row-sharded lookups' dropped ids, this rank's (the JAX
            # module sows them; the trainer sums them over the world)
            aux["embedding_overflow"] = sum(o.sum() for o in overflow).to(torch.int32)
        return logits, aux

    def train_forward(self, module: nn.Module,
                      batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits, aux = self._logits_and_aux(module, batch)
        return binary_logloss(logits, aux["labels"], aux.get("mask")), aux

    def infer_forward(self, module: nn.Module, batch: Batch) -> Aux:
        # the JAX package takes train_forward's aux and lets XLA drop the
        # unused loss; eager PyTorch would compute it, so it is left out here
        return self._logits_and_aux(module, batch)[1]


class CTRModelDef(LogitModelDef):
    """Base for binary-CTR models over (sparse ids, dense) features: the
    module maps (sparse_ids (B,S)[,L], dense (B,D)) → logits (B,)."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_sparse = int(config.hyper("sparse_inputs_slots", 27)) - 1
        self.vocab_size = int(config.hyper("sparse_feature_number", 1000001))
        self.embedding_dim = int(config.hyper("sparse_feature_dim", 9))
        self.dense_dim = int(config.hyper("dense_input_dim", 13))

    def table_dtype(self) -> torch.dtype:
        """Embedding table dtype: hyper_parameters.sparse_feature_dtype
        ∈ {float32, bfloat16}."""
        name = str(self.config.hyper(
            "sparse_feature_dtype", "float32"
        )).lower()
        if name in ("bfloat16", "bf16"):
            return torch.bfloat16
        if name in ("float32", "fp32", "f32"):
            return torch.float32
        raise ValueError(f"unknown sparse_feature_dtype {name!r}")

    def sparse_embed_kwargs(self) -> Dict[str, Any]:
        """SlotEmbedding kwargs for the sparse_update mode (pass into the
        module's main fused table).  The capacity must fit the LARGEST
        batch the module will see — infer batches are routinely bigger
        than train batches."""
        if not self.sparse_update_enabled():
            return {}
        cfg = self.config
        max_bs = max(int(cfg.runner("train_batch_size", 512)),
                     int(cfg.runner("infer_batch_size", 512)))
        return {
            "external_update": True,
            "delta_capacity": int(cfg.hyper(
                "sparse_update_capacity", self.num_sparse * max_bs
            )),
        }

    def table_kwargs(self) -> Dict[str, Any]:
        """``SlotEmbedding`` kwargs every table of a module gets: ``dtype``
        from ``sparse_feature_dtype`` and, in a sparse run,
        ``external_update`` and ``delta_capacity``.  The JAX package hands
        these to every ``SlotEmbedding`` of a CTR model through a trace-time
        context; here each ``make_module`` passes them on, so that
        ``sparse_feature_dtype: bfloat16`` and ``sparse_update: true`` work
        for every model from the config alone."""
        return {"dtype": self.table_dtype(), **self.sparse_embed_kwargs()}

    def model_inputs(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        if self.dense_dim:
            return (batch["sparse"], batch["dense"])
        return (batch["sparse"],)

    def example_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        from paddlerec_tpu_torch.data.synthetic import synthetic_batch

        rng = np.random.RandomState(0)
        return synthetic_batch(
            rng,
            batch_size,
            num_sparse=self.num_sparse,
            dense_dim=max(self.dense_dim, 1),
            vocab=self.vocab_size,
        )
