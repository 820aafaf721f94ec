"""ModelDef: the per-model contract.

Counterpart of ``paddlerec_tpu/models/base.py`` (``ModelDef`` /
``CTRModelDef``).  A ModelDef reads its hyper-parameters from a ``Config``,
builds its ``nn.Module`` (``make_module``), maps a batch through it
(``train_forward(module, batch)`` / ``infer_forward(module, batch)``, the
JAX functions of ``(params, batch)`` with the parameters held by the
module), builds its optimizer (``create_optimizer``) and owns the streaming
metric hooks the trainer calls.  The sparse row-wise updates, the lazy and
runtime-injected optimizers and the accuracy metric family are not ported
yet; their keys raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core import metrics as metrics_lib
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.train.optimizers import Optimizer

Batch = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable), as
    ``optax.sigmoid_binary_cross_entropy``: ``-y·log σ(x) - (1-y)·log σ(-x)``.
    With a mask: the masked sum over ``max(mask.sum(), 1)``."""
    per = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    if mask is not None:
        return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return per.mean()


class ModelDef:
    """Base contract.  Subclasses implement ``make_module``,
    ``model_inputs``, ``example_batch`` and ``train_forward``."""

    # which streaming metric family the trainer should run
    metrics: str = "auc"
    # per-task metric names; multitask models override
    metric_names = ("auc",)

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

    # -- optimizer -------------------------------------------------------------
    def create_optimizer(self) -> Optimizer:
        """Optimizer from hyper_parameters.optimizer.* (Adam(lr) by
        default), with ``clip_by_norm`` chained before it.  Classes and
        options whose code is not ported raise, naming the key."""
        cfg = self.config
        for key in ("optimizer.runtime_inject", "optimizer.lazy_mode",
                    "embedding_l2", "sparse_update"):
            value = cfg.hyper(key, False)
            if value and float(value):
                raise NotImplementedError(
                    f"hyper_parameters.{key} is not ported to "
                    f"paddlerec_tpu_torch yet"
                )
        name = str(cfg.hyper("optimizer.class", "Adam")).lower()
        if name == "gradientdescent":
            name = "sgd"
        if name in ("rmsprop", "adamw"):
            raise NotImplementedError(
                f"hyper_parameters.optimizer.class: {name} is not ported to "
                f"paddlerec_tpu_torch yet (adam, sgd and adagrad are)"
            )
        return Optimizer(
            name,
            lr=float(cfg.hyper("optimizer.learning_rate", 0.001)),
            clip=cfg.hyper("clip_by_norm"),
            initial_accumulator_value=float(
                cfg.hyper("optimizer.initial_accumulator_value", 0.1)),
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


class CTRModelDef(ModelDef):
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

    def _logits_and_aux(self, module: nn.Module,
                        batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits = module(*self.model_inputs(batch)).reshape(-1)
        aux = {
            "predictions": torch.sigmoid(logits),
            "labels": batch["label"].reshape(-1).to(torch.float32),
        }
        if "mask" in batch:
            aux["mask"] = batch["mask"]
        return logits, aux

    def train_forward(self, module: nn.Module,
                      batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits, aux = self._logits_and_aux(module, batch)
        return binary_logloss(logits, aux["labels"], aux.get("mask")), aux

    def infer_forward(self, module: nn.Module, batch: Batch) -> Aux:
        # the JAX package takes train_forward's aux and lets XLA drop the
        # unused loss; eager PyTorch would compute it, so it is left out here
        return self._logits_and_aux(module, batch)[1]
