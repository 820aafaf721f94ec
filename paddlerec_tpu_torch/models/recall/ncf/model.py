"""NCF: NeuMF, GMF and MLP collaborative filtering.

Counterpart of ``paddlerec_tpu/models/recall/ncf/model.py``, registered as
``recall.ncf``: ``mode`` ``NCF_NeuMF`` (default) joins a GMF branch (the
product of ``mf_user`` and ``mf_item``, 6,040 / 3,706 × ``mf_dim`` 8) and an
MLP branch (``mlp_user`` / ``mlp_item`` × ``fc_layers[0] / 2`` = 32,
concatenated, through ``mlp_tower`` [32, 16, 8] with a ReLU output) under
one ``head`` logit; ``NCF_GMF`` and ``NCF_MLP`` keep one branch.  Trained
with the sigmoid log-loss on ``label``; the AUC is logged as ``auc``.

Each table is read once a forward: four K1 launches (NeuMF), four K1b a
step.  ``NCFDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import LogitModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense

MODES = ("NCF_NeuMF", "NCF_GMF", "NCF_MLP")


class NCFNet(nn.Module):
    """users, items (B,) → logits (B,)."""

    def __init__(self, num_users: int, num_items: int, mf_dim: int,
                 fc_layers: Sequence[int], mode: str, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown ncf mode {mode!r}; choose one of {MODES}")
        kw = {"device": device, "generator": generator}
        self.gmf = mode in ("NCF_NeuMF", "NCF_GMF")
        self.mlp = mode in ("NCF_NeuMF", "NCF_MLP")
        width = 0
        if self.gmf:
            self.mf_user = Embed(num_users, mf_dim, **kw)
            self.mf_item = Embed(num_items, mf_dim, **kw)
            width += mf_dim
        if self.mlp:
            dim = fc_layers[0] // 2
            self.mlp_user = Embed(num_users, dim, **kw)
            self.mlp_item = Embed(num_items, dim, **kw)
            self.mlp_tower = MLP(2 * dim, list(fc_layers[1:]), output_activation="relu",
                                 **kw)
            width += fc_layers[-1]
        self.head = flax_dense(width, 1, **kw)

    def forward(self, users, items):
        outs = []
        if self.gmf:
            outs.append(self.mf_user(users) * self.mf_item(items))
        if self.mlp:
            outs.append(self.mlp_tower(torch.cat([self.mlp_user(users),
                                                  self.mlp_item(items)], dim=-1)))
        return self.head(torch.cat(outs, dim=-1))[:, 0]


@register_model("recall.ncf")
class ModelDef(LogitModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        self.num_users = int(config.hyper("num_users", 6040))
        self.num_items = int(config.hyper("num_items", 3706))
        self.mf_dim = int(config.hyper("mf_dim", 8))
        self.fc_layers = [int(x) for x in config.hyper("fc_layers", [64, 32, 16, 8])]
        self.mode = str(config.hyper("mode", "NCF_NeuMF"))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return NCFNet(self.num_users, self.num_items, self.mf_dim, self.fc_layers,
                      self.mode, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["users"], batch["items"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "users": rng.randint(0, self.num_users, batch_size).astype(np.int32),
            "items": rng.randint(0, self.num_items, batch_size).astype(np.int32),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return NCFDataset(list_data_files(data_dir), batch_size)


class NCFDataset:
    """CSV lines ``user,item,label`` (the movielens reader's format); lines
    of fewer than three fields skipped; the tail batch padded with zero rows
    and ``mask`` 0."""

    def __init__(self, files, batch_size):
        self.files = files
        self.batch_size = batch_size

    def __iter__(self):
        users, items, labels = [], [], []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 3:
                        continue
                    users.append(int(parts[0]))
                    items.append(int(parts[1]))
                    labels.append(float(parts[2]))
                    if len(users) == self.batch_size:
                        yield self._emit(users, items, labels, self.batch_size)
                        users, items, labels = [], [], []
        if users:
            yield self._emit(users, items, labels, self.batch_size)

    @staticmethod
    def _emit(users, items, labels, bs):
        n = len(users)
        pad = bs - n
        mask = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)
        return {
            "users": np.asarray(users + [0] * pad, np.int32),
            "items": np.asarray(items + [0] * pad, np.int32),
            "label": np.asarray(labels + [0.0] * pad, np.float32),
            "mask": mask,
        }
