"""ENSFM: efficient non-sampling factorization machines.

Counterpart of ``paddlerec_tpu/models/recall/ensfm/model.py``, registered as
``recall.ensfm``: user feature rows (``user_feature_emb``, ``num_users`` ×
``mf_dim``, 6,069 × 8 by default) and the whole item catalogue's
(``all_item_feature_emb``, (``num_items`` + 1) × ``mf_dim``) with their
biases, truncated-normal(0.01) tables; the FM representations p (B, E+2) of
the batch's users and q (I, E+2) of every item, augmented with their cross
terms (``H_s``) and bias columns; a score ``(p ⊙ q)·[H_i; 1; 1]``.  The loss
is the non-sampling squared loss over all (user, item) pairs in closed form,
``w·Σ (ΣqqT ⊙ ΣppT ⊙ hhT)`` plus ``Σ_pos ((1−w)·r̂² − 2·r̂)`` over the batch's
positives (padded with the ``num_items`` pad token, clipped and masked).
No streaming metric (``metrics = "none"``); ``infer_forward`` gives the
(B, I) ``scores``, the serving call.  The optimizer is Adagrad
(``optimizer.learning_rate``, 0.05 by default, initial accumulator 1e-8),
whatever the config names, as in the JAX package.

Five K1 launches a training forward and five K1b a step: the four tables
(the catalogue's at N = ``num_items`` every step) and the positives' rows of
q, a gather from an activation (``take_rows``, ``jnp.take(..., mode=
"clip")``), whose gradient K1b carries back into q.  Serving reads the four
tables.

``ENSFMDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.embedding import Embed, take_rows


class ENSFMNet(nn.Module):
    def __init__(self, user_field_m: int, item_field_m: int, embedding_size: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator, "stddev": 0.01, "truncated": True}
        e = embedding_size
        self.item_field_m = item_field_m
        self.user_feature_emb = Embed(user_field_m, e, **kw)
        self.all_item_feature_emb = Embed(item_field_m + 1, e, **kw)
        self.user_bias = Embed(user_field_m, 1, **kw)
        self.item_bias = Embed(item_field_m, 1, **kw)
        self.H_i = nn.Parameter(torch.full((e, 1), 0.01, device=device))
        self.H_s = nn.Parameter(torch.full((e, 1), 0.01, device=device))
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, input_u, item_attribute, input_ur=None, item_bind_m=None):
        """input_u (B, Fu) user feature ids; item_attribute (I, Fi) the whole
        catalogue's features; input_ur (B, P) positive items, padded with
        ``item_bind_m``."""
        ue = self.user_feature_emb(input_u)
        ie = self.all_item_feature_emb(item_attribute)
        sum_u, sum_i = ue.sum(1), ie.sum(1)
        user_cross = 0.5 * (sum_u ** 2 - (ue ** 2).sum(1))
        item_cross = 0.5 * (sum_i ** 2 - (ie ** 2).sum(1))
        u_score = user_cross @ self.H_s + self.user_bias(input_u).sum(1) + self.bias
        i_score = item_cross @ self.H_s + self.item_bias(
            torch.clamp(item_attribute, max=self.item_field_m - 1)).sum(1)
        p_emb = torch.cat([sum_u, u_score, torch.ones_like(u_score)], 1)  # (B, E+2)
        q_emb = torch.cat([sum_i, torch.ones_like(i_score), i_score], 1)  # (I, E+2)
        h_emb = torch.cat([self.H_i, torch.ones((2, 1), device=self.H_i.device)], 0)
        pre = ((p_emb[:, None, :] * q_emb[None]) @ h_emb)[..., 0]  # (B, I)
        if input_ur is None:
            return (pre,)
        # the pad token item_bind_m is out of range: clipped, then masked
        pos_item = take_rows(q_emb, input_ur)
        pos_item = pos_item * (input_ur != item_bind_m).to(q_emb.dtype)[..., None]
        pos_r = ((p_emb[:, None, :] * pos_item) @ h_emb)[..., 0]  # (B, P)
        return pre, pos_r, q_emb, p_emb, h_emb


@register_model("recall.ensfm")
class ModelDef(BaseModelDef):
    metrics = "none"
    metric_names = ()

    def __init__(self, config):
        super().__init__(config)
        self.num_users = int(config.hyper("num_users", 6069))
        self.num_items = int(config.hyper("num_items", 3953))
        self.mf_dim = int(config.hyper("mf_dim", 8))
        self.negative_weight = float(config.hyper("negative_weight", 0.5))
        self.max_pos = int(config.hyper("max_positives", 64))

    def _base_optimizer(self):
        return {"name": "adagrad",
                "lr": float(self.config.hyper("optimizer.learning_rate", 0.05)),
                "initial_accumulator_value": 1e-8}

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return ENSFMNet(self.num_users, self.num_items, self.mf_dim, device=device,
                        generator=generator)

    def model_inputs(self, batch):
        return (batch["user_features"], batch["item_attribute"], batch["positives"],
                self.num_items)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        positives = rng.randint(0, self.num_items, (batch_size, self.max_pos)).astype(np.int64)
        positives[:, self.max_pos // 2:] = self.num_items  # pad token
        return {
            "user_features": rng.randint(0, self.num_users, (batch_size, 1)).astype(np.int64),
            "item_attribute": np.arange(self.num_items, dtype=np.int64)[:, None],
            "positives": positives,
        }

    def train_forward(self, module, batch):
        pre, pos_r, q_emb, p_emb, h_emb = module(*self.model_inputs(batch))
        w = self.negative_weight
        # closed-form all-pair term: (Σ q qᵀ) ⊙ (Σ p pᵀ) ⊙ (h hᵀ)
        loss_all = w * torch.sum((q_emb.T @ q_emb) * (p_emb.T @ p_emb) * (h_emb @ h_emb.T))
        loss_pos = torch.sum((1.0 - w) * pos_r ** 2 - 2.0 * pos_r)
        return loss_all + loss_pos, {"scores": pre}

    def infer_forward(self, module, batch):
        (pre,) = module(batch["user_features"], batch["item_attribute"])
        return {"scores": pre}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return ENSFMDataset(list_data_files(data_dir), self.num_users, self.num_items,
                            self.max_pos, batch_size)


class ENSFMDataset:
    """Interaction CSV in the reference's movielens binding format: each line
    one positive interaction ``ufeat1-ufeat2-...,ifeat1-ifeat2-...``.
    Distinct user and item feature tuples are bound to dense ids in
    first-seen order; a batch row is one user with its positive items
    padded to ``max_pos`` with the ``num_items`` pad token."""

    def __init__(self, files, num_users, num_items, max_pos, batch_size):
        self.files = list(files)
        self.num_users = num_users
        self.num_items = num_items
        self.max_pos = max_pos
        self.batch_size = batch_size

    def __iter__(self):
        users, items, pos = {}, {}, {}
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 2:
                        continue
                    uid = users.setdefault(parts[0], len(users))
                    iid = items.setdefault(parts[1], len(items))
                    pos.setdefault(uid % self.num_users, []).append(iid % self.num_items)
        item_attr = np.arange(self.num_items, dtype=np.int64)[:, None]
        uids = sorted(pos)
        bs, mp = self.batch_size, self.max_pos
        for i in range(0, len(uids), bs):
            chunk = uids[i:i + bs]
            positives = np.full((len(chunk), mp), self.num_items, np.int64)
            for r, u in enumerate(chunk):
                p = pos[u][:mp]
                positives[r, :len(p)] = p
            yield {"user_features": np.asarray(chunk, np.int64)[:, None],
                   "item_attribute": item_attr, "positives": positives}
