"""DPIN: deep position-wise interaction network (position-bias CTR).

Counterpart of ``paddlerec_tpu/models/rank/dpin/model.py``, registered as
``rank.dpin``: a base module (item + context embeddings → ReLU MLP
1024-512-128); position-wise interest aggregation (the user's L behaviours at
each of K display positions pooled with ``exp`` weights divided by
``max(Σw, 1e-9)``); a non-linear interaction and a stack of transformer
blocks over the K position slots; per position a logit from [item MLP ‖
transformer output ‖ position embedding].  The output is (B, K), the loss
``sigmoid_binary_cross_entropy`` averaged over all B·K entries with no mask,
as the JAX module's ``optax`` call.  Six tables, six K1 launches a forward
and six K1b a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.models.base import binary_logloss
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense
from paddlerec_tpu_torch.ops.sequence import TransformerBlock


class DPINNet(nn.Module):
    """Parameters: ``item_feat_emb``, ``context_feat_emb``, ``base_0..2``,
    ``user_bx_item_emb``, ``user_bx_context_emb``, ``agg_fc1``, ``agg_fc2``,
    ``position_emb``, ``non_linear``, ``transformer_i``, ``position_emb_2``,
    ``comb_fc``, ``comb_out``."""

    def __init__(self, k: int, emb_dim: int, max_item: int, max_context: int,
                 d_model: int = 64, num_heads: int = 2, num_blocks: int = 12,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        e = emb_dim
        self.num_blocks = num_blocks
        self.item_feat_emb = Embed(max_item, e, **kw)
        self.context_feat_emb = Embed(max_context, e, **kw)
        width = 2 * e
        for i, d in enumerate((1024, 512, 128)):
            self.add_module(f"base_{i}", flax_dense(width, d, **kw))
            width = d
        self.user_bx_item_emb = Embed(max_item, e, **kw)
        self.user_bx_context_emb = Embed(max_context, e, **kw)
        self.agg_fc1 = flax_dense(2 * e, 2 * e, **kw)
        self.agg_fc2 = flax_dense(2 * e, 2 * e, **kw)
        self.position_emb = Embed(k, e, **kw)
        self.non_linear = flax_dense(3 * e, d_model, **kw)
        for i in range(num_blocks):
            self.add_module(f"transformer_{i}", TransformerBlock(
                d_model, num_heads, d_model // num_heads, d_model, **kw))
        self.position_emb_2 = Embed(k, e, **kw)
        self.comb_fc = flax_dense(128 + d_model + e, 128, **kw)
        self.comb_out = flax_dense(128, 1, **kw)

    def forward(self, hist_item, hist_cat, target_item, target_cat, position):
        h = torch.cat([self.context_feat_emb(target_cat),
                       self.item_feat_emb(target_item)], dim=-1)
        for i in range(3):
            h = F.relu(getattr(self, f"base_{i}")(h))  # (B, 128)

        user_bx = torch.cat([self.user_bx_item_emb(hist_item),
                             self.user_bx_context_emb(hist_cat)], dim=-1)  # (B, K, L, 2E)
        w = torch.exp(self.agg_fc2(F.relu(self.agg_fc1(user_bx))))
        interest = (user_bx * w).sum(dim=2) / torch.clamp(w.sum(dim=2), min=1e-9)

        x = F.relu(self.non_linear(torch.cat([self.position_emb(position), interest],
                                             dim=-1)))  # (B, K, d_model)
        ones = x.new_ones(x.shape[:2])
        for i in range(self.num_blocks):
            x = getattr(self, f"transformer_{i}")(x, ones)
        item_rep = h[:, None, :].expand(h.shape[0], x.shape[1], h.shape[-1])
        comb = torch.cat([item_rep, x, self.position_emb_2(position)], dim=-1)
        return self.comb_out(F.relu(self.comb_fc(comb)))[..., 0]  # (B, K)


@register_model("rank.dpin")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.K = int(h("K", 10))
        self.L = int(h("L", 10))
        self.max_item = int(h("max_item", 100000))
        self.max_context = int(h("max_context", 100000))
        self.emb_dim = int(h("emb_dim", 32))
        self.d_model = int(h("d_model", 64))
        self.num_heads = int(h("h", 2))
        self.num_blocks = int(h("num_blocks", 12))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DPINNet(self.K, self.emb_dim, self.max_item, self.max_context,
                       self.d_model, self.num_heads, self.num_blocks,
                       device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["hist_item"], batch["hist_cat"], batch["target_item"],
                batch["target_cat"], batch["position"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        k, length = self.K, self.L
        return {
            "hist_item": rng.randint(0, self.max_item, (batch_size, k, length)
                                     ).astype(np.int64),
            "hist_cat": rng.randint(0, self.max_context, (batch_size, k, length)
                                    ).astype(np.int64),
            "target_item": rng.randint(0, self.max_item, batch_size).astype(np.int64),
            "target_cat": rng.randint(0, self.max_context, batch_size).astype(np.int64),
            "position": np.tile(np.arange(k, dtype=np.int64), (batch_size, 1)),
            "label": (rng.rand(batch_size, k) < 0.3).astype(np.float32),
        }

    def _aux(self, logits: torch.Tensor, batch):
        return {"predictions": torch.sigmoid(logits).reshape(-1),
                "labels": batch["label"].to(torch.float32).reshape(-1)}

    def train_forward(self, module: nn.Module, batch):
        logits = module(*self.model_inputs(batch))
        loss = binary_logloss(logits, batch["label"].to(torch.float32))
        return loss, self._aux(logits, batch)

    def infer_forward(self, module: nn.Module, batch):
        return self._aux(module(*self.model_inputs(batch)), batch)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return DPINDataset(list_data_files(data_dir), batch_size, self.K, self.L)


class DPINDataset:
    """Lines: ``target_item,target_cat;K·L hist items;K·L hist cats;K
    labels`` (semicolon-separated groups, comma-separated ints).  A copy of
    the JAX package's reader (numpy only): the tail batch keeps its own size
    (no mask)."""

    def __init__(self, files, batch_size, K, L):
        self.files = files
        self.batch_size = batch_size
        self.K, self.L = K, L

    def __iter__(self):
        bs = self.batch_size
        buf = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(";")
                    if len(parts) < 4:
                        continue
                    buf.append(parts)
                    if len(buf) == bs:
                        yield self._batch(buf)
                        buf = []
        if buf:
            yield self._batch(buf)

    def _batch(self, rows):
        K, L = self.K, self.L
        n = len(rows)
        out = {
            "hist_item": np.zeros((n, K, L), np.int64),
            "hist_cat": np.zeros((n, K, L), np.int64),
            "target_item": np.zeros((n,), np.int64),
            "target_cat": np.zeros((n,), np.int64),
            "position": np.tile(np.arange(K, dtype=np.int64), (n, 1)),
            "label": np.zeros((n, K), np.float32),
        }
        for i, p in enumerate(rows):
            ti, tc = p[0].split(",")
            out["target_item"][i], out["target_cat"][i] = int(ti), int(tc)
            out["hist_item"][i] = np.asarray(
                [int(v) for v in p[1].split(",")][: K * L]).reshape(K, L)
            out["hist_cat"][i] = np.asarray(
                [int(v) for v in p[2].split(",")][: K * L]).reshape(K, L)
            out["label"][i] = [float(v) for v in p[3].split(",")][:K]
        return out
