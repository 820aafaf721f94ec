"""DIN: deep interest network, target attention over a behaviour history.

Counterpart of ``paddlerec_tpu/models/rank/din/model.py``, registered as
``rank.din``: item and category embeddings for the history and the target,
attention scores from ``MLP(concat[h, t, h - t, h * t])`` softmaxed over the
valid positions, the pooled history beside the target through a sigmoid
tower, plus a per-item bias.  Sequences are padded to a static
``max_seq_len``.  Each table is read once per forward (history and target in
one ``Embed`` call): three K1 launches a forward, three K1b a step.

``DINDataset`` is a copy of the JAX package's reader (numpy only); dien and
bst read the same format.  ``touched_tables`` names the rows of the item,
category and item-bias tables a batch touches (the online trainer's
deltas and feature lifecycle).
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
from paddlerec_tpu_torch.ops.layers import MLP, TargetAttention, flax_dense


class DINNet(nn.Module):
    """Parameters, named as the flax tree names them: ``item_emb``,
    ``cat_emb``, ``item_b`` (zeros), ``attention.att_mlp.fc_i``, ``proj``,
    ``tower.fc_i``."""

    def __init__(self, item_count: int, cat_count: int, item_emb_size: int = 64,
                 cat_emb_size: int = 64, attention_sizes: Sequence[int] = (80, 40),
                 fc_sizes: Sequence[int] = (80, 40), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.item_emb = Embed(item_count, item_emb_size, **kw)
        self.cat_emb = Embed(cat_count, cat_emb_size, **kw)
        self.item_b = Embed(item_count, 1, zeros=True, device=device)
        dim = item_emb_size + cat_emb_size
        self.attention = TargetAttention(dim, attention_sizes, scale_scores=True, **kw)
        self.proj = flax_dense(dim, dim, **kw)
        self.tower = MLP(2 * dim, list(fc_sizes) + [1], activation="sigmoid",
                         output_activation="none", **kw)

    def forward(self, hist_item, hist_cat, target_item, target_cat, seq_mask):
        hist_i, target_i = self.item_emb(hist_item, target_item)
        hist_c, target_c = self.cat_emb(hist_cat, target_cat)
        hist = torch.cat([hist_i, hist_c], dim=-1)  # (B, T, 2E)
        target = torch.cat([target_i, target_c], dim=-1)  # (B, 2E)
        pooled = self.attention(hist, target, seq_mask)
        feat = torch.cat([self.proj(pooled), target], dim=-1)
        return self.tower(feat)[:, 0] + self.item_b(target_item)[:, 0]


@register_model("rank.din")
class ModelDef(LogitModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        self.item_count = int(config.hyper("item_count", 63001))
        self.cat_count = int(config.hyper("cat_count", 801))
        self.max_seq_len = int(config.hyper("max_seq_len", 128))
        self.item_emb_size = int(config.hyper("item_emb_size", 64))
        self.cat_emb_size = int(config.hyper("cat_emb_size", 64))
        self.attention_sizes = tuple(config.hyper("attention_sizes", [80, 40]))
        self.fc_sizes = tuple(config.hyper("fc_sizes", [80, 40]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DINNet(self.item_count, self.cat_count, self.item_emb_size,
                      self.cat_emb_size, self.attention_sizes, self.fc_sizes,
                      device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["hist_item"], batch["hist_cat"], batch["target_item"],
                batch["target_cat"], batch["seq_mask"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.max_seq_len
        lens = rng.randint(1, t + 1, batch_size)
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        return {
            "hist_item": (rng.randint(0, self.item_count, (batch_size, t))
                          * seq_mask).astype(np.int32),
            "hist_cat": (rng.randint(0, self.cat_count, (batch_size, t))
                         * seq_mask).astype(np.int32),
            "target_item": rng.randint(0, self.item_count, batch_size).astype(np.int32),
            "target_cat": rng.randint(0, self.cat_count, batch_size).astype(np.int32),
            "seq_mask": seq_mask,
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def touched_tables(self, batch):
        """Exact per-table rows for delta publishing: the item and category
        tables have different row counts, so the fused-CTR default cannot
        cover them.  Padded history positions are left out by seq_mask."""
        live = np.asarray(batch["seq_mask"]) > 0
        items = np.concatenate([
            np.asarray(batch["hist_item"])[live].ravel(),
            np.asarray(batch["target_item"]).ravel(),
        ])
        cats = np.concatenate([
            np.asarray(batch["hist_cat"])[live].ravel(),
            np.asarray(batch["target_cat"]).ravel(),
        ])
        return {
            "item_emb/embedding": items % self.item_count,
            "item_b/embedding": items % self.item_count,
            "cat_emb/embedding": cats % self.cat_count,
        }

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return DINDataset(list_data_files(data_dir), self.max_seq_len, batch_size)


class DINDataset:
    """Amazon-format lines: ``hist_items;hist_cats;item;cat;label``
    (dinReader.py), padded/truncated to a static max_seq_len."""

    def __init__(self, files, max_seq_len, batch_size):
        self.files = files
        self.max_seq_len = max_seq_len
        self.batch_size = batch_size

    def __iter__(self):
        bs, t = self.batch_size, self.max_seq_len
        out = {
            "hist_item": np.zeros((bs, t), np.int32),
            "hist_cat": np.zeros((bs, t), np.int32),
            "target_item": np.zeros((bs,), np.int32),
            "target_cat": np.zeros((bs,), np.int32),
            "seq_mask": np.zeros((bs, t), np.float32),
            "label": np.zeros((bs,), np.float32),
        }
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(";")
                    if len(parts) < 5:
                        continue
                    hist = [int(x) for x in parts[0].split()][-t:]
                    cats = [int(x) for x in parts[1].split()][-t:]
                    n = min(len(hist), len(cats))
                    out["hist_item"][row, :n] = hist[:n]
                    out["hist_cat"][row, :n] = cats[:n]
                    out["seq_mask"][row, :n] = 1.0
                    out["target_item"][row] = int(parts[2])
                    out["target_cat"][row] = int(parts[3])
                    out["label"][row] = float(parts[4])
                    row += 1
                    if row == bs:
                        batch = {k: v.copy() for k, v in out.items()}
                        batch["mask"] = np.ones(bs, np.float32)
                        yield batch
                        for v in out.values():
                            v[:] = 0
                        row = 0
        if row:
            batch = {k: v.copy() for k, v in out.items()}
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            batch["mask"] = mask
            yield batch
