"""DIEN: deep interest evolution network.

Counterpart of ``paddlerec_tpu/models/rank/dien/model.py``, registered as
``rank.dien``: an interest-extraction GRU over the behaviour embeddings,
target-attention scores over its states, AUGRU interest evolution, and a
sigmoid tower over [evolved interest, target, pooled history, interest ×
projected target].  The paper's auxiliary next-click loss is left out, as in
the JAX module.  It reads din's format (``DINDataset``) and reuses din's
``ModelDef`` for it.  The two recurrences run T Python-level steps each
(``ops/sequence.py``); the lookups are two K1 launches a forward, two K1b a
step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.rank.din.model import ModelDef as DINModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense
from paddlerec_tpu_torch.ops.sequence import AUGRU, GRU


class DIENNet(nn.Module):
    """Parameters: ``item_emb``, ``cat_emb``, ``extract_gru.{wi,wh}``,
    ``target_proj``, ``attention.fc_i``, ``evolve_augru.{wi,wh}``,
    ``tower.fc_i``, ``head``."""

    def __init__(self, item_count: int, cat_count: int, item_emb_size: int = 64,
                 cat_emb_size: int = 64, gru_hidden: int = 128,
                 attention_sizes: Sequence[int] = (80, 40),
                 fc_sizes: Sequence[int] = (200, 80), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.item_emb = Embed(item_count, item_emb_size, **kw)
        self.cat_emb = Embed(cat_count, cat_emb_size, **kw)
        dim = item_emb_size + cat_emb_size
        self.extract_gru = GRU(dim, gru_hidden, **kw)
        self.target_proj = flax_dense(dim, gru_hidden, **kw)
        self.attention = MLP(4 * gru_hidden, list(attention_sizes) + [1],
                             activation="sigmoid", output_activation="none", **kw)
        self.evolve_augru = AUGRU(gru_hidden, gru_hidden, **kw)
        self.tower = MLP(2 * gru_hidden + 2 * dim, list(fc_sizes), activation="sigmoid",
                         output_activation="sigmoid", **kw)
        self.head = flax_dense(fc_sizes[-1], 1, **kw)

    def forward(self, hist_item, hist_cat, target_item, target_cat, seq_mask):
        hist_i, target_i = self.item_emb(hist_item, target_item)
        hist_c, target_c = self.cat_emb(hist_cat, target_cat)
        hist = torch.cat([hist_i, hist_c], dim=-1)
        target = torch.cat([target_i, target_c], dim=-1)

        states, _ = self.extract_gru(hist, seq_mask)  # interest extraction
        tgt = self.target_proj(target)
        t_seq = tgt[:, None, :].expand_as(states)
        att_in = torch.cat([states, t_seq, states - t_seq, states * t_seq], dim=-1)
        scores = self.attention(att_in)[..., 0].masked_fill(seq_mask <= 0, -1e9)
        att = torch.softmax(scores, dim=-1)
        _, final = self.evolve_augru(states, att, seq_mask)  # interest evolution

        pooled = (hist * seq_mask[..., None]).sum(dim=1) / torch.clamp(
            seq_mask.sum(dim=1, keepdim=True), min=1.0)
        feat = torch.cat([final, target, pooled, final * tgt], dim=-1)
        return self.head(self.tower(feat))[:, 0]


@register_model("rank.dien")
class ModelDef(DINModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.max_seq_len = int(config.hyper("max_seq_len", 64))
        self.gru_hidden = int(config.hyper("gru_hidden", 128))
        self.fc_sizes = tuple(config.hyper("fc_sizes", [200, 80]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DIENNet(self.item_count, self.cat_count, self.item_emb_size,
                       self.cat_emb_size, self.gru_hidden, self.attention_sizes,
                       self.fc_sizes, device=device, generator=generator)

    def touched_tables(self, batch):
        # DIN's hook minus item_b (DIEN's net has no item-bias table)
        out = super().touched_tables(batch)
        out.pop("item_b/embedding", None)
        return out
