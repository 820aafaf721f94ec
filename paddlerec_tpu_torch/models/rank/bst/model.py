"""BST: behaviour-sequence transformer.

Counterpart of ``paddlerec_tpu/models/rank/bst/model.py``, registered as
``rank.bst``: item + category (+ position) embeddings over the history, the
target appended as the last sequence element, transformer blocks with a
key-padding mask, then the masked mean and the target position's output
through a ReLU tower to one logit.  Positions are clipped to
``position_size - 1``.  It reads din's format (``DINDataset``).  Three K1
launches a forward (item, category, position), three K1b a step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.rank.din.model import ModelDef as DINModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense
from paddlerec_tpu_torch.ops.sequence import TransformerBlock, positions


class BSTNet(nn.Module):
    """Parameters: ``item_emb``, ``cat_emb``, ``pos_emb``, ``block_i.{q, k, v,
    proj, ln1, ffn1, ffn2, ln2}``, ``tower.fc_i``, ``head``."""

    def __init__(self, item_count: int, cat_count: int, item_emb_size: int = 64,
                 cat_emb_size: int = 64, position_size: int = 256, num_heads: int = 2,
                 num_blocks: int = 1, ffn_dim: int = 128,
                 fc_sizes: Sequence[int] = (256, 128, 64), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        d = item_emb_size + cat_emb_size
        self.position_size, self.num_blocks = position_size, num_blocks
        self.item_emb = Embed(item_count, item_emb_size, **kw)
        self.cat_emb = Embed(cat_count, cat_emb_size, **kw)
        self.pos_emb = Embed(position_size, d, **kw)
        for i in range(num_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                d, num_heads, d // num_heads, ffn_dim, **kw))
        self.tower = MLP(2 * d, fc_sizes, **kw)
        self.head = flax_dense(fc_sizes[-1], 1, **kw)

    def forward(self, hist_item, hist_cat, target_item, target_cat, seq_mask):
        hist_i, target_i = self.item_emb(hist_item, target_item)
        hist_c, target_c = self.cat_emb(hist_cat, target_cat)
        hist = torch.cat([hist_i, hist_c], dim=-1)
        target = torch.cat([target_i, target_c], dim=-1)[:, None, :]
        seq = torch.cat([hist, target], dim=1)  # (B, T+1, D)
        # one row per position, added to every example: the lookup the JAX
        # module makes for each (example, position), once
        x = seq + self.pos_emb(positions(seq.shape[1], self.position_size, seq.device))
        full_mask = torch.cat([seq_mask, seq_mask.new_ones(seq_mask.shape[0], 1)], dim=1)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, full_mask)
        pooled = (x * full_mask[..., None]).sum(dim=1) / torch.clamp(
            full_mask.sum(dim=1, keepdim=True), min=1.0)
        feat = torch.cat([pooled, x[:, -1, :]], dim=-1)
        return self.head(self.tower(feat))[:, 0]


@register_model("rank.bst")
class ModelDef(DINModelDef):
    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.max_seq_len = int(h("max_seq_len", 64))
        self.position_size = max(int(h("position_size", 256)), self.max_seq_len + 2)
        self.num_heads = int(h("n_head", 2))
        self.num_blocks = int(h("num_blocks", 1))
        self.ffn_dim = int(h("ffn_dim", 128))
        self.fc_sizes = tuple(h("fc_sizes", [256, 128, 64]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return BSTNet(self.item_count, self.cat_count, self.item_emb_size,
                      self.cat_emb_size, self.position_size, self.num_heads,
                      self.num_blocks, self.ffn_dim, self.fc_sizes,
                      device=device, generator=generator)

    def touched_tables(self, batch):
        # the JAX package's bst derives from the plain ModelDef, not din's:
        # its tables take the default mapping (none, without "sparse")
        return None
