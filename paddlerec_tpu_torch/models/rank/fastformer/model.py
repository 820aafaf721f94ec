"""Fastformer news recommender: NAML with additive-attention transformers.

Counterpart of ``paddlerec_tpu/models/rank/fastformer/model.py``, registered
as ``rank.fastformer``: NAML's multi-view news encoder where the title and
content pooling is a **Fastformer** encoder (Wu et al. 2021): position
embeddings and an input LayerNorm, ``num_hidden_layers`` layers of
linear-time additive attention (per head a softmax over query scores pools
a global query; query-modulated keys are pooled the same way into a global
key; the values, which are the queries, are modulated and transformed
residually), each followed by a gelu feed-forward, and an attention-pooling
readout.  The user tower runs ``FastSelfAttention`` layers over the browsed
news with a learned position table ``user_pos_emb``.  Defaults: 16 heads, 2
layers, intermediate 256, width 400.

The three LayerNorms of each encoder layer path take epsilon 1e-12, as the
JAX model's do.  The word table is read once per forward (title and content
ids in one ``Embed`` call); with the two category tables and the two
encoders' ``position_emb`` that is five K1 launches a forward and five K1b
a step.  The loss, metrics and reader are naml's (``NewsRecModelDef``,
``NewsDataset``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.rank.naml.model import (
    AdditiveAttention, CategoryViews, NewsRecModelDef, concat_news, conv_same,
    news_conv,
)
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import _ACTIVATIONS, LayerNorm, flax_dense
from paddlerec_tpu_torch.ops.sequence import positions

_GELU = _ACTIVATIONS["gelu"]  # flax's nn.gelu: the tanh form


class FastSelfAttention(nn.Module):
    """Additive-attention token mixing: ``query``, ``key`` (D → D),
    ``query_att``, ``key_att`` (D → heads), ``transform`` (D → D).  Masked
    positions add -1e4 to the scores.  x (B, T, D), mask (B, T) → (B, T,
    D)."""

    def __init__(self, hidden_size: int, num_heads: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.num_heads = num_heads
        self.query = flax_dense(hidden_size, hidden_size, **kw)
        self.key = flax_dense(hidden_size, hidden_size, **kw)
        self.query_att = flax_dense(hidden_size, num_heads, **kw)
        self.key_att = flax_dense(hidden_size, num_heads, **kw)
        self.transform = flax_dense(hidden_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        scale = math.sqrt(hd)
        q = self.query(x)
        k = self.key(x)
        neg = (1.0 - mask) * -1e4
        # global query: per-head softmax over positions
        q_w = torch.softmax(self.query_att(q).transpose(1, 2) / scale + neg[:, None, :], dim=-1)
        q_heads = q.reshape(b, t, h, hd).transpose(1, 2)  # (B, H, T, hd)
        pooled_q = torch.einsum("bht,bhtd->bhd", q_w, q_heads).reshape(b, 1, d)
        # key modulated by the global query, pooled the same way
        qk = k * pooled_q
        k_w = torch.softmax(self.key_att(qk).transpose(1, 2) / scale + neg[:, None, :], dim=-1)
        k_heads = qk.reshape(b, t, h, hd).transpose(1, 2)
        pooled_k = torch.einsum("bht,bhtd->bhd", k_w, k_heads)  # (B, H, hd)
        weighted = (pooled_k[:, :, None, :] * q_heads).transpose(1, 2).reshape(b, t, d)
        return self.transform(weighted) + q


class FastformerLayer(nn.Module):
    """``self_attention``, ``att_dense``, ``att_ln`` (eps 1e-12) over
    attention + x, ``inter`` with gelu, ``out``, ``out_ln`` (eps 1e-12)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.self_attention = FastSelfAttention(hidden_size, num_heads, **kw)
        self.att_dense = flax_dense(hidden_size, hidden_size, **kw)
        self.att_ln = LayerNorm(hidden_size, eps=1e-12, device=device)
        self.inter = flax_dense(hidden_size, intermediate_size, **kw)
        self.out = flax_dense(intermediate_size, hidden_size, **kw)
        self.out_ln = LayerNorm(hidden_size, eps=1e-12, device=device)

    def forward(self, x, mask):
        x = self.att_ln(self.att_dense(self.self_attention(x, mask)) + x)
        return self.out_ln(self.out(_GELU(self.inter(x))) + x)


class FastformerEncoder(nn.Module):
    """``position_emb`` (``max_position`` rows) + ``input_ln`` (eps 1e-12) +
    ``layer_i`` + the attention-pooling readout ``pool_fc`` / ``pool_att``.
    x (B, T, D), mask (B, T) → (B, D)."""

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 intermediate_size: int, max_position: int = 256, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.num_layers = num_layers
        self.position_emb = Embed(max_position, hidden_size, **kw)
        self.input_ln = LayerNorm(hidden_size, eps=1e-12, device=device)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FastformerLayer(
                hidden_size, num_heads, intermediate_size, **kw))
        self.pool_fc = flax_dense(hidden_size, hidden_size, **kw)
        self.pool_att = flax_dense(hidden_size, 1, **kw)

    def forward(self, x, mask):
        b, t, _ = x.shape
        # one position id per token, as the JAX model's iota: (B, T) ids
        pos = positions(t, t, x.device).expand(b, t)
        x = self.input_ln(x + self.position_emb(pos))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        score = self.pool_att(torch.tanh(self.pool_fc(x)))[..., 0]
        w = torch.softmax(score + (1.0 - mask) * -1e4, dim=-1)
        return torch.einsum("bt,btd->bd", w, x)


class FastformerNewsEncoder(CategoryViews):
    """NAML's views with ``conv_title`` (with bias) then a
    ``FastformerEncoder`` for title and content each (``title_attention``,
    ``content_attention``; the pad token ``word_dict_size`` is masked), and
    ``mix_attention`` over the four views."""

    def __init__(self, word_dict_size: int, word_dim: int, category_size: int,
                 sub_category_size: int, cate_dim: int, conv_out: int, num_heads: int,
                 num_layers: int, intermediate_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(category_size, sub_category_size, cate_dim, conv_out,
                         device, generator)
        kw = {"device": device, "generator": generator}
        self.word_dict_size = word_dict_size
        self.word2vec_embedding = Embed(word_dict_size + 1, word_dim, **kw)
        self.conv_title = news_conv(word_dim, conv_out, True, **kw)
        for name in ("title_attention", "content_attention"):
            self.add_module(name, FastformerEncoder(
                conv_out, num_heads, num_layers, intermediate_size, **kw))
        self.mix_attention = AdditiveAttention(conv_out, **kw)

    def forward(self, category, sub_category, title, content):
        cate_v, sub_v = self.views(category, sub_category)
        title_w, content_w = self.word2vec_embedding(title, content)
        tmask = (title != self.word_dict_size).to(torch.float32)
        cmask = (content != self.word_dict_size).to(torch.float32)
        title_v = self.title_attention(torch.relu(conv_same(self.conv_title, title_w)), tmask)
        content_v = self.content_attention(
            torch.relu(conv_same(self.conv_title, content_w)), cmask)
        views = torch.stack([title_v, content_v, cate_v, sub_v], dim=1)
        return self.mix_attention(views)


class FastRecommenderNet(nn.Module):
    """Parameters ``news_encoder``, ``user_pos_emb`` (1, browse, D)
    normal(0.02), ``user_layer_i`` (``FastSelfAttention``),
    ``user_attention``; returns the (B, S) candidate logits."""

    def __init__(self, word_dict_size: int, word_dim: int, category_size: int,
                 sub_category_size: int, cate_dim: int, sample_size: int,
                 browse_size: int, num_heads: int = 16, num_layers: int = 2,
                 intermediate_size: int = 256, conv_out: int = 400, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.sample_size = sample_size
        self.conv_out = conv_out
        self.num_layers = num_layers
        self.news_encoder = FastformerNewsEncoder(
            word_dict_size, word_dim, category_size, sub_category_size, cate_dim,
            conv_out, num_heads, num_layers, intermediate_size, **kw)
        self.user_pos_emb = nn.Parameter(
            torch.randn((1, browse_size, conv_out), generator=generator, device=device)
            * 0.02)
        for i in range(num_layers):
            self.add_module(f"user_layer_{i}", FastSelfAttention(conv_out, num_heads, **kw))
        self.user_attention = AdditiveAttention(conv_out, **kw)

    def forward(self, *news):
        cate, sub, title, content, b, g = concat_news(*news)
        vecs = self.news_encoder(cate, sub, title, content).reshape(b, g, self.conv_out)
        sample_emb = vecs[:, :self.sample_size]
        u = vecs[:, self.sample_size:] + self.user_pos_emb
        ones = u.new_ones(u.shape[:2])
        for i in range(self.num_layers):
            u = getattr(self, f"user_layer_{i}")(u, ones)
        user = self.user_attention(u)
        return torch.einsum("bsd,bd->bs", sample_emb, user)


@register_model("rank.fastformer")
class ModelDef(NewsRecModelDef):
    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.num_heads = int(h("num_attention_heads", 16))
        self.num_layers = int(h("num_hidden_layers", 2))
        self.intermediate_size = int(h("intermediate_size", 256))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FastRecommenderNet(
            self.word_dict_size, self.word_dim, self.category_size,
            self.sub_category_size, self.cate_dim, self.neg_size + 1,
            self.browse_size, self.num_heads, self.num_layers,
            self.intermediate_size, device=device, generator=generator)
