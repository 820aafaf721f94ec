"""DIFM: dual input-aware factorization machine.

Counterpart of ``paddlerec_tpu/models/rank/difm/model.py``, registered as
``rank.difm``: a vector-wise FEN (one multi-head self-attention block over
the field embeddings, scores scaled by √head_dim, with a residual
projection) and a bit-wise FEN (a DNN) each give per-field input-aware
factors; the softmax of their sum over the fields, times S, reweights the
first-order weights and the field embeddings before the FM interaction.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import (
    MLP, flax_dense, fm_second_order, normal_param,
)


class DIFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (E+1 lanes), ``q``, ``k``, ``v``, ``w_res`` (no bias), ``vec_head``,
    ``bit_fen.fc_i``, ``bit_head``, ``dense_emb_w``, ``dense_w``, ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 dense_dim: int, att_heads: int = 4, att_dim: int = 16,
                 fen_sizes: Sequence[int] = (256, 128),
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s, e, h, hd = num_fields, embedding_dim, att_heads, att_dim
        self.embedding_dim, self.att_heads, self.att_dim = e, h, hd
        self.embedding = SlotEmbedding(
            vocab_size, e + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = first-order weight
        for name in ("q", "k", "v", "w_res"):
            self.add_module(name, flax_dense(e, h * hd, device=device,
                                             generator=generator, bias=False))
        self.vec_head = flax_dense(h * hd, 1, device=device, generator=generator)
        self.bit_fen = MLP(s * e, fen_sizes, device=device, generator=generator)
        self.bit_head = flax_dense(fen_sizes[-1], s, device=device,
                                   generator=generator)
        self.dense_emb_w = normal_param((dense_dim, e), 1e-2, device, generator)
        self.dense_w = normal_param((dense_dim,), 1e-4, device, generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e, h, hd = self.embedding_dim, self.att_heads, self.att_dim
        fused = self.embedding(sparse_ids)
        emb = fused[..., :e]  # (B, S, E)
        w1 = fused[..., e]  # (B, S)
        b, s = w1.shape
        x = emb.float()  # a linear layer widens a bfloat16 lookup

        def split(t):
            return t.reshape(b, s, h, hd).transpose(1, 2)

        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        att = torch.softmax(
            torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", att, vh)
        out = out.transpose(1, 2).reshape(b, s, h * hd) + self.w_res(x)
        m_vec = self.vec_head(out)[..., 0]
        m_bit = self.bit_head(self.bit_fen(x.reshape(b, -1)))
        m = torch.softmax(m_vec + m_bit, dim=-1) * s  # (B, S)
        first = (w1 * m).sum(dim=1)
        dense_fields = dense[..., None] * self.dense_emb_w[None]
        fields = torch.cat([emb * m[..., None], dense_fields], dim=1)
        return first + dense @ self.dense_w + fm_second_order(fields) + self.bias


@register_model("rank.difm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused lane
        self.att_heads = int(config.hyper("att_head_num", 4))
        self.att_dim = int(config.hyper("att_factor_dim", 16))
        self.fen_sizes = list(config.hyper("fen_layers_size", [256, 128]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DIFMNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.dense_dim, self.att_heads, self.att_dim, self.fen_sizes,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
