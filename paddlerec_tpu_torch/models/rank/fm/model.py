"""Factorization Machine: first order + pairwise second order.

Counterpart of ``paddlerec_tpu/models/rank/fm/model.py``, registered as
``rank.fm``: the first-order weight rides in lane E of one fused E+1 table
(one K1 launch), and the dense values join the sum-square interaction as
extra fields, value × learned vector.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import fm_second_order, normal_param


class FMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (packed (R, 128)), ``dense_w`` (ones), ``dense_emb_w`` (D, E), ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int, dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = first-order weight
        self.dense_w = nn.Parameter(torch.ones(dense_dim, device=device))
        self.dense_emb_w = normal_param((dense_dim, embedding_dim), 1e-2,
                                        device, generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)
        emb = fused[..., :e]
        first = fused[..., e].sum(dim=1)
        dense_fields = dense[..., None] * self.dense_emb_w[None]  # (B, D, E)
        fields = torch.cat([emb.to(dense_fields.dtype), dense_fields], dim=1)
        return first + dense @ self.dense_w + fm_second_order(fields) + self.bias


@register_model("rank.fm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused lane

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FMNet(self.vocab_size, self.embedding_dim, self.dense_dim,
                     table_kwargs=self.table_kwargs(), device=device,
                     generator=generator)
