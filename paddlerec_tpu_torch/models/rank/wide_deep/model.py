"""Wide&Deep: wide LR over sparse ids + deep MLP.

Counterpart of ``paddlerec_tpu/models/rank/wide_deep/model.py``, registered
as ``rank.wide_deep``: the wide part is a rank-1 per-id weight (+ a dense
linear), the deep part an MLP over [slot embeddings, dense].  The wide
weight rides in an extra lane of the shared packed table, so one lookup (one
K1 launch) serves both parts.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense


class WideDeepNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (packed (R, 128)), ``wide_dense_w``, ``tower.fc_i``, ``head``, ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = wide weight
        self.wide_dense_w = nn.Parameter(
            torch.randn(dense_dim, generator=generator, device=device) * 1e-4
        )
        self.tower = MLP(num_sparse * embedding_dim + dense_dim, fc_sizes,
                         device=device, generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)
        emb = fused[..., :e]  # (B, S, E)
        wide = fused[..., e].sum(dim=1) + dense @ self.wide_dense_w
        feat = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                         dim=-1)
        deep = self.head(self.tower(feat))[:, 0]
        return wide + deep + self.bias


@register_model("rank.wide_deep")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [512, 256, 128, 32]))
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused w1 lane

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return WideDeepNet(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
