"""DCN-v2: full-rank CrossNetV2 or low-rank mixture CrossNetMix.

Counterpart of ``paddlerec_tpu/models/rank/dcn_v2/model.py``, registered as
``rank.dcn_v2``.  Config keys: ``is_Stacked`` (cross → DNN stacked, or the
two in parallel and concatenated), ``use_low_rank_mixture`` (default true),
``low_rank`` (32), ``num_experts`` (4), ``cross_num``, ``fc_sizes``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import (
    MLP, CrossNetMix, CrossNetV2, flax_dense,
)


class DCNv2Net(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``crossnet.{U,V,C,b,gate}_l`` (mixture) or ``crossnet.cross_l`` (full
    rank), ``tower.fc_i``, ``head``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 cross_num: int = 2, is_stacked: bool = True,
                 use_low_rank_mixture: bool = True, low_rank: int = 32,
                 num_experts: int = 4,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.is_stacked = is_stacked
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        dim = num_sparse * embedding_dim + dense_dim
        if use_low_rank_mixture:
            self.crossnet = CrossNetMix(dim, cross_num, low_rank=low_rank,
                                        num_experts=num_experts, device=device,
                                        generator=generator)
        else:
            self.crossnet = CrossNetV2(dim, cross_num, device=device,
                                       generator=generator)
        self.tower = MLP(dim, fc_sizes, device=device, generator=generator)
        self.head = flax_dense(
            fc_sizes[-1] if is_stacked else dim + fc_sizes[-1], 1,
            device=device, generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)
        x0 = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                       dim=-1)
        cross_out = self.crossnet(x0)
        if self.is_stacked:
            final = self.tower(cross_out)
        else:
            final = torch.cat([cross_out, self.tower(x0)], dim=-1)
        return self.head(final)[:, 0]


@register_model("rank.dcn_v2")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [768, 768]))
        self.cross_num = int(config.hyper("cross_num", 2))
        self.is_stacked = bool(config.hyper("is_Stacked", True))
        self.use_low_rank_mixture = bool(config.hyper("use_low_rank_mixture", True))
        self.low_rank = int(config.hyper("low_rank", 32))
        self.num_experts = int(config.hyper("num_experts", 4))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DCNv2Net(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, self.cross_num, self.is_stacked,
            self.use_low_rank_mixture, self.low_rank, self.num_experts,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
