"""CtrDnn: embedding + MLP — the workhorse CTR baseline.

Counterpart of ``paddlerec_tpu/models/rank/dnn/model.py``, registered as
``rank.dnn``: shared sparse table, per-slot embeddings concatenated with the
dense features, ``fc_sizes`` ReLU tower, final linear to one logit.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense


class CtrDnnNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (packed (R, 128)), ``tower.fc_i``, ``head``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        self.tower = MLP(num_sparse * embedding_dim + dense_dim, fc_sizes,
                         device=device, generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)  # (B, S, E)
        feat = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                         dim=-1)
        return self.head(self.tower(feat))[:, 0]


@register_model("rank.dnn")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [512, 256, 128, 32]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return CtrDnnNet(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
