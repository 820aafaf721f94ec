"""xDeepFM: CIN (explicit vector-wise crosses) + DNN + linear.

Counterpart of ``paddlerec_tpu/models/rank/xdeepfm/model.py``, registered as
``rank.xdeepfm``.  Config keys ``layer_sizes_cin``, ``layer_sizes_dnn``; the
linear part's rank-1 weights ride in lane E of the fused table (one K1
launch); the dense values become extra embedded fields, so CIN crosses
dense × sparse over S + D fields, without split-half.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import CIN, MLP, flax_dense, normal_param


class XDeepFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``dense_w``, ``dense_emb_w``, ``cin.cin_w_k``, ``cin_head``,
    ``tower.fc_i``, ``dnn_head``, ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 layer_sizes_dnn: Sequence[int], layer_sizes_cin: Sequence[int],
                 num_sparse: int, dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = linear weight
        self.dense_w = normal_param((dense_dim,), 1e-4, device, generator)
        self.dense_emb_w = normal_param((dense_dim, embedding_dim), 1e-2,
                                        device, generator)
        fields = num_sparse + dense_dim
        self.cin = CIN(fields, layer_sizes_cin, split_half=False,
                       device=device, generator=generator)
        self.cin_head = flax_dense(sum(layer_sizes_cin), 1, device=device,
                                   generator=generator)
        self.tower = MLP(fields * embedding_dim, layer_sizes_dnn,
                         device=device, generator=generator)
        self.dnn_head = flax_dense(layer_sizes_dnn[-1], 1, device=device,
                                   generator=generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)
        emb = fused[..., :e]  # (B, S, E)
        linear = fused[..., e].sum(dim=1) + dense @ self.dense_w
        dense_fields = dense[..., None] * self.dense_emb_w[None]  # (B, D, E)
        fields = torch.cat([emb.to(dense_fields.dtype), dense_fields], dim=1)
        cin_logit = self.cin_head(self.cin(fields))[:, 0]
        hidden = self.tower(fields.reshape(fields.shape[0], -1))
        dnn_logit = self.dnn_head(hidden)[:, 0]
        return linear + cin_logit + dnn_logit + self.bias


@register_model("rank.xdeepfm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused lane
        self.layer_sizes_dnn = list(config.hyper("layer_sizes_dnn", [512, 256, 128]))
        self.layer_sizes_cin = list(config.hyper("layer_sizes_cin", [128, 32]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return XDeepFMNet(
            self.vocab_size, self.embedding_dim, self.layer_sizes_dnn,
            self.layer_sizes_cin, self.num_sparse, self.dense_dim,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
