"""DeepFEFM: field-embedded FM + DNN.

Counterpart of ``paddlerec_tpu/models/rank/deepfefm/model.py``, registered
as ``rank.deepfefm``: a symmetrised field-pair matrix transforms e_i before
the product with e_j; the interaction scalars sum into the FEFM logit, and
the interaction embeddings join the raw embeddings and the dense values in
the DNN branch.
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
    MLP, flax_dense, normal_param, triu_pairs,
)


class DeepFEFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (E+1 lanes), ``field_pair_w`` (S(S-1)/2, E, E), ``tower.fc_i``, ``head``,
    ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 fc_sizes: Sequence[int], dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s, e = num_fields, embedding_dim
        self.num_fields, self.embedding_dim = s, e
        self.embedding = SlotEmbedding(
            vocab_size, e + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = first-order weight
        n_pairs = s * (s - 1) // 2
        self.field_pair_w = normal_param((n_pairs, e, e), 1.0 / math.sqrt(e),
                                         device, generator)
        self.tower = MLP(s * e + n_pairs * e + dense_dim, fc_sizes,
                         device=device, generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)
        emb = fused[..., :e]  # (B, S, E)
        first = fused[..., e].sum(dim=1)
        b = emb.shape[0]
        iu, ju = triu_pairs(self.num_fields, 1, emb.device)
        ei, ej = emb[:, iu, :], emb[:, ju, :]  # (B, P, E)
        w_sym = self.field_pair_w + self.field_pair_w.transpose(-1, -2)
        ei_t = torch.einsum("bpe,pef->bpf", ei.to(w_sym.dtype), w_sym)
        inter = ei_t * ej  # (B, P, E) interaction embeddings
        fefm_logit = inter.sum(dim=(1, 2))
        dnn_in = torch.cat([emb.reshape(b, -1).to(inter.dtype),
                            inter.reshape(b, -1), dense], dim=-1)
        deep = self.head(self.tower(dnn_in))[:, 0]
        return first + fefm_logit + deep + self.bias


@register_model("rank.deepfefm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [1024, 1024, 1024]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DeepFEFMNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.fc_sizes, self.dense_dim, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
