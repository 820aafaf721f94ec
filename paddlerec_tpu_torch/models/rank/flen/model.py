"""FLEN: field-leveraged embedding network.

Counterpart of ``paddlerec_tpu/models/rank/flen/model.py``, registered as
``rank.flen``: the fields are partitioned into groups; the field-wise
bi-interaction combines an MF part (products of group sums across groups,
one learned weight per pair) and an FM part (sum-square − square-sum within
each group), concatenated with a DNN branch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense


class FLENNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``pair_weight`` (pairs, 1, 1) of ones, ``fwbi_proj``, ``tower.fc_i``,
    ``head``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 field_groups: Sequence[int], fc_sizes: Sequence[int],
                 dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.field_groups = list(field_groups)
        e = embedding_dim
        self.embedding = SlotEmbedding(
            vocab_size, e, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        n_g = len(self.field_groups)
        self.pair_weight = nn.Parameter(
            torch.ones((n_g * (n_g - 1) // 2, 1, 1), device=device))
        self.fwbi_proj = flax_dense(2 * e, e, device=device, generator=generator)
        self.tower = MLP(num_fields * e + dense_dim, fc_sizes, device=device,
                         generator=generator)
        self.head = flax_dense(e + fc_sizes[-1], 1, device=device,
                               generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)
        sums, h_fm, start = [], 0, 0
        for size in self.field_groups:
            g = emb[:, start:start + size, :]
            start += size
            total = g.sum(dim=1)  # (B, E)
            sums.append(total)
            h_fm = h_fm + 0.5 * (torch.square(total) - torch.square(g).sum(dim=1))
        # MF across groups; the float32 weight widens a bfloat16 product
        h_mf, k = 0, 0
        for i in range(len(sums)):
            for j in range(i + 1, len(sums)):
                h_mf = h_mf + self.pair_weight[k, 0, 0] * (sums[i] * sums[j]).float()
                k += 1
        fwbi = torch.relu(self.fwbi_proj(torch.cat([h_mf, h_fm.float()], dim=-1)))
        dnn_in = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                           dim=-1)
        final = torch.cat([fwbi, self.tower(dnn_in)], dim=-1)
        return self.head(final)[:, 0]


@register_model("rank.flen")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        groups = config.hyper("field_groups")
        if not groups:
            # default: split Criteo's 26 fields into 3 pseudo-groups
            s = self.num_sparse
            groups = [s // 3, s // 3, s - 2 * (s // 3)]
        self.field_groups = list(groups)
        self.fc_sizes = list(config.hyper("fc_sizes", [64, 32]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FLENNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.field_groups, self.fc_sizes, self.dense_dim,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
