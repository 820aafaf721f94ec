"""FAT-DeepFFM: field-attentive deep field-aware FM.

Counterpart of ``paddlerec_tpu/models/rank/fat_deepffm/model.py``, registered
as ``rank.fat_deepffm``: CENet (squeeze-excitation style) attention over all
F² field-aware embeddings before the interaction, the attended embeddings
summed into the first-order term and their pairwise products flattened into
the deep branch.

The squeeze is the maximum over the E lanes.  JAX splits the gradient of a
maximum evenly among ties, and ties are the rule here: a dense value of 0
makes all lanes of that field's vectors 0.  ``torch.amax`` splits evenly too
(``torch.max(dim)`` would give the whole gradient to one index).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import (
    MLP, flax_dense, normal_param, triu_pairs,
)


class FATDeepFFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (vocab, F·E, unpacked), ``dense_field_emb`` (D, F, E), ``ce_1``, ``ce_2``,
    ``tower.fc_i``, ``head``, ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 dense_dim: int, reduction: int = 2,
                 fc_sizes: Sequence[int] = (1024, 512, 256),
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s, e, d = num_fields, embedding_dim, dense_dim
        f = s + d
        self.shape = (s, f, e)
        self.embedding = SlotEmbedding(
            vocab_size, f * e, packed=False, device=device,
            generator=generator, **(table_kwargs or {}),
        )
        self.dense_field_emb = normal_param((d, f, e), 1e-2, device, generator)
        hidden = max(f * f // reduction, 1)
        self.ce_1 = flax_dense(f * f, hidden, device=device, generator=generator)
        self.ce_2 = flax_dense(hidden, f * f, device=device, generator=generator)
        self.tower = MLP(f * (f - 1) // 2 * e, fc_sizes, device=device,
                         generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        s, f, e = self.shape
        emb = self.embedding(sparse_ids)  # (B, S, F*E)
        b = emb.shape[0]
        v_dense = dense[..., None, None] * self.dense_field_emb[None]
        v = torch.cat([emb.reshape(b, s, f, e).to(v_dense.dtype), v_dense],
                      dim=1)  # (B, F, F, E)
        z = v.amax(dim=-1).reshape(b, f * f)  # squeeze: max over E
        a = torch.relu(self.ce_2(torch.relu(self.ce_1(z))))  # (B, F²)
        v_att = v * a.reshape(b, f, f, 1)
        first = v_att.sum(dim=(1, 2, 3))
        iu, ju = triu_pairs(f, 1, v.device)
        inter = v_att[:, iu, ju, :] * v_att[:, ju, iu, :]  # (B, P, E)
        deep = self.head(self.tower(inter.reshape(b, -1)))[:, 0]
        return first + deep + self.bias


@register_model("rank.fat_deepffm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.reduction = int(config.hyper("reduction", 2))
        self.fc_sizes = list(config.hyper("fc_sizes", [1024, 512, 256]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FATDeepFFMNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.dense_dim, self.reduction, self.fc_sizes,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
