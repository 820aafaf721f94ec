"""Field-aware FM: every feature holds one vector per field.

Counterpart of ``paddlerec_tpu/models/rank/ffm/model.py``, registered as
``rank.ffm``: feature i holds F field-specific vectors v_{i,f} over the
F = S + D sparse and dense fields; the interaction term is
Σ_{i<j} <v_{i,field(j)}, v_{j,field(i)}>.

The per-id factor block is F·E wide (39·9 = 351 on Criteo), wider than one
128-lane row, so ``embedding`` is the plain (unpacked) ``(vocab, F·E)``
table: one K1 launch reads its rows whole.  The first-order weights are a
second, packed table of width 1 (``first_weight``): a second K1 launch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import normal_param, triu_mask


class FFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (vocab, F·E), ``dense_field_emb`` (D, F, E), ``first_weight.embedding``
    (packed (R, 128)), ``dense_w``, ``bias``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 dense_dim: int,
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
        self.first_weight = SlotEmbedding(
            vocab_size, 1, init_stddev=1e-4, device=device,
            generator=generator, **(table_kwargs or {}),
        )
        self.dense_w = normal_param((d,), 1e-4, device, generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        s, f, e = self.shape
        emb = self.embedding(sparse_ids)  # (B, S, F*E)
        v_sparse = emb.reshape(emb.shape[0], s, f, e)
        v_dense = dense[..., None, None] * self.dense_field_emb[None]  # (B, D, F, E)
        v = torch.cat([v_sparse.to(v_dense.dtype), v_dense], dim=1)  # (B, F, F, E)
        first = self.first_weight(sparse_ids)[..., 0].sum(dim=1)
        first = first + dense @ self.dense_w
        # Σ_{i<j} <v[i, j], v[j, i]>: the full F×F dot matrix, upper triangle
        dots = torch.einsum("bije,bjie->bij", v, v)
        second = (dots * triu_mask(f, dots.device)).sum(dim=(1, 2))
        return first + second + self.bias


@register_model("rank.ffm")
class ModelDef(CTRModelDef):
    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FFMNet(self.vocab_size, self.embedding_dim, self.num_sparse,
                      self.dense_dim, table_kwargs=self.table_kwargs(),
                      device=device, generator=generator)
