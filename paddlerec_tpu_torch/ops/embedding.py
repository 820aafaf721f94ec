"""Shared embedding table over all sparse slots, with pooled lookup.

The local packed path of ``paddlerec_tpu/ops/embedding.py`` ``SlotEmbedding``:
one ``(R, 128)`` packed table (parameter ``embedding``) shared by every
slot, ids hashed ``ids % vocab``, one id per slot or a pooled multi-hot
slot.  Every lookup is one launch of kernel K1 on the table's logical view,
and its gradient one launch of K1b.  The row-sharded (all_to_all) and
sparse-update paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.ops.gather_pool import gather_pool
from paddlerec_tpu_torch.ops.packed_embedding import (
    init_packed_table, logical_view, packed_lookup,
)


class SlotEmbedding(nn.Module):
    """Input ids: (B, S) one id per slot, or (B, S, L) multi-hot with an
    optional (B, S, L) mask; output: (B, S, E) per-slot vectors.  The output
    dtype follows the JAX module: the table dtype, except that pooling with a
    mask promotes to the mask's dtype (a bfloat16 table and a float32 mask
    give the float32 sum, unrounded).

    Attributes:
      vocab_size: number of rows (sparse_feature_number).
      embedding_dim: vector width (sparse_feature_dim).
      combiner: 'sum' | 'mean' pooling over the L axis; 'mean' divides by
        max(mask.sum(L), 1), or by L without a mask.
      hash_ids: apply ``ids % vocab_size`` (floor modulo, as in JAX).
    """

    def __init__(self, vocab_size: int, embedding_dim: int,
                 combiner: str = "sum", hash_ids: bool = True,
                 dtype: torch.dtype = torch.float32, init_stddev: float = 1e-2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("sum", "mean"):
            raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.combiner = combiner
        self.hash_ids = hash_ids
        self.embedding = nn.Parameter(init_packed_table(
            vocab_size, embedding_dim, stddev=init_stddev, dtype=dtype,
            generator=generator, device=device,
        ))

    def forward(self, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.hash_ids:
            ids = ids % self.vocab_size
        ids = ids.to(torch.int32)
        e = self.embedding_dim
        if ids.dim() == 2:  # (B, S) → (B, S, E)
            return packed_lookup(self.embedding, ids, e)
        b, s, pool = ids.shape
        flat_mask, out_dtype = None, None
        if mask is not None:
            flat_mask = mask.reshape(b * s, pool)
            out_dtype = torch.promote_types(self.embedding.dtype, mask.dtype)
        pooled = gather_pool(
            logical_view(self.embedding, e), ids.reshape(b * s, pool),
            flat_mask, out_dtype,
        )[:, :e].reshape(b, s, e)
        if self.combiner == "mean":
            if mask is not None:
                denom = mask.sum(dim=2, keepdim=True)
            else:
                denom = torch.full((b, s, 1), float(pool), dtype=pooled.dtype,
                                   device=ids.device)
            pooled = pooled / torch.clamp(denom, min=1.0)
        return pooled
