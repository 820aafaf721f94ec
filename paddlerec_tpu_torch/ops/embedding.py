"""Embedding tables: ``SlotEmbedding``, the shared table over all sparse
slots with pooled lookup, and ``Embed``, the counterpart of flax's
``nn.Embed`` that the behaviour-sequence models look their tables up with.

The local packed path of ``paddlerec_tpu/ops/embedding.py`` ``SlotEmbedding``:
one ``(R, 128)`` packed table (parameter ``embedding``) shared by every
slot, ids hashed ``ids % vocab``, one id per slot or a pooled multi-hot
slot.  Every lookup is one launch of kernel K1 on the table's logical view,
and its gradient one launch of K1b.

**Row-sharded path** (``_use_distributed``, the JAX module's decision):
``packed`` and the mesh of the parallel context (``parallel/context.py``,
which the trainer sets) has ``mp > 1``, or ``distributed=True`` and a mesh
is set; below ``sharding.MIN_ROWS_TO_SHARD`` packed rows the table stays
local, with the reference's one-time warning where ``distributed=True``
asked for it.  The decision is taken when the module is built.  The
parameter ``embedding`` is then this rank's ``(rows_local, 128)`` shard of
the engine's padded table (``parallel/embedding.py`` ``ShardedEmbedding``),
filled with the values the one-device table has at those rows (the same
generator, drawn through the whole table), and a lookup is the engine's
exchange: K1 on the shard, K1b into it in the backward.  Multi-hot ids go
flat through the engine and are pooled after it.  In external-update mode
the lookup is ``lookup_external`` with a zero ``(B·S·L, 128)`` float32 delta,
the JAX package's ``embedding_delta`` cut to the batch, whose gradient
``take_delta_grad`` hands out (128 lanes a position).  Each lookup's
dropped-id count, an int32 ``(1, 1)`` tensor on the device, waits for the
model (``take_overflow``), where the JAX module ``sow``s it.

**External (sparse) update mode** (``external_update=True``, the
reference's ``_external_lookup``).  The table takes no gradient: it is read
detached, every position's vector leaves the lookup in float32 (also from a
bfloat16 table, as the reference's ``take(table) + delta`` promotes), and
the gradient of those ``(N, w)`` vectors is captured on a leaf tensor
(``take_delta_grad``) for the row-wise optimizer step of
``ops/sparse_update.py``.  The JAX package routes that gradient through a
zero ``embedding_delta`` parameter of ``delta_capacity`` rows; the port has
no such parameter and allocates nothing of that size, but keeps the
capacity check, since users' configs name ``sparse_update_capacity``.
Without a recorded gradient (``torch.no_grad()``, evaluation, serving) the
lookup is the same one K1 launch as the plain path.

**Unpacked table** (``packed=False``, what ffm and fat_deepffm use for rows
wider than 128 lanes): ``embedding`` is a plain ``(vocab, E)`` parameter
drawn normal(``init_stddev``), and the lookup is ``take(table, ids,
mode="clip")``: one K1 launch on the table itself, K1b in the backward.  As
in the JAX package this branch ignores ``external_update`` (only the packed
branch reads it there): the table keeps its gradient and the dense optimizer
steps it, also in a sparse run.
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from paddlerec_tpu_torch.ops.gather_pool import gather_pool
from paddlerec_tpu_torch.ops.packed_embedding import (
    fill_normal, init_packed_table, logical_view, packed_lookup, sub_width,
)
from paddlerec_tpu_torch.parallel import context, sharding

logger = logging.getLogger(__name__)

# (vocab, dim) pairs whose explicit distributed=True was downgraded by the
# MIN_ROWS_TO_SHARD floor: warn once per geometry
_DOWNGRADE_WARNED: set = set()


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
      packed: the packed 128-lane layout (default), or a plain (vocab, E)
        table for rows wider than 128 lanes; see the module docstring.
      external_update: sparse-update mode, see the module docstring;
        ``delta_capacity`` bounds the lookup positions per batch and must be
        set explicitly (``CTRModelDef.sparse_embed_kwargs`` does).
      distributed: None = auto (row-shard over the context mesh's mp axis
        when it is above 1), True = shard whenever a mesh is set, False =
        never; see the module docstring.
    """

    def __init__(self, vocab_size: int, embedding_dim: int,
                 combiner: str = "sum", hash_ids: bool = True,
                 dtype: torch.dtype = torch.float32, init_stddev: float = 1e-2,
                 device=None, generator: Optional[torch.Generator] = None,
                 external_update: bool = False, delta_capacity: int = 0,
                 packed: bool = True, distributed: Optional[bool] = None):
        super().__init__()
        if combiner not in ("sum", "mean"):
            raise ValueError(f"combiner must be 'sum' or 'mean', not {combiner!r}")
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.combiner = combiner
        self.hash_ids = hash_ids
        self.packed = bool(packed)
        self.external_update = bool(external_update) and self.packed
        self.delta_capacity = int(delta_capacity)
        self.distributed = distributed
        self.engine = self._engine(dtype, device)
        if self.engine is not None:
            eng = self.engine
            shard = torch.empty((eng.rows_local, 128), dtype=dtype, device=device)
            # the one-device table's rows of this shard (padding rows zero)
            fill_normal(shard, init_stddev, generator,
                        rows=-(-vocab_size // eng.pack),
                        first=eng.mesh.mp_index * eng.rows_local)
            self.embedding = nn.Parameter(shard, requires_grad=not self.external_update)
        elif not self.packed:
            self.embedding = nn.Parameter(fill_normal(
                torch.empty((vocab_size, embedding_dim), dtype=dtype,
                            device=device), init_stddev, generator))
        else:
            # in external mode the optimizer steps rows, not the parameter:
            # it takes no gradient, so none of the table's size is ever
            # allocated
            self.embedding = nn.Parameter(init_packed_table(
                vocab_size, embedding_dim, stddev=init_stddev, dtype=dtype,
                generator=generator, device=device,
            ), requires_grad=not self.external_update)
        self._delta_tap: Optional[torch.Tensor] = None
        self._overflow: Optional[torch.Tensor] = None

    def _use_distributed(self) -> bool:
        if self.distributed is not None:
            want = self.distributed and context.get_mesh() is not None
        else:
            want = self.packed and context.model_parallel_size() > 1
        if not want:
            return False
        # tables too small for param_spec to row-shard keep the local packed
        # lookup: the engine pads rows to an mp multiple, and below the
        # threshold the replicated table is both correct and faster
        rows = -(-self.vocab_size // (128 // sub_width(self.embedding_dim)))
        if rows < sharding.MIN_ROWS_TO_SHARD:
            if self.distributed is True:
                key = (self.vocab_size, self.embedding_dim)
                if key not in _DOWNGRADE_WARNED:
                    _DOWNGRADE_WARNED.add(key)
                    logger.warning(
                        "SlotEmbedding(distributed=True, vocab=%d, dim=%d):"
                        " %d packed rows < MIN_ROWS_TO_SHARD=%d — falling"
                        " back to the local replicated table (different"
                        " param geometry than the sharded engine).",
                        self.vocab_size, self.embedding_dim, rows,
                        sharding.MIN_ROWS_TO_SHARD,
                    )
            return False
        return True

    def _engine(self, dtype, device):
        """The context mesh's engine for this table, or None (local path)."""
        if not self._use_distributed():
            return None
        from paddlerec_tpu_torch.parallel.embedding import get_engine

        return get_engine(context.get_mesh(), self.vocab_size, self.embedding_dim,
                          dtype=dtype, device=torch.device(device or "cpu"))

    def take_overflow(self) -> Optional[torch.Tensor]:
        """This rank's dropped-id count of the last row-sharded lookup, an
        int32 (1, 1) tensor on the device (None on the local path, or when
        taken already)."""
        out, self._overflow = self._overflow, None
        return out

    def _engine_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The row-sharded lookup: hashed int32 ids (B, ...) → ids.shape +
        (E,), flat through the engine."""
        eng = self.engine
        flat = ids.reshape(ids.shape[0], -1)
        if self.external_update:
            n = flat.numel()
            self._check_delta_capacity(n, self.delta_capacity)
            # the JAX package's embedding_delta, cut to this batch's positions
            delta = torch.zeros((n, 128), dtype=torch.float32, device=ids.device,
                                requires_grad=torch.is_grad_enabled())
            vecs, self._overflow = eng.lookup_external(self.embedding, delta, flat)
            if delta.requires_grad:
                self._delta_tap = delta
        else:
            vecs, self._overflow = eng.lookup_with_overflow(self.embedding, flat)
        return vecs.reshape(ids.shape + (self.embedding_dim,))

    def _pool(self, vecs: torch.Tensor, ids: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, S, L, E) vectors of multi-hot ids → pooled (B, S, E)."""
        if mask is not None:
            vecs = vecs * mask[..., None]
        pooled = vecs.sum(dim=2)
        if self.combiner == "mean":
            denom = (mask.sum(dim=2, keepdim=True) if mask is not None
                     else torch.full(pooled.shape[:-1] + (1,),
                                     float(ids.shape[2]), dtype=pooled.dtype,
                                     device=ids.device))
            pooled = pooled / torch.clamp(denom, min=1.0)
        return pooled

    @staticmethod
    def _check_delta_capacity(n: int, cap: int) -> None:
        if cap <= 0:
            raise ValueError(
                "external_update requires an explicit delta_capacity "
                "(params are initialized from a tiny example batch, so "
                "sizing from the first batch cannot work; "
                "ModelDef.sparse_embed_kwargs computes the right value)"
            )
        if n > cap:
            raise ValueError(
                f"batch has {n} lookup positions > delta_capacity {cap}; "
                "raise hyper_parameters.sparse_update_capacity"
            )

    def _external_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Sparse-update path: detached table read + gradient capture.
        ids: hashed int32, any shape → ids.shape + (E,) float32."""
        self._check_delta_capacity(ids.numel(), self.delta_capacity)
        view = logical_view(self.embedding.detach(), self.embedding_dim)
        vecs = gather_pool(view, ids.reshape(-1, 1), None, torch.float32)
        if torch.is_grad_enabled():
            self._delta_tap = vecs.requires_grad_()
        return vecs[:, :self.embedding_dim].reshape(
            ids.shape + (self.embedding_dim,))

    def take_delta_grad(self) -> Optional[torch.Tensor]:
        """The (N, w) float32 gradient of the last recorded external
        lookup's vectors, in the flat order of its ids (on the row-sharded
        path the (N, 128) gradient of its delta); ``None`` if no backward
        pass reached it.  The capture is dropped."""
        tap, self._delta_tap = self._delta_tap, None
        return None if tap is None else tap.grad

    def forward(self, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.hash_ids:
            ids = ids % self.vocab_size
        ids = ids.to(torch.int32)
        e = self.embedding_dim
        if self.external_update and not self.hash_ids:
            raise ValueError(
                "external_update requires hash_ids=True: the optimizer-"
                "side row mapping mirrors the ids % vocab hash"
            )
        if self.engine is not None or self.external_update:
            vecs = (self._engine_lookup(ids) if self.engine is not None
                    else self._external_lookup(ids))
            if ids.dim() == 2:
                return vecs
            # one gradient row per position: pool outside the lookup
            return self._pool(vecs, ids, mask)
        view = (logical_view(self.embedding, e) if self.packed
                else self.embedding)
        if ids.dim() == 2:  # (B, S) → (B, S, E)
            if self.packed:
                return packed_lookup(self.embedding, ids, e)
            return gather_pool(view, ids.reshape(-1, 1)).reshape(ids.shape + (e,))
        b, s, pool = ids.shape
        flat_mask, out_dtype = None, None
        if mask is not None:
            flat_mask = mask.reshape(b * s, pool)
            out_dtype = torch.promote_types(self.embedding.dtype, mask.dtype)
        pooled = gather_pool(
            view, ids.reshape(b * s, pool), flat_mask, out_dtype,
        )[:, :e].reshape(b, s, e)
        if self.combiner == "mean":
            if mask is not None:
                denom = mask.sum(dim=2, keepdim=True)
            else:
                denom = torch.full((b, s, 1), float(pool), dtype=pooled.dtype,
                                   device=ids.device)
            pooled = pooled / torch.clamp(denom, min=1.0)
        return pooled


class Embed(nn.Module):
    """flax ``nn.Embed``: a plain ``(num_embeddings, features)`` float32
    parameter ``embedding``, drawn as flax's default does (a normal of std
    ``1/sqrt(features)``, not truncated), or with another ``embedding_init``
    of the JAX models: zeros (``zeros=True``, ``initializers.zeros``), a
    normal of std ``stddev`` (``initializers.normal(stddev)``), or with
    ``truncated=True`` as well ``initializers.truncated_normal(stddev)``:
    ``stddev`` times a standard normal cut at ±2, or a uniform on ``[0,
    uniform)`` (``initializers.uniform(scale=uniform)``), or with a pair
    ``uniform=(low, high)`` on ``[low, high)`` (``jax.random.uniform(key,
    shape, dtype, low, high)``).

    ``emb(ids)`` looks up ids of any shape → ``ids.shape + (features,)``,
    one K1 launch, its gradient one K1b launch.  ``emb(a, b, ...)`` looks up
    several id tensors of one table in the same single launch and returns one
    result per tensor: a model that reads a table twice in a forward (history
    and target) so pays one K1 and one K1b launch for it, not two, and
    zero-fills its dense gradient once.

    Ids out of range behave as ``jnp.take`` in the JAX module: a negative id
    is wrapped once, an id still outside ``[0, num_embeddings)`` reads a row
    of NaN and gives no gradient (K1's ``mode="fill"``).  Ids that are not
    int32 are first clamped to ``[-num_embeddings - 1, num_embeddings]``, so
    that the cast to the kernel's int32 keeps an out-of-range id out of
    range.

    ``pool(ids, mask)`` is flax's ``(emb(ids) * mask[..., None]).sum(-2)``,
    the bag of words of a row of ids: one K1 launch with the mask as weights,
    in the same ``fill`` mode, so that an id out of range gives NaN · 0 = NaN
    on both sides.

    ``attend(x)`` is ``x @ embedding.T``: a plain product (cuBLAS on the card).
    """

    def __init__(self, num_embeddings: int, features: int, zeros: bool = False,
                 device=None, generator: Optional[torch.Generator] = None,
                 stddev: Optional[float] = None, truncated: bool = False,
                 uniform: Optional[Union[float, Tuple[float, float]]] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        table = torch.empty((num_embeddings, features), device=device)
        std = 1.0 / math.sqrt(features) if stddev is None else stddev
        if zeros:
            table.zero_()
        elif uniform is not None:
            low, high = uniform if isinstance(uniform, tuple) else (0.0, uniform)
            table.uniform_(low, high, generator=generator)
        elif truncated:
            nn.init.trunc_normal_(table, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            fill_normal(table, std, generator)
        self.embedding = nn.Parameter(table)

    def _kernel_ids(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.dtype != torch.int32:
            v = self.num_embeddings
            ids = ids.clamp(-v - 1, v).to(torch.int32)
        return ids

    def forward(self, *ids: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        flat = [i.reshape(-1) for i in ids]
        flat = self._kernel_ids(flat[0] if len(flat) == 1 else torch.cat(flat))
        vecs = gather_pool(self.embedding, flat[:, None], mode="fill")
        if len(ids) == 1:
            return vecs.reshape(ids[0].shape + (self.features,))
        parts = vecs.split([i.numel() for i in ids])
        return tuple(p.reshape(i.shape + (self.features,))
                     for p, i in zip(parts, ids))

    def pool(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids and mask (..., L) → the masked sum of their rows (...,
        features)."""
        pool = ids.shape[-1]
        out = gather_pool(self.embedding, self._kernel_ids(ids.reshape(-1, pool)),
                          mask.reshape(-1, pool).to(self.embedding.dtype), mode="fill")
        return out.reshape(ids.shape[:-1] + (self.features,))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embedding.T


def take_rows(x: torch.Tensor, ids: torch.Tensor, wrap: bool = False,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows of a 2-D tensor (a parameter or an activation) at ``ids`` of any
    shape → ``ids.shape + (x.shape[1],)``: one K1 launch in ``clip`` mode,
    its gradient into ``x`` one K1b launch.  The rows come out in ``x``'s
    dtype or (``out_dtype``) float32 from a bfloat16 ``x``, exactly: the
    online trainer reads a table's touched rows off the card so.

    ``wrap=False`` is ``jnp.take(x, ids, axis=0, mode="clip")``: every id
    clipped into [0, R), in the forward and in the gradient alike.
    ``wrap=True`` is numpy-style indexing ``x[ids]`` in JAX: a negative id
    wrapped once (``id + R``), then an id still outside [0, R) reads the
    clipped row and gives no gradient (K1's clip mode)."""
    rows = x.shape[0]
    flat = ids.reshape(-1)
    if wrap:
        flat = torch.where(flat < 0, flat + rows, flat).clamp(-1, rows)
    else:
        flat = flat.clamp(0, rows - 1)
    out = gather_pool(x, flat.to(torch.int32)[:, None], out_dtype=out_dtype, mode="clip")
    return out.reshape(ids.shape + (x.shape[1],))
