"""The all_to_all embedding engine: a row-sharded packed table, looked up by
exchanging ids and rows between the ranks of a mesh row.

The port of ``paddlerec_tpu/parallel/embedding.py``.  The packed ``(R, 128)``
table (``ops/packed_embedding.py``) is padded to a multiple of mp rows and
split into mp shards of ``rows_local`` rows; rank ``(i, j)`` of the mesh
(``parallel/mesh.py``) holds shard ``j``.  The ranks of a mesh row look up
the same ids (their dp row's batch), and each routes only its own slice of
the flat ids, as each JAX device does:

  1. dedup its slice (a stable sort, so that the ids kept and the ids
     dropped on overflow are JAX's), then sort the unique rows by owning
     shard into ``(mp, C)`` buckets of static capacity
     ``C = bucket_capacity(n / mp, mp, capacity_factor)``; ids past a full
     bucket are dropped and counted (``overflow``);
  2. one ``all_to_all_single`` of the ``(mp, C)`` row ids over the mp group;
  3. the owner reads its rows with kernel K1 (``ops/gather_pool.py``) on its
     shard, ``N = mp·C``, ``L = 1``, ``mode="drop"``: the ``-1`` holes of
     the buckets read zero;
  4. one ``all_to_all_single`` of the ``(mp·C, 128)`` rows back, fanned out
     to every position of the slice (zeros where an id was dropped), and
     the slices of the row gathered, so that every rank of the row holds
     the whole row's vectors.

The backward is one ``autograd.Function`` with the forward's routing: each
rank takes its slice of the row's gradient, sums it per unique row and into
its bucket slot, sends the buckets back with one ``all_to_all_single``, and
the owner scatters them onto its shard with kernel K1b (``mode="drop"``, the
adjoint of the forward's K1), summed over the dp group.  Neither step of the
shard is a library call: K1 and K1b are the port's hand kernels on the card
and their plain twins on the CPU.

Without a process group (one process, world size 1) the exchanges are the
identity; with one, every exchange is a collective, also at world size 1.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddlerec_tpu_torch.core.device import resolve_device
from paddlerec_tpu_torch.ops.gather_pool import gather_pool, gather_pool_bwd
from paddlerec_tpu_torch.ops.packed_embedding import fill_normal, sub_width
from paddlerec_tpu_torch.parallel.mesh import Mesh
from paddlerec_tpu_torch.parallel.sharding import local_rows


def bucket_capacity(num_local_ids: int, mp: int, capacity_factor: float) -> int:
    """Static per-shard bucket size, rounded up to a multiple of 8."""
    c = int(np.ceil(num_local_ids / mp * capacity_factor))
    return max(8, -(-c // 8) * 8)


def _dedup_ids(phys: torch.Tensor, sentinel: int):
    """Sort-based unique of static size.  Returns (uniq, rank, order):
    ``uniq`` (N,) holds each distinct id once (tail padded with
    ``sentinel``); ``rank[i]`` is the index into ``uniq`` of the i-th
    *sorted* id; ``order`` sorts the original ids (stably)."""
    n = phys.shape[0]
    order = torch.argsort(phys, stable=True)
    sorted_phys = phys[order]
    first = torch.ones(n, dtype=torch.bool, device=phys.device)
    first[1:] = sorted_phys[1:] != sorted_phys[:-1]
    rank = torch.cumsum(first, 0) - 1
    # the scatter of .at[].set(mode="drop"): one slot more, cut off
    uniq = torch.full((n + 1,), sentinel, dtype=phys.dtype, device=phys.device)
    uniq[torch.where(first, rank, n)] = sorted_phys
    return uniq[:n], rank, order


def _route_ids(phys: torch.Tensor, mp: int, rows_local: int, capacity: int):
    """Sort physical rows by owning shard and pack them into static buckets.

    ``phys`` (N,) holds global physical rows; entries ``>= mp·rows_local``
    are padding and are never routed.  Returns (send, slot, overflow):
    ``send`` (mp, capacity) int32 local rows on the owner, -1 a hole;
    ``slot`` (N,) the flat bucket slot of each id (-1 if dropped or
    invalid); ``overflow`` the count of valid ids dropped."""
    n = phys.shape[0]
    dev = phys.device
    valid = phys < mp * rows_local
    shard_of = torch.where(valid, phys // rows_local, mp)  # invalid sorts last
    order = torch.argsort(shard_of, stable=True)
    sorted_shard = shard_of[order]
    sorted_local = (phys % rows_local)[order]
    sorted_valid = sorted_shard < mp
    idx = torch.arange(n, device=dev)
    # jnp.searchsorted's side "left" is torch's right=False
    group_start = torch.searchsorted(sorted_shard, torch.arange(mp, device=dev))
    pos_in_group = idx - group_start[sorted_shard.clamp(max=mp - 1)]
    ok = sorted_valid & (pos_in_group < capacity)
    slot_sorted = torch.where(ok, sorted_shard * capacity + pos_in_group, -1)
    send = torch.full((mp * capacity + 1,), -1, dtype=torch.int32, device=dev)
    send[torch.where(ok, slot_sorted, mp * capacity)] = sorted_local.to(torch.int32)
    overflow = (sorted_valid & ~ok).sum().to(torch.int32)
    inv = torch.empty_like(order)
    inv[order] = idx
    return send[:mp * capacity].view(mp, capacity), slot_sorted[inv], overflow


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block k of ``x`` (split along dim 0) to rank k of ``group``; the
    identity without a group (the one peer is this process)."""
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The slices of a mesh row, in mp order, on every rank of the row."""
    if mesh.mp_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.mp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.mp_group)
    return torch.cat(parts, dim=0)


class _Exchange(torch.autograd.Function):
    """(table shard, the row's physical ids) → (the row's (n, 128) rows,
    this rank's overflow count (1, 1), the row's fetched flags).  Only the
    shard gets a gradient."""

    @staticmethod
    def forward(ctx, table_local, phys_row, eng, capacity):
        mesh, mp = eng.mesh, eng.mp
        n = phys_row.shape[0] // mp
        phys = phys_row[mesh.mp_index * n:(mesh.mp_index + 1) * n]
        uniq, rank, order = _dedup_ids(phys, eng.rows)
        send, slot, overflow = _route_ids(uniq, mp, eng.rows_local, capacity)
        recv = _all_to_all(send, mesh.mp_group).reshape(-1, 1)
        answered = gather_pool(table_local, recv, mode="drop")  # K1 on the shard
        back = _all_to_all(answered, mesh.mp_group)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=order.device)
        pslot = slot[rank[inv]]  # bucket slot of each position, -1 if dropped
        fetched = pslot >= 0
        vecs = torch.where(fetched[:, None], back[pslot.clamp(min=0)],
                           torch.zeros((), dtype=back.dtype, device=back.device))
        rows = _all_gather(vecs, mesh)
        fetched_row = _all_gather(fetched.to(torch.int32), mesh).bool()
        ctx.save_for_backward(recv, order, rank, slot)
        ctx.eng, ctx.capacity, ctx.n, ctx.dtype = eng, capacity, n, table_local.dtype
        overflow = overflow.view(1, 1)
        ctx.mark_non_differentiable(overflow, fetched_row)
        return rows, overflow, fetched_row

    @staticmethod
    def backward(ctx, g_rows, _g_overflow, _g_fetched):
        recv, order, rank, slot = ctx.saved_tensors
        eng, cap, n = ctx.eng, ctx.capacity, ctx.n
        mesh, mp = eng.mesh, eng.mp
        g = g_rows[mesh.mp_index * n:(mesh.mp_index + 1) * n].to(ctx.dtype)
        # sum per unique row, then into its bucket slot (dropped: one more
        # slot, cut off); each distinct row crosses the exchange once
        gu = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device)
        gu.index_add_(0, rank, g[order])
        gbuf = torch.zeros((mp * cap + 1, g.shape[1]), dtype=g.dtype, device=g.device)
        gbuf.index_add_(0, torch.where(slot >= 0, slot, mp * cap), gu)
        arrived = _all_to_all(gbuf[:mp * cap], mesh.mp_group)
        # K1b on the shard, the adjoint of the forward's K1 (holes dropped)
        dtable = gather_pool_bwd(arrived, recv, None, eng.rows_local, ctx.dtype,
                                 mode="drop")
        if mesh.dp_group is not None:
            # the rows of a column's ranks are disjoint within a row; sum them
            dist.all_reduce(dtable, group=mesh.dp_group)
        return dtable, None, None, None


@functools.lru_cache(maxsize=64)
def get_engine(mesh: Mesh, vocab_size: int, embedding_dim: int,
               capacity_factor: float = 1.5, dtype=torch.float32,
               device=None) -> "ShardedEmbedding":
    """One engine per (mesh, table) signature."""
    return ShardedEmbedding(mesh, vocab_size, embedding_dim,
                            capacity_factor=capacity_factor, dtype=dtype,
                            device=device)


class ShardedEmbedding:
    """The engine bound to a mesh.

    Usage (on every rank of the mesh):
        eng = ShardedEmbedding(mesh, vocab_size, embedding_dim)
        table = eng.init(generator)      # this rank's (rows_local, 128) shard
        vecs = eng.lookup(table, ids)    # ids (B, S): this dp row's batch

    ``lookup`` returns the dp row's ``(B, S, embedding_dim)`` vectors on every
    rank of the row and is differentiable in the shard; the backward expects
    the same gradient on every rank of the row (the dense layers above are
    replicated over mp), takes this rank's slice of it, and leaves each
    rank the gradient of its shard summed over the whole mesh.  Given the
    JAX engine's global ids, the dp row's batch is its rows
    ``[i·B/dp, (i+1)·B/dp)``, and each rank routes the slice a JAX device
    routes where ``B·S`` divides by dp·mp."""

    def __init__(self, mesh: Mesh, vocab_size: int, embedding_dim: int,
                 capacity_factor: float = 1.5, init_stddev: float = 1e-2,
                 dtype=torch.float32, device=None):
        self.mesh = mesh
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.capacity_factor = capacity_factor
        self.init_stddev = init_stddev
        self.dtype = dtype
        self.device = resolve_device(device)
        self.w = sub_width(embedding_dim)
        self.pack = 128 // self.w
        self.mp, self.dp = mesh.mp, mesh.dp
        rows = -(-vocab_size // self.pack)
        # pad rows so that each shard has as many
        self.rows = -(-rows // self.mp) * self.mp
        self.rows_local = self.rows // self.mp

    # -- params ---------------------------------------------------------------
    def init(self, generator=None) -> torch.Tensor:
        """This rank's shard of a normal(0, init_stddev) table (``generator``
        on the engine's device, seeded alike on every rank)."""
        table = torch.empty((self.rows, 128), dtype=self.dtype, device=self.device)
        fill_normal(table, self.init_stddev, generator)
        return local_rows(table, self.mesh.mp_index, self.mp).clone()

    def capacity(self, num_ids: int) -> int:
        """The bucket capacity for a dp row of ``num_ids`` ids."""
        return bucket_capacity(-(-num_ids // self.mp), self.mp, self.capacity_factor)

    # -- lookup ---------------------------------------------------------------
    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, S) int → (B, S, embedding_dim)."""
        return self.lookup_with_overflow(table, ids)[0]

    def lookup_with_overflow(self, table, ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """``lookup`` and this rank's overflow count, an int32 (1, 1) tensor
        on the device (no gradient)."""
        rows, overflow, _fetched, sub = self._exchange(table, ids)
        return self._select(rows, sub, ids.shape), overflow

    def lookup_external(self, table, delta, ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sparse_update (delta-tap) lookup: the shard is read with no
        gradient, the per-position ``delta`` (≥ B·S, 128) is added to the
        fetched rows before the sub-lane select, and a dropped position
        gives neither a vector nor a delta gradient.  Returns (vecs,
        overflow) as ``lookup_with_overflow``."""
        rows, overflow, fetched, sub = self._exchange(table.detach(), ids)
        n = sub.shape[0]
        gate = fetched[:n].to(delta.dtype)[:, None]
        rows = (rows[:n].to(delta.dtype) + delta[:n]) * gate
        return self._select(rows, sub, ids.shape), overflow

    def _exchange(self, table, ids):
        if table.shape != (self.rows_local, 128):
            raise ValueError(f"the shard is {tuple(table.shape)}, the engine's "
                             f"({self.rows_local}, 128)")
        flat = ids.reshape(-1).to(device=table.device, dtype=torch.int64) % self.vocab_size
        n = flat.shape[0]
        phys = flat // self.pack
        n_pad = -(-n // self.mp) * self.mp
        if n_pad != n:  # padding routes as invalid
            phys = torch.cat([phys, phys.new_full((n_pad - n,), self.rows)])
        rows, overflow, fetched = _Exchange.apply(table, phys, self, self.capacity(n))
        return rows, overflow, fetched, flat % self.pack

    def _select(self, rows, sub, shape) -> torch.Tensor:
        n = sub.shape[0]
        lanes = rows[:n].reshape(n, self.pack, self.w)
        picked = torch.gather(lanes, 1, sub.view(n, 1, 1).expand(n, 1, self.w))
        return picked[:, 0, :self.embedding_dim].reshape(
            tuple(shape) + (self.embedding_dim,))
