"""Sparse row-wise optimizer for packed embedding tables.

Counterpart of ``paddlerec_tpu/ops/sparse_update.py``.  With a dense optimizer
every step reads and writes the FULL table and its moments; here a step
touches only the physical rows a batch used, so the only state of the
table's size is the table and its row state.

What is the same as in the JAX package:

* **Row granularity is the physical 128-lane row.**  ``RowwiseAdagradState``
  keeps one float32 scalar per physical row, shared by its ``pack`` logical
  rows, and a step adds the mean of the squared gradient over all 128 lanes
  (pad lanes and untouched neighbours included).  ``RowwiseAdamState`` keeps
  ``m``, ``v`` ``(R, 128)`` float32 and a per-row step count for the bias
  correction.
* All update math runs in float32 and is cast to the table dtype once
  (``_cast_to_table``): round to nearest, or ``stochastic_round_bf16`` for
  a bfloat16 table when a generator is given.  Lanes whose gradient is zero
  come back bit-identical either way.
* In the Adam rules a row whose summed gradient is exactly zero takes no
  step (``_live_rows``); the Adagrad rules have no such guard.
* ``host_dedup`` / ``dedup_rows`` return the reference's arrays bit for bit,
  sentinel padding included, so batches compare across the packages.

What differs:

* The JAX package receives the per-position gradients on a zero
  ``embedding_delta`` parameter of 128 lanes per position.  Here
  ``delta_grad`` is the gradient of the looked-up vectors themselves,
  ``(N, w)`` float32 with ``w = 128 // pack``, and ``sub`` ``(N,)`` says
  which lane group of its physical row each position read (``id % pack``);
  with ``w == 128`` no ``sub`` is needed and the array is the reference's.
* The sum per unique row (``_grad_sum``) is kernel K1b
  (``ops/gather_pool.py``) on a compact ``(U·pack, w)`` buffer.
* The sentinel padding of ``uniq`` exists for XLA's static shapes.  The
  compact rules work on the ``num_uniq`` real rows only (the sentinels sort
  last); the result is the same.  A caller that knows the count on the host
  passes it, else it is read from the device, which waits for it.
* Tables and states are updated in place under ``torch.no_grad()``; the
  functions return the same objects.  The index and elementwise steps are
  plain tensor operations here as they are plain XLA operations there.
* ``rng`` is a ``torch.Generator`` on the table's device, not a key.

**On a mesh** (``apply_sparse_adagrad_sharded`` /
``apply_sparse_adam_sharded``, the JAX package's ``*_sharded`` rules under
``shard_map``, and its compact rules over a dp-sharded batch).  The table and its row state are this rank's ``(rows_local,
·)`` shard of a table row-sharded over the mesh's mp axis
(``parallel/embedding.py``); ``uniq`` holds the unique physical rows of the
global batch (every dp row's, ``ModelDef.global_dedup_arrays``) and ``slot``
this rank's positions in it.  Each rank sums its positions per unique row
(one K1b launch into the global ``(U, 128)`` buffer) and the sums are added
over the dp group, so every rank of a shard's column holds the same bits
and its replicas stay equal.  The stochastic-rounding noise is drawn over
the whole ``(U, 128)`` from the step's generator, as at one device, and
each rank applies the rule to the rows it owns (``_owned_rows``: a
contiguous range of the ascending ``uniq``) and writes only those.  A table
that is whole on every rank (dp > 1 at mp = 1, or too small to shard) takes
the same rules with every row its own (``sharded=False``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from paddlerec_tpu_torch.ops.gather_pool import gather_pool_bwd

SENTINEL = np.iinfo(np.int32).max  # padded uniq slots


def dedup_rows(phys: torch.Tensor,
               num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape unique for physical row ids, on the ids' device.

    phys: (N,) int32 row ids in [0, num_rows).
    Returns (uniq (N,), slot (N,) int32): ``uniq`` holds each distinct row
    once, ascending (remaining slots = ``num_rows``, the drop sentinel) and
    ``slot[i]`` is the index of ``phys[i]`` within ``uniq``."""
    n = phys.shape[0]
    s, order = torch.sort(phys, stable=True)
    is_new = torch.ones(n, dtype=torch.bool, device=phys.device)
    is_new[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(is_new, 0) - 1  # slot of each sorted element
    uniq = torch.full((n,), num_rows, dtype=phys.dtype, device=phys.device)
    uniq[pos] = s  # equal ids write equal values
    slot = torch.zeros(n, dtype=torch.int32, device=phys.device)
    slot[order] = pos.to(torch.int32)
    return uniq, slot


def host_dedup(ids, vocab: int, pack: int):
    """Host-side (numpy) dedup of a batch's physical rows — runs in the
    input pipeline, overlapped with device compute.  Returns
    (uniq (N,) int32 padded with SENTINEL, slot (N,) int32)."""
    phys = (np.asarray(ids).reshape(-1) % vocab) // pack
    uniq, slot = np.unique(phys, return_inverse=True)
    out = np.full(phys.size, SENTINEL, np.int32)
    out[: len(uniq)] = uniq
    return out, slot.reshape(-1).astype(np.int32)


class RowwiseAdamState(NamedTuple):
    m: torch.Tensor      # (R, 128) float32 first moment
    v: torch.Tensor      # (R, 128) float32 second moment
    count: torch.Tensor  # (R,) int32 per-row step count (lazy bias correction)


def rowwise_adam_init(table: torch.Tensor) -> RowwiseAdamState:
    # moments stay float32 even for bf16 tables
    return RowwiseAdamState(
        m=torch.zeros(table.shape, dtype=torch.float32, device=table.device),
        v=torch.zeros(table.shape, dtype=torch.float32, device=table.device),
        count=torch.zeros(table.shape[0], dtype=torch.int32, device=table.device),
    )


class RowwiseAdagradState(NamedTuple):
    """Scalar per-row accumulator."""

    acc: torch.Tensor  # (R,) float32 sum of per-row mean squared grads


def rowwise_adagrad_init(table: torch.Tensor) -> RowwiseAdagradState:
    return RowwiseAdagradState(
        acc=torch.zeros(table.shape[0], dtype=torch.float32, device=table.device)
    )


def stochastic_round_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """float32 → bfloat16 with stochastic rounding, given the noise:
    ``(bits + noise) & 0xFFFF0000`` with ``noise`` uniform in [0, 2^16),
    any integer dtype.  The arithmetic is int32; its two's-complement wrap
    equals the unsigned one.  The expected stored value is the float32
    value, and an exact bfloat16 value (zero low bits) comes back as it is."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + noise.to(torch.int32)) & -65536
    return rounded.view(torch.float32).to(torch.bfloat16)


def _cast_to_table(t_n: torch.Tensor, table: torch.Tensor,
                   rng: Union[torch.Generator, torch.Tensor, None]) -> torch.Tensor:
    """f32 update results → table dtype; stochastic rounding for bf16 when
    a generator (or the noise it drew, a tensor of ``t_n``'s shape) is
    given (hyper sparse_update_stochastic_round)."""
    if table.dtype == torch.bfloat16 and rng is not None:
        noise = rng if isinstance(rng, torch.Tensor) else torch.randint(
            0, 1 << 16, t_n.shape, generator=rng, device=t_n.device, dtype=torch.int32)
        return stochastic_round_bf16(t_n, noise)
    return t_n.to(table.dtype)


def _lane_ids(rows: torch.Tensor, sub: Optional[torch.Tensor],
              width: int) -> torch.Tensor:
    """(N, 1) int32 rows of the ``(·, width)`` view: ``rows·pack + sub``."""
    pack = 128 // width
    if pack == 1:
        return rows.to(torch.int32).reshape(-1, 1)
    if sub is None:
        raise ValueError(
            f"delta_grad is {width} lanes wide: sub (id % {pack}) is needed "
            f"to place it in its 128-lane row"
        )
    return (rows.to(torch.int32) * pack + sub.to(torch.int32)).reshape(-1, 1)


def _check_delta_grad(delta_grad: torch.Tensor, n: int) -> torch.Tensor:
    width = delta_grad.shape[-1]
    if delta_grad.dim() != 2 or width > 128 or 128 % width:
        raise ValueError(f"delta_grad {tuple(delta_grad.shape)}: want (N, w), w | 128")
    return delta_grad[:n].to(torch.float32)


def _grad_sum(delta_grad: torch.Tensor, sub: Optional[torch.Tensor],
              slot: torch.Tensor, num_uniq: int) -> torch.Tensor:
    """Per-unique-row f32 gradient sum ``(num_uniq, 128)``: the only place
    the per-position gradients are merged.  One K1b launch on the card."""
    g = _check_delta_grad(delta_grad, slot.shape[0])
    width = g.shape[1]
    ids = _lane_ids(slot, sub, width)
    return gather_pool_bwd(g, ids, None, num_uniq * (128 // width)).view(num_uniq, 128)


def _live_rows(g_rows: torch.Tensor) -> torch.Tensor:
    """(U, 1) bool: rows whose summed grad is not exactly zero.  The Adam
    rules step only these: a zero-grad Adam step still moves the row
    (momentum decay + bias correction), which is wrong for rows that were
    only *touched*.  The JAX package routes the others to a dropped index;
    here they write their old values back, which is the same."""
    return torch.any(g_rows != 0.0, dim=-1, keepdim=True)


def _real_uniq(uniq: torch.Tensor, num_uniq: Optional[int]) -> torch.Tensor:
    """The leading real rows of a SENTINEL-padded ``uniq``, as int64."""
    if num_uniq is None:
        num_uniq = int((uniq != SENTINEL).sum())  # waits for the device
    return uniq[:num_uniq].long()


def _adam_rows(table, state, rows, g, lr, b1, b2, eps, rng) -> None:
    """One Adam step on ``table[rows]`` from summed grads ``g``, written back
    at ``rows``.  Equal rows must carry equal ``g``."""
    t_old = table.index_select(0, rows)
    m_r = state.m.index_select(0, rows)
    v_r = state.v.index_select(0, rows)
    c_old = state.count.index_select(0, rows)
    m_n = b1 * m_r + (1.0 - b1) * g
    v_n = b2 * v_r + (1.0 - b2) * g * g
    c_r = c_old + 1
    c_f = c_r.to(torch.float32)[:, None]
    t_n = t_old.to(torch.float32) - lr * (
        m_n / (1.0 - torch.pow(b1, c_f))
    ) / (torch.sqrt(v_n / (1.0 - torch.pow(b2, c_f))) + eps)
    live = _live_rows(g)
    index = (rows,)
    table.index_put_(index, torch.where(live, _cast_to_table(t_n, table, rng), t_old))
    state.m.index_put_(index, torch.where(live, m_n, m_r))
    state.v.index_put_(index, torch.where(live, v_n, v_r))
    state.count.index_put_(index, torch.where(live[:, 0], c_r, c_old))


def _adagrad_rows(table, state, rows, g, lr, eps, rng) -> None:
    a_r = state.acc.index_select(0, rows) + (g * g).mean(-1)
    t_n = (table.index_select(0, rows).to(torch.float32)
           - lr * g * torch.rsqrt(a_r + eps)[:, None])
    table.index_put_((rows,), _cast_to_table(t_n, table, rng))
    state.acc.index_put_((rows,), a_r)


@torch.no_grad()
def rowwise_adam(table: torch.Tensor, state: RowwiseAdamState,
                 uniq: torch.Tensor, row_grads: torch.Tensor, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 ) -> Tuple[torch.Tensor, RowwiseAdamState]:
    """Adam on exactly the ``uniq`` rows; rows ``>= table.shape[0]`` (the
    padding of ``dedup_rows``) are dropped, which reads their count from the
    device.  Unlike the compact rules a zero gradient still steps its row.

    row_grads: (U, 128) summed gradients aligned with ``uniq``."""
    keep = uniq < table.shape[0]
    rows = uniq[keep].long()
    g = row_grads.to(torch.float32)[keep]
    m_n = b1 * state.m.index_select(0, rows) + (1.0 - b1) * g
    v_n = b2 * state.v.index_select(0, rows) + (1.0 - b2) * g * g
    c_r = state.count.index_select(0, rows) + 1
    c_f = c_r.to(torch.float32)[:, None]
    m_hat = m_n / (1.0 - torch.pow(b1, c_f))
    v_hat = v_n / (1.0 - torch.pow(b2, c_f))
    t_n = (table.index_select(0, rows).to(torch.float32)
           - lr * m_hat / (torch.sqrt(v_hat) + eps))
    table.index_copy_(0, rows, t_n.to(table.dtype))
    state.m.index_copy_(0, rows, m_n)
    state.v.index_copy_(0, rows, v_n)
    state.count.index_copy_(0, rows, c_r)
    return table, state


@torch.no_grad()
def apply_sparse_adagrad_compact(
        table: torch.Tensor, state: RowwiseAdagradState,
        delta_grad: torch.Tensor, uniq: torch.Tensor, slot: torch.Tensor,
        lr: float, eps: float = 1e-8, rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None, num_uniq: Optional[int] = None,
) -> Tuple[torch.Tensor, RowwiseAdagradState]:
    """Row-wise adagrad with HOST-deduped rows: the only O(R) memory is the
    table and its accumulator; the grad scratch is ``(num_uniq, 128)``."""
    rows = _real_uniq(uniq, num_uniq)
    g_uniq = _grad_sum(delta_grad, sub, slot, rows.shape[0])
    _adagrad_rows(table, state, rows, g_uniq, lr, eps, rng)
    return table, state


@torch.no_grad()
def apply_sparse_adam_compact(
        table: torch.Tensor, state: RowwiseAdamState,
        delta_grad: torch.Tensor, uniq: torch.Tensor, slot: torch.Tensor,
        lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
        rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None, num_uniq: Optional[int] = None,
) -> Tuple[torch.Tensor, RowwiseAdamState]:
    """Row-wise lazy Adam with HOST-deduped rows (see the adagrad variant).
    Rows whose summed grad is exactly zero take no step."""
    rows = _real_uniq(uniq, num_uniq)
    g_uniq = _grad_sum(delta_grad, sub, slot, rows.shape[0])
    _adam_rows(table, state, rows, g_uniq, lr, b1, b2, eps, rng)
    return table, state


def _owned_rows(rows: torch.Tensor, mp_index: int, rows_local: int):
    """The range ``[a, b)`` of the ascending global ``rows`` that shard
    ``mp_index`` owns (rows ``[lo, lo + rows_local)``), and those rows as
    local indices of the shard.  Reads the two bounds from the device."""
    lo = mp_index * rows_local
    edges = torch.tensor([lo, lo + rows_local], dtype=rows.dtype, device=rows.device)
    a, b = torch.searchsorted(rows, edges).tolist()
    return a, b, rows[a:b] - lo


def _sharded_setup(mesh, table, delta_grad, uniq, slot, rng, sub, num_uniq, sharded):
    """Shared preamble of the sharded rules: the global real rows, their
    f32 gradient sums over the whole mesh column (one K1b launch, then the
    dp sum), the rounding noise of the whole ``(U, 128)`` where the table
    is bfloat16, and the owned range (every row of a table that is not
    sharded)."""
    rows = _real_uniq(uniq, num_uniq)
    g_uniq = _grad_sum(delta_grad, sub, slot, rows.shape[0])
    if mesh.dp_group is not None:
        dist.all_reduce(g_uniq, group=mesh.dp_group)
    noise = None
    if table.dtype == torch.bfloat16 and rng is not None:
        noise = torch.randint(0, 1 << 16, g_uniq.shape, generator=rng,
                              device=g_uniq.device, dtype=torch.int32)
    a, b, local = _owned_rows(rows, mesh.mp_index if sharded else 0, table.shape[0])
    return g_uniq[a:b], None if noise is None else noise[a:b], local


@torch.no_grad()
def apply_sparse_adagrad_sharded(
        mesh, table: torch.Tensor, state: RowwiseAdagradState,
        delta_grad: torch.Tensor, uniq: torch.Tensor, slot: torch.Tensor,
        lr: float, eps: float = 1e-8, rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None, num_uniq: Optional[int] = None,
        sharded: bool = True,
) -> Tuple[torch.Tensor, RowwiseAdagradState]:
    """Row-wise adagrad on this rank's shard of a table row-sharded over
    ``mesh``'s mp axis (see the module docstring): ``uniq`` the global
    batch's unique rows (SENTINEL-padded, ascending), ``slot`` the slots
    of this rank's positions, ``delta_grad`` their gradients.  With
    ``sharded=False`` the table is whole on every rank (a dp mesh, or a
    table too small to shard) and every row is this rank's."""
    g, noise, local = _sharded_setup(mesh, table, delta_grad, uniq, slot, rng,
                                     sub, num_uniq, sharded)
    _adagrad_rows(table, state, local, g, lr, eps, noise)
    return table, state


@torch.no_grad()
def apply_sparse_adam_sharded(
        mesh, table: torch.Tensor, state: RowwiseAdamState,
        delta_grad: torch.Tensor, uniq: torch.Tensor, slot: torch.Tensor,
        lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
        rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None, num_uniq: Optional[int] = None,
        sharded: bool = True,
) -> Tuple[torch.Tensor, RowwiseAdamState]:
    """Row-wise lazy Adam on this rank's shard (see the adagrad variant);
    rows whose summed grad is exactly zero take no step."""
    g, noise, local = _sharded_setup(mesh, table, delta_grad, uniq, slot, rng,
                                     sub, num_uniq, sharded)
    _adam_rows(table, state, local, g, lr, b1, b2, eps, noise)
    return table, state


def _dense_grad_rows(table, delta_grad, phys, sub) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort-free scheme: scatter-add the per-position grads into a dense
    (R, 128) f32 scratch (one K1b launch), then read it back at the RAW
    position list.  Returns (phys as int64, (N, 128) summed grads)."""
    g = _check_delta_grad(delta_grad, phys.shape[0])
    width = g.shape[1]
    g_dense = gather_pool_bwd(
        g, _lane_ids(phys, sub, width), None, table.shape[0] * (128 // width)
    ).view(table.shape[0], 128)
    rows = phys.long()
    return rows, g_dense.index_select(0, rows)


@torch.no_grad()
def apply_sparse_adagrad(
        table: torch.Tensor, state: RowwiseAdagradState,
        delta_grad: torch.Tensor, phys: torch.Tensor, lr: float,
        eps: float = 1e-8, rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, RowwiseAdagradState]:
    """Sort-free row-wise adagrad for a batch that was not deduped on the
    host.  Needs an (R, 128) float32 scratch.  Duplicate positions read the
    same summed grad and write identical values, so the last writer wins
    exactly (``index_put_`` without ``accumulate``); with stochastic
    rounding each duplicate draws its own noise and one of them lands, as
    in the JAX package."""
    rows, g_r = _dense_grad_rows(table, delta_grad, phys, sub)
    _adagrad_rows(table, state, rows, g_r, lr, eps, rng)
    return table, state


@torch.no_grad()
def apply_sparse_update(
        table: torch.Tensor, state: RowwiseAdamState,
        delta_grad: torch.Tensor, phys: torch.Tensor, lr: float,
        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
        rng: Optional[torch.Generator] = None,
        sub: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, RowwiseAdamState]:
    """Per-position grads + physical row ids → row-wise Adam step, sort-free
    (see ``apply_sparse_adagrad``): each touched row advances exactly one
    Adam step, and positions whose summed grad is exactly zero take none.

    delta_grad: (C, w) grads of the looked-up vectors (positions beyond the
    batch's N are ignored).  phys: (N,) physical row per position, N <= C."""
    rows, g_r = _dense_grad_rows(table, delta_grad, phys, sub)
    _adam_rows(table, state, rows, g_r, lr, b1, b2, eps, rng)
    return table, state


def infer_pack(vocab: int, rows: int, mp: int = 1) -> int:
    """Recover the pack factor of a packed (rows, 128) table from its row
    count.  mp > 1 matches the sharded geometry, whose row count is padded
    up to an mp multiple."""
    for w in (8, 16, 32, 64, 128):
        pack = 128 // w
        base = (vocab + pack - 1) // pack
        if mp > 1:
            base = -(-base // mp) * mp
        if base == rows:
            return pack
    raise ValueError(
        f"no pack factor maps vocab {vocab} to {rows} rows (mp={mp})"
    )
