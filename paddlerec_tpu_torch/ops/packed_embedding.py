"""Packed embedding table: the layout the JAX package stores, kept bit for bit.

A table of logical width E is a ``(R, 128)`` parameter with ``pack = 128/w``
logical rows per physical row, where ``w = sub_width(E)``: id ``i`` lives in
physical row ``i // pack``, lanes ``(i % pack)·w`` onward
(``paddlerec_tpu/ops/packed_embedding.py``).  Because the parameter is
contiguous, ``table.view(R·pack, w)`` is free and makes logical id ``i``
row ``i`` of the view, so the lookup is one gather of ``w``-wide rows through
kernel K1 and no one-hot select, and its gradient one ``w``-wide scatter-add
through K1b; the view's gradient is, byte for byte, the ``(R, 128)``
parameter's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from paddlerec_tpu_torch.ops.gather_pool import gather_pool


_INIT_BLOCK_BYTES = 1 << 29  # float32 noise drawn at a time (2^20 packed rows)


def sub_width(embedding_dim: int) -> int:
    """Smallest divisor of 128 that is >= embedding_dim (8,16,32,64,128)."""
    for w in (8, 16, 32, 64, 128):
        if embedding_dim <= w:
            return w
    raise ValueError(f"embedding_dim {embedding_dim} > 128; use width 128 directly")


def packed_shape(vocab_size: int, embedding_dim: int) -> Tuple[int, int]:
    w = sub_width(embedding_dim)
    pack = 128 // w
    rows = (vocab_size + pack - 1) // pack
    return rows, 128


def logical_view(table: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """The packed ``(R, 128)`` table as ``(R·pack, w)`` logical rows (a view)."""
    return table.view(-1, sub_width(embedding_dim))


def packed_lookup(table: torch.Tensor, ids: torch.Tensor,
                  embedding_dim: int) -> torch.Tensor:
    """Look up ids in a packed (R, 128) table → (..., embedding_dim).

    Equal to the JAX ``packed_lookup``, and its gradient to the JAX
    function's, for ids in ``[0, R·pack)``.  Ids outside clip to the view's
    first or last row in the forward and are dropped in the backward: the
    table gets no gradient from them.  The JAX function also drops ids
    ``>= R·pack`` in its backward; a negative id it reads from physical row
    0 but adds, wrapped, to the end of the table's gradient.  Pad lanes
    (``embedding_dim <= lane < w``) get exactly zero gradient."""
    flat = ids.reshape(-1, 1).to(torch.int32)
    vecs = gather_pool(logical_view(table, embedding_dim), flat)
    return vecs[:, :embedding_dim].reshape(ids.shape + (embedding_dim,))


def fill_normal(table: torch.Tensor, stddev: float,
                generator: Optional[torch.Generator] = None,
                rows: Optional[int] = None, first: int = 0) -> torch.Tensor:
    """normal(0, stddev) into the 2-D ``table`` in place, drawn in float32
    blocks of rows on the table's device (``generator`` must live there) and
    cast block by block, so a table of gigabytes never has a float32 copy.

    With ``rows``: ``table`` holds rows ``[first, first + len(table))`` of a
    table of ``rows`` rows drawn so (rows past ``rows`` are zero).  The
    generator draws every block of the whole table, in order, and the rows
    outside are dropped: a mesh rank's shard gets the values the one-device
    table has there, and the generator ends where that table's leaves it."""
    total, width = table.shape
    rows = total if rows is None else rows
    if rows != total or first:
        table.zero_()
    step = max(_INIT_BLOCK_BYTES // (4 * max(width, 1)), 1)
    for start in range(0, rows, step):
        n = min(step, rows - start)
        block = torch.randn((n, width), generator=generator, device=table.device)
        lo, hi = max(start, first), min(start + n, first + total)
        if lo < hi:
            table[lo - first:hi - first] = block[lo - start:hi - start].mul_(stddev)
    return table


def init_packed_table(vocab_size: int, embedding_dim: int,
                      stddev: float = 1e-2, dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Normal·stddev packed table (pad lanes are initialized too — they are
    never read).  ``generator`` must live on ``device``."""
    shape = packed_shape(vocab_size, embedding_dim)
    return fill_normal(torch.empty(shape, dtype=dtype, device=device),
                       stddev, generator)


def unpack_table(table: np.ndarray, vocab_size: int, embedding_dim: int) -> np.ndarray:
    """Host-side: packed (R,128) → logical (V, E) (export / tests)."""
    w = sub_width(embedding_dim)
    pack = 128 // w
    flat = np.asarray(table).reshape(table.shape[0] * pack, w)
    return flat[:vocab_size, :embedding_dim]


def pack_table(dense: np.ndarray) -> np.ndarray:
    """Host-side inverse of unpack_table: logical (V, E) → packed (R, 128)."""
    v, e = dense.shape
    w = sub_width(e)
    pack = 128 // w
    rows = (v + pack - 1) // pack
    out = np.zeros((rows * pack, w), dense.dtype)
    out[:v, :e] = dense
    return out.reshape(rows, 128)
