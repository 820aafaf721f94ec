"""The port's hand kernels as the benchmark counts them: their names in a
device trace and the least bytes each launch has to move.

K1 (``csrc/gather_pool.cu``) gathers one row a position: it reads every
touched row once, every id once, and writes every output row once.  K1b
(``csrc/gather_pool_bwd.cu``) sums per-position gradients into a buffer: it
writes the buffer once (zero-filled, then added into), reads every gradient
row once and every id once.  A bound is the larger of bytes over the HBM
rate and one add an element over the float32 rate (``peaks.py``): these
are the counts ``chip_smoke.py`` times the kernels against, frozen here.
"""

from __future__ import annotations

import torch

from recbench.peaks import F32_FLOPS, HBM_BYTES_PER_S

K1_NAMES = ("gather_one_kernel", "gather_pool_kernel")
K1B_NAMES = ("scatter_add_kernel", "sorted_scatter_kernel", "fill_zero_kernel",
             "zero_bf16_kernel", "round_rows_kernel")


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_NAMES)


def is_k1b(name: str) -> bool:
    return any(k in name for k in K1B_NAMES)


def k1_bound_s(touched_rows: int, row_bytes: int, ids: int, out_row_bytes: int,
               lanes: int) -> float:
    nbytes = touched_rows * row_bytes + ids * 4 + ids * out_row_bytes
    return max(nbytes / HBM_BYTES_PER_S, ids * lanes / F32_FLOPS)


def k1b_bound_s(buffer_bytes: int, ids: int, g_row_bytes: int, lanes: int) -> float:
    nbytes = buffer_bytes + ids * g_row_bytes + ids * 4
    return max(nbytes / HBM_BYTES_PER_S, ids * lanes / F32_FLOPS)


def batch_bounds(sparse, vocab: int, table_itemsize: int, width: int, pack: int):
    """(K1's, K1b's) bound for one batch's ids (a tensor): K1 gathers
    ``width``-lane rows of the table's view into float32 rows, one a
    position; K1b sums the positions' float32 gradients into the compact
    ``(unique physical rows · pack, width)`` buffer of the row rules."""
    ids = sparse.reshape(-1).long() % vocab
    n = ids.numel()
    k1 = k1_bound_s(int(torch.unique(ids).numel()), width * table_itemsize, n, width * 4, width)
    k1b = k1b_bound_s(int(torch.unique(ids // pack).numel()) * 128 * 4, n, width * 4, width)
    return k1, k1b
