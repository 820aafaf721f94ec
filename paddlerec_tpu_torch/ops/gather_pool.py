"""K1: fused gather + weighted sum-pool, ``out[n] = Σ_l table[ids[n,l]]·mask[n,l]``,
and K1b, its gradient with respect to the table.

K1 replaces the TPU kernel ``gather_pool`` / ``_gather_pool_kernel`` of
``paddlerec_tpu/ops/pallas_embedding.py`` (lines 37-106; oracle
``gather_pool_reference`` at 109-112).  On the card it is the main path's
embedding lookup: DeepFM reads its 26 one-id slots through it (N = B·26,
L = 1, D = 16 on the packed table's view), and pooled multi-hot slots use
L > 1 with the mask as weights.

K1b is the weighted scatter-add ``dtable[r] = Σ_{ids[n,l]=r} g[n]·mask[n,l]``.
The JAX package has no kernel for it (its ``gather_pool`` is forward only;
the lookup's gradient is XLA's scatter-add in ``_packed_lookup_bwd`` of
``paddlerec_tpu/ops/packed_embedding.py``, lines 94-120); here it is the
backward of the ``autograd.Function`` that runs K1 on the card.

Both kernels (``csrc/gather_pool.cu``, ``csrc/gather_pool_bwd.cu``) are
memory-bound; each source says how its design follows from that.  K1 has
been redesigned for Hopper since its first port; its source says how.

``gather_pool`` takes the plain version only for tensors on the CPU, where
autograd derives the gradient.  For a CUDA tensor it launches K1, and K1b in
the backward pass, or raises; ``gather_pool.launches`` and
``gather_pool_bwd.launches`` count the launches (``launches_by_dim`` of each
counts the same launches by row width D, ``gather_pool.launches_by_shape`` by
(rows, D, table dtype, N, L) and ``gather_pool_bwd.launches_by_shape`` by
(rows, D, dtable dtype, N)).

Both are twice differentiable on the card, as the plain version is on the
CPU: the meta-gradients of maml and metaheac differentiate through an inner
gradient step, so the outer gradient runs through the backward of K1b.  K1b
is linear in ``g``; its own backward is a K1 gather of the incoming
table-shaped gradient at the same ids with the same mask, in a mode where an
id K1b dropped reads zero (``"drop"``, or ``"fill_drop"`` after the wrap of
``"fill"``), so that it gets no gradient in either order.  Every launch of
either order is counted.

Ids out of range, ``mode="clip"`` (the default, what ``SlotEmbedding``
reads with): the forward clips them to ``[0, R-1]``; the backward drops them
(they add nothing to ``dtable``), negative ids included.  ``mode="fill"`` is
``jnp.take``'s default mode, which flax's ``nn.Embed`` (``ops/embedding.py``
``Embed``) looks rows up with: a negative id is wrapped once (``id + R``), an
id still outside ``[0, R)`` reads a row of NaN and gives the table no
gradient.  Both modes hold on the CPU and on the card alike, each a flag of
the same launch.  The two modes of the second order, ``mode="drop"`` (no
wrap) and ``mode="fill_drop"`` (a negative id wrapped once), read a row of
zeros for an id outside ``[0, R)``, which then gives no gradient either.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional

import torch

from paddlerec_tpu_torch.ops.build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: Dict[str, ctypes.CDLL] = {}

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "gather_pool": {
        "pr_gather_pool": [
            _PTR, _INT, _I64, _I64, _PTR, _PTR, _I64, _I64, _INT, _PTR, _INT, _PTR],
        "pr_empty_launch": [_PTR],
    },
    "gather_pool_bwd": {
        "pr_gather_pool_bwd": [
            _PTR, _INT, _PTR, _PTR, _I64, _I64, _I64, _I64, _INT, _PTR, _INT, _PTR,
            _PTR],
    },
}


def _out_dtype(table: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if out_dtype == torch.float32 and table.dtype == torch.bfloat16:
        return out_dtype
    raise TypeError(
        f"out_dtype {out_dtype} from a {table.dtype} table: the output is in "
        f"the table dtype, or float32 from a bfloat16 table"
    )


# the ``mode`` argument of pr_gather_pool; K1b's flag is the wrap bit
_MODE_CODE = {"clip": 0, "fill": 1, "drop": 2, "fill_drop": 3}
# the K1 mode that is the adjoint of K1b in a mode
_ADJOINT = {"clip": "drop", "fill": "fill_drop", "drop": "drop", "fill_drop": "fill_drop"}


def _mode_code(mode: str) -> int:
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be one of {sorted(_MODE_CODE)}, not {mode!r}")
    return _MODE_CODE[mode]


def gather_pool_plain(table: torch.Tensor, ids: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      mode: str = "clip") -> torch.Tensor:
    """Plain PyTorch version: ``index_select`` (ids clipped to [0, R-1];
    with ``mode="fill"`` or ``"fill_drop"`` negative ids wrapped once first,
    and the rows of ids still outside [0, R) replaced by NaN, or with
    ``"drop"`` and ``"fill_drop"`` by zeros), multiply by the mask, sum over
    L in float32, cast to the output dtype.  Where a gradient is recorded,
    rows read through a clipped id are detached, so an id outside [0, R)
    gives the table no gradient."""
    code = _mode_code(mode)
    out_dtype = _out_dtype(table, out_dtype)
    n, pool = ids.shape
    raw = ids.reshape(-1).long()
    if code & 1:
        raw = torch.where(raw < 0, raw + table.shape[0], raw)
    idx = raw.clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, idx)
    inside = (raw == idx)[:, None]
    if torch.is_grad_enabled() and table.requires_grad:
        rows = torch.where(inside, rows, rows.detach())
    if code:
        rows = rows.masked_fill(~inside, 0.0 if code & 2 else float("nan"))
    rows = rows.reshape(n, pool, -1).float()
    if mask is not None:
        rows = rows * mask.float()[..., None]
    return rows.sum(dim=1).to(out_dtype)


def gather_pool_bwd_plain(g: torch.Tensor, ids: torch.Tensor,
                          mask: Optional[torch.Tensor], rows: int,
                          dtype: Optional[torch.dtype] = None,
                          mode: str = "clip") -> torch.Tensor:
    """Plain PyTorch version of K1b: g (N, D), ids (N, L), mask (N, L) or
    None → dtable (rows, D) in ``dtype`` (default: g's).  Zeros plus one
    ``index_add_`` of ``g[n]·mask[n,l]``, accumulated in float32 and cast
    once; for a bfloat16 ``dtype`` each contribution is rounded to bfloat16
    first, as the JAX package casts the incoming gradient to the table dtype
    before its scatter-add.  Ids outside [0, rows) are dropped; with
    ``mode="fill"`` (or ``"fill_drop"``) negative ids are wrapped once
    first, as the forward of that mode reads them."""
    fill = _mode_code(mode) & 1
    dtype = g.dtype if dtype is None else dtype
    n, pool = ids.shape
    contrib = g.float()[:, None, :].expand(n, pool, g.shape[1])
    if mask is not None:
        contrib = contrib * mask.float()[..., None]
    if dtype == torch.bfloat16:
        contrib = contrib.to(torch.bfloat16).float()
    idx = ids.reshape(-1).long()
    if fill:
        idx = torch.where(idx < 0, idx + rows, idx)
    # dropped ids land in one extra row, cut off below (no host sync)
    idx = torch.where((idx >= 0) & (idx < rows), idx, rows)
    acc = torch.zeros((rows + 1, g.shape[1]), dtype=torch.float32, device=g.device)
    acc.index_add_(0, idx, contrib.reshape(n * pool, -1))
    return acc[:rows].to(dtype)


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _LIBS:
        lib = load_library(stem)
        for name, argtypes in _ARGTYPES[stem].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.pr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pr_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return _LIBS[stem]


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.pr_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def _check_ids_mask(ids: torch.Tensor, mask: Optional[torch.Tensor],
                    device: torch.device):
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise TypeError("ids must be an int32 (N, L) tensor")
    if ids.device != device:
        raise ValueError(f"ids on {ids.device}, table on {device}")
    if mask is not None:
        if mask.shape != ids.shape or mask.device != device:
            raise ValueError(
                f"mask {tuple(mask.shape)} on {mask.device} does not match "
                f"ids {tuple(ids.shape)} on {device}"
            )
        mask = mask.detach().to(torch.float32).contiguous()
    return ids.contiguous(), mask


def _gather_pool_cuda(table: torch.Tensor, ids: torch.Tensor,
                      mask: Optional[torch.Tensor],
                      out_dtype: torch.dtype, mode: str) -> torch.Tensor:
    """Launch K1.  ``ids`` and ``mask`` are already checked."""
    n, pool = ids.shape
    rows, dim = table.shape
    out = torch.empty((n, dim), dtype=out_dtype, device=table.device)
    if n == 0 or dim == 0:
        return out
    if pool == 0:
        return out.zero_()
    if rows == 0:
        raise ValueError("cannot gather from an empty table")
    lib = _lib("gather_pool")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.pr_gather_pool(
            table.data_ptr(), _DTYPE_CODE[table.dtype], rows, dim,
            ids.data_ptr(), None if mask is None else mask.data_ptr(),
            n, pool, _MODE_CODE[mode], out.data_ptr(), _DTYPE_CODE[out_dtype], stream,
        )
    _check_launch(lib, rc, "gather_pool")
    gather_pool.launches += 1
    gather_pool.launches_by_dim[dim] += 1
    gather_pool.launches_by_shape[(rows, dim, str(table.dtype)[6:], n, pool)] += 1
    return out


def empty_launch(device: torch.device) -> None:
    """Launch the empty kernel of ``csrc/gather_pool.cu`` on the current
    stream of a CUDA ``device``: the cost of a launch alone, which
    ``chip_smoke.py`` times as the floor under every kernel's time.  No
    count: it is no kernel of any path."""
    lib = _lib("gather_pool")
    with torch.cuda.device(device):
        rc = lib.pr_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    _check_launch(lib, rc, "empty")


def _gather_pool_bwd_cuda(g: torch.Tensor, ids: torch.Tensor,
                          mask: Optional[torch.Tensor], rows: int,
                          dtype: torch.dtype, mode: str) -> torch.Tensor:
    """Launch K1b.  ``g``, ``ids`` and ``mask`` are already checked."""
    n, pool = ids.shape
    dim = g.shape[1]
    dtable = torch.empty((rows, dim), dtype=dtype, device=g.device)
    if rows == 0 or dim == 0:
        return dtable
    if n == 0 or pool == 0:
        return dtable.zero_()
    g = g.contiguous()
    # a bfloat16 dtable accumulates in a float32 scratch, rounded once
    scratch = None
    if dtype == torch.bfloat16:
        scratch = torch.empty((rows, dim), dtype=torch.float32, device=g.device)
    lib = _lib("gather_pool_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.pr_gather_pool_bwd(
            g.data_ptr(), _DTYPE_CODE[g.dtype], ids.data_ptr(),
            None if mask is None else mask.data_ptr(), n, pool, dim, rows,
            _MODE_CODE[mode] & 1, dtable.data_ptr(), _DTYPE_CODE[dtype],
            None if scratch is None else scratch.data_ptr(), stream,
        )
    _check_launch(lib, rc, "gather_pool_bwd")
    gather_pool_bwd.launches += 1
    gather_pool_bwd.launches_by_dim[dim] += 1
    gather_pool_bwd.launches_by_shape[(rows, dim, str(dtype)[6:], n)] += 1
    return dtable


class _GatherPoolCuda(torch.autograd.Function):
    """K1 forward, K1b backward.  Only the table gets a gradient: ids are
    integers, and ``gather_pool`` refuses a mask that would need one.  The
    backward is itself differentiable (``_GatherPoolBwdCuda``)."""

    @staticmethod
    def forward(ctx, table, ids, mask, out_dtype, mode):
        ctx.save_for_backward(ids, mask)
        ctx.rows, ctx.table_dtype, ctx.mode = table.shape[0], table.dtype, mode
        return _gather_pool_cuda(table, ids, mask, out_dtype, mode)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        dtable = _GatherPoolBwdCuda.apply(g, ids, mask, ctx.rows, ctx.table_dtype,
                                          ctx.mode)
        return dtable, None, None, None, None


class _GatherPoolBwdCuda(torch.autograd.Function):
    """K1b as a function of ``g``, in which it is linear: its backward is
    K1 gathering the incoming (rows, D) gradient at the same ids with the
    same mask, in the mode (``_ADJOINT``) where the ids K1b drops read zero.
    That gather is a ``_GatherPoolCuda`` in turn, so every order stays on
    the two kernels."""

    @staticmethod
    def forward(ctx, g, ids, mask, rows, dtype, mode):
        ctx.save_for_backward(ids, mask)
        ctx.g_dtype, ctx.mode = g.dtype, mode
        return _gather_pool_bwd_cuda(g, ids, mask, rows, dtype, mode)

    @staticmethod
    def backward(ctx, dtable):
        ids, mask = ctx.saved_tensors
        dg = _GatherPoolCuda.apply(dtable.contiguous(), ids, mask, ctx.g_dtype,
                                   _ADJOINT[ctx.mode])
        return dg, None, None, None, None, None


def gather_pool_bwd(g: torch.Tensor, ids: torch.Tensor,
                    mask: Optional[torch.Tensor], rows: int,
                    dtype: Optional[torch.dtype] = None,
                    mode: str = "clip") -> torch.Tensor:
    """K1b: g (N, D) f32/bf16; ids (N, L) int32; mask (N, L) or None →
    dtable (rows, D) in ``dtype`` (default: g's; a bf16 g only into a bf16
    dtable), accumulated in float32; ``mode`` as the forward's.
    CPU tensors take ``gather_pool_bwd_plain``; CUDA tensors launch the
    kernel or raise.  Differentiable in ``g`` on both."""
    _mode_code(mode)
    dtype = g.dtype if dtype is None else dtype
    if g.device.type == "cpu":
        return gather_pool_bwd_plain(g, ids, mask, rows, dtype, mode)
    if g.device.type != "cuda":
        raise ValueError(f"gather_pool_bwd runs on cpu or cuda, not {g.device}")
    if g.dim() != 2:
        raise ValueError("g must be an (N, D) tensor")
    if g.dtype not in _DTYPE_CODE or dtype not in _DTYPE_CODE:
        raise TypeError(f"g {g.dtype} / dtable {dtype}: float32 or bfloat16 only")
    if g.dtype == torch.bfloat16 and dtype == torch.float32:
        # the lookup of a float32 table is float32, and so is its gradient
        raise TypeError("a bfloat16 g into a float32 dtable is not built")
    ids, mask = _check_ids_mask(ids, mask, g.device)
    if ids.shape[0] != g.shape[0]:
        raise ValueError(f"g has {g.shape[0]} rows, ids {ids.shape[0]}")
    return _GatherPoolBwdCuda.apply(g, ids, mask, rows, dtype, mode)


def gather_pool(table: torch.Tensor, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None,
                mode: str = "clip") -> torch.Tensor:
    """table (R, D) f32/bf16; ids (N, L) int32; mask (N, L) or None (weight
    1) → (N, D), summed in float32, in the table dtype or (``out_dtype``)
    float32 from a bfloat16 table.  Ids out of range as ``mode`` says (see
    the module docstring).  CPU tensors take ``gather_pool_plain``; CUDA
    tensors launch K1, and K1b when a gradient flows back to the table, to
    any order."""
    _mode_code(mode)
    if table.device.type == "cpu":
        return gather_pool_plain(table, ids, mask, out_dtype, mode)
    if table.device.type != "cuda":
        raise ValueError(f"gather_pool runs on cpu or cuda, not {table.device}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (R, D) tensor")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype {table.dtype} is not float32 or bfloat16")
    out_dtype = _out_dtype(table, out_dtype)
    if mask is not None and torch.is_grad_enabled() and mask.requires_grad:
        raise NotImplementedError(
            "gather_pool on CUDA gives no gradient for the mask: detach it, "
            "or multiply by it outside the lookup"
        )
    ids, mask = _check_ids_mask(ids, mask, table.device)
    return _GatherPoolCuda.apply(table, ids, mask, out_dtype, mode)


gather_pool.launches = 0
gather_pool_bwd.launches = 0
# the same launches by row width D, counted at the same two places
gather_pool.launches_by_dim = collections.Counter()
gather_pool_bwd.launches_by_dim = collections.Counter()
# K1's launches by (rows, D, table dtype as "float32"/"bfloat16", N, L), and
# K1b's by (rows, D, dtable dtype, N)
gather_pool.launches_by_shape = collections.Counter()
gather_pool_bwd.launches_by_shape = collections.Counter()
