"""Compact host→device wire format for input batches.

Why: the feed path is bytes-bound.  A Criteo batch row is 164 B in the
naive layout (26 ids i32 + 13 dense f32 + label f32 + mask f32); over a
constrained host↔device link that caps the examples/s any reader can
deliver.  The wire encoding shrinks a row to ~105 B losslessly for ids
(u24 when vocab < 2^24) and near-losslessly for dense (f16; Criteo dense
features are min-max normalized to [0,1] where f16 resolution is ~5e-4):

    sparse (B,S) int   → u8 (B,S,3)   [vocab < 2^24; else i32]
    dense  (B,D) f32   → f16 (B,D)
    label  (B,)  f32   → u8  (B,)     [only when labels are integral]
    mask   (B,)  f32   → u8  (B,)

``encode_batch`` runs on the host (vectorized numpy); ``decode_batch`` runs
on the device at the head of the train step.  The encoding is carried by
the array DTYPES themselves (u8×3 trailing dim = packed ids, f16 dense,
u8 label/mask), so batches stay plain dicts with no side metadata.  Enable
with ``runner.wire_format: compact``.

``WireEncoder``, ``encode_batch`` and ``wire_bytes`` are copies of
``paddlerec_tpu/data/wire.py`` (numpy only); ``decode_batch`` is its
counterpart on torch tensors.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch


class WireEncoder:
    """Stateful encoder that PINS the sparse representation.

    Choosing u24-vs-i32 per batch from actual id values means a stream
    whose batches straddle the 2^24 (or int31) boundary flips the sparse
    dtype/shape batch-to-batch, which splits superbatch staging at every
    flip.  The encoder decides on the first batch and only ever
    ESCALATES (u24 → i32 → passthrough) when a later batch cannot be
    represented, warning once per escalation: at most two changes per
    stream instead of unbounded flip-flopping, and never a silent
    truncation ((id mod 2^24) mod vocab is NOT id mod vocab for raw,
    un-hashed ids).
    """

    _ORDER = ("u24", "i32", "none")

    def __init__(self, vocab: int):
        self.vocab = int(vocab)
        self._mode: str = ""  # decided on first batch

    def _fits(self, sparse: np.ndarray, mode: str) -> bool:
        if mode == "u24":
            # values >= 2^24 do NOT break u24: they are reduced mod
            # vocab first (consumers hash ids by vocab anyway, and
            # vocab <= 2^24 here), keeping the output SHAPE stable for
            # the whole stream — a mid-stream shape flip would crash
            # np.stack inside superbatch staging.  Only NEGATIVE ids
            # (sentinel semantics that mod would corrupt) escalate.
            return (
                sparse.ndim == 2
                and 0 < self.vocab <= (1 << 24)
                and sparse.min(initial=0) >= 0
            )
        if mode == "i32":
            return bool(abs(sparse).max(initial=0) < 2**31)
        return True

    def _pick(self, sparse: np.ndarray, start: str = "u24") -> str:
        for mode in self._ORDER[self._ORDER.index(start):]:
            if self._fits(sparse, mode):
                return mode
        return "none"

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        sparse = batch.get("sparse")
        if sparse is not None and np.issubdtype(sparse.dtype, np.integer):
            if not self._mode:
                self._mode = self._pick(sparse)
            elif not self._fits(sparse, self._mode):
                new_mode = self._pick(sparse, self._mode)
                logging.getLogger("paddlerec_tpu_torch").warning(
                    "wire encoder: batch ids exceed the pinned %r sparse "
                    "representation; escalating to %r for the rest of the "
                    "stream",
                    self._mode, new_mode,
                )
                self._mode = new_mode
            if self._mode == "u24":
                if sparse.max(initial=0) >= (1 << 24):
                    sparse = sparse % self.vocab  # see _fits: hash early
                ids = np.ascontiguousarray(sparse, dtype="<u4")
                b, s = ids.shape
                out["sparse"] = (
                    ids.view(np.uint8).reshape(b, s, 4)[:, :, :3].copy()
                )
            elif self._mode == "i32" and sparse.dtype == np.int64:
                out["sparse"] = sparse.astype(np.int32)
        dense = batch.get("dense")
        if dense is not None and dense.dtype == np.float32:
            out["dense"] = dense.astype(np.float16)
        label = batch.get("label")
        if label is not None and label.ndim == 1:
            as_int = label.astype(np.uint8)
            if np.array_equal(as_int.astype(label.dtype), label):
                out["label"] = as_int
        mask = batch.get("mask")
        if mask is not None and mask.dtype == np.float32:
            out["mask"] = mask.astype(np.uint8)
        return out


def encode_batch(batch: Dict[str, np.ndarray], vocab: int) -> Dict[str, np.ndarray]:
    """One-shot encode (tests / single batches).  Streams should hold a
    :class:`WireEncoder` so the sparse representation stays pinned."""
    return WireEncoder(vocab)(batch)


def decode_batch(batch) -> Dict:
    """Device-side: restore the standard batch layout from tensors.

    Dtype-driven, so it is a no-op on batches that were never encoded —
    safe to call unconditionally in the train step.
    """
    if not isinstance(batch, dict):
        return batch
    out = dict(batch)
    sparse = out.get("sparse")
    if sparse is not None and sparse.dtype == torch.uint8 and sparse.dim() >= 3 \
            and sparse.shape[-1] == 3:
        b = sparse.to(torch.int32)
        out["sparse"] = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    dense = out.get("dense")
    if dense is not None and dense.dtype == torch.float16:
        out["dense"] = dense.to(torch.float32)
    label = out.get("label")
    if label is not None and label.dtype == torch.uint8:
        out["label"] = label.to(torch.float32)
    mask = out.get("mask")
    if mask is not None and mask.dtype == torch.uint8:
        out["mask"] = mask.to(torch.float32)
    return out


def wire_bytes(batch: Dict[str, np.ndarray]) -> int:
    return sum(v.nbytes for v in batch.values() if hasattr(v, "nbytes"))
