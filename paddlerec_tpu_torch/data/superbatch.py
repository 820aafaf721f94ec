"""Superbatch stacking: the one implementation of the staging contract.

A copy of ``paddlerec_tpu/data/superbatch.py`` (numpy only).  A superbatch
rides K host batches on ONE host→device transfer (one large copy from pinned
memory instead of K small ones); the train step indexes sub-batch i on the
device.  Consecutive batches are grouped into stacks of ≤K, with groups
split at shape/dtype boundaries (ragged tail batch, wire-encoding
escalation) so ``np.stack`` never sees ragged inputs and no batch is
dropped.

Used by ``Trainer._staged_superbatches``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np


def stack_superbatches(batches: Iterable[Dict[str, np.ndarray]],
                       k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dicts whose leaves are (G, *batch_shape) stacks of G ≤ k
    consecutive same-signature batches."""
    def sig(b):
        return {key: (v.shape, v.dtype) for key, v in b.items()}

    buf: list = []

    def flush():
        out = {key: np.stack([x[key] for x in buf]) for key in buf[0]}
        buf.clear()
        return out

    for b in batches:
        if buf and sig(b) != sig(buf[0]):
            yield flush()
        buf.append(b)
        if len(buf) == k:
            yield flush()
    if buf:
        yield flush()
