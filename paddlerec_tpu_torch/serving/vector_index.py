"""Vector index helpers — the Milvus tooling analog.

Counterpart of ``paddlerec_tpu/serving/vector_index.py``.  Parity target of
the original: reference recserving/milvus_tool/{milvus_insert,
milvus_recall,milvus_helper}.py — insert item vectors into an ANN
collection and recall top-k for a user vector.  The index is EXACT: one
product and a top-k over the item matrix, which stays on the device between
searches (uploaded at the first search after an insert).  The product is a
plain ``torch.matmul`` (the JAX package leaves it to XLA, outside any Pallas
kernel); the top-k is ``jax.lax.top_k``'s, the lower index first on ties.
``save``/``load`` read and write the JAX package's files (``.npz`` +
``.npz.meta.json``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlerec_tpu_torch.core.device import resolve_device
from paddlerec_tpu_torch.ops.layers import top_k


class VectorIndex:
    """milvus_insert.VecToMilvus / milvus_recall.RecallByMilvus analog, with
    the metric ``ip``, ``l2`` (scored by the negative squared distance) or
    ``cosine``, searched on ``device`` (the card by default)."""

    def __init__(self, metric: str = "ip", device=None):
        assert metric in ("ip", "l2", "cosine")
        self.metric = metric
        self.device = resolve_device(device)
        self._vectors: Optional[np.ndarray] = None
        self._ids: List[int] = []
        self._device_matrix: Optional[torch.Tensor] = None  # reset on insert

    # -- insert (milvus_insert.py) -----------------------------------------
    def insert(self, vectors: Sequence[Sequence[float]],
               ids: Optional[Sequence[int]] = None):
        vecs = np.asarray(vectors, np.float32)
        if ids is None:
            ids = list(range(len(self._ids),
                             len(self._ids) + len(vecs)))
        self._ids.extend(int(i) for i in ids)
        self._vectors = (
            vecs if self._vectors is None
            else np.concatenate([self._vectors, vecs])
        )
        self._device_matrix = None  # invalidate the cached device copy
        return list(ids)

    def __len__(self):
        return len(self._ids)

    # -- search (milvus_recall.py) ------------------------------------------
    @torch.no_grad()
    def search(self, queries, topk: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k), ids (Q, k))."""
        assert self._vectors is not None and len(self._ids) > 0
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        if self._device_matrix is None:
            # upload the catalog once; per-query re-upload dominated
            # serving latency for large catalogs
            self._device_matrix = torch.as_tensor(self._vectors, device=self.device)
        m = self._device_matrix
        if self.metric == "cosine":
            q = q * torch.rsqrt((q**2).sum(-1, keepdim=True) + 1e-12)
            m = m * torch.rsqrt((m**2).sum(-1, keepdim=True) + 1e-12)
            scores = q @ m.T
        elif self.metric == "ip":
            scores = q @ m.T
        else:  # l2: negative distance so top_k = nearest
            scores = -(
                (q**2).sum(-1, keepdim=True)
                - 2 * q @ m.T
                + (m**2).sum(-1)[None]
            )
        vals, idx = top_k(scores, min(topk, m.shape[0]))
        ids = np.asarray(self._ids)[idx.cpu().numpy()]
        return vals.cpu().numpy(), ids

    # -- persistence ------------------------------------------------------------
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        npz = path if path.endswith(".npz") else path + ".npz"
        np.savez(npz, vectors=self._vectors,
                 ids=np.asarray(self._ids, np.int64))
        with open(npz + ".meta.json", "w") as f:
            json.dump({"metric": self.metric}, f)

    @classmethod
    def load(cls, path: str, device=None) -> "VectorIndex":
        npz = path if path.endswith(".npz") else path + ".npz"
        z = np.load(npz)
        with open(npz + ".meta.json") as f:
            meta = json.load(f)
        idx = cls(meta["metric"], device=device)
        idx.insert(z["vectors"], z["ids"].tolist())
        return idx
