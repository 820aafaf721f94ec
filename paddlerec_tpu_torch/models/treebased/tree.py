"""TDM tree index: construction, sampling, traversal (host-side numpy).

A copy of ``paddlerec_tpu/models/treebased/tree.py`` (numpy only, so the
port keeps its own): the same codes, level sets and samples for one
``RandomState``.  Parity target of the original: reference
models/treebased/builder/tree_index_builder.py —
  * ``build_by_category`` (tree_index_builder.py:34-80): items sorted by
    (category, id), codes assigned by recursive balanced splitting;
  * ``tree_init_by_kmeans`` (tree_index_builder.py:97-245): recursive
    balanced 2-means over item embeddings, rebalanced so each side gets
    ⌈n/2⌉/⌊n/2⌋ members;
  * the proto KV artifact is replaced by a plain ``.npz`` (ids, codes,
    branch), the same file the JAX package writes and reads.

Node numbering matches the reference: root code 0, children of c are
branch·c + {1..branch} (tree_index_builder.py:59-75 assigns
``branch·code + branch − i``), ancestors via (c−1)//branch
(tree_index_builder.py:429-434).

The layer-wise sampling (`tdm_sample`, driven by
tools/static_trainer.py:152-159 in the reference) is `TreeIndex.sample`:
for each positive leaf, emit its ancestor as the positive at every layer
plus uniform same-layer negatives.

``TreeIndex.__init__`` and ``sample``'s first call (the ancestor cache) are
Python loops over every code: about a second for a tree of 65,536 items.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class TreeIndex:
    def __init__(self, item_ids: np.ndarray, codes: np.ndarray,
                 branch: int = 2):
        self.branch = int(branch)
        self.item_ids = np.asarray(item_ids, np.int64)
        self.codes = np.asarray(codes, np.int64)  # leaf code per item
        self.code_to_item: Dict[int, int] = {
            int(c): int(i) for c, i in zip(self.codes, self.item_ids)
        }
        self.max_level = self._level(int(self.codes.max())) if len(codes) else 0
        # per-level sets of codes that have ≥1 leaf descendant
        self.level_codes: List[np.ndarray] = []
        levels: List[set] = [set() for _ in range(self.max_level + 1)]
        for c in self.codes:
            c = int(c)
            lv = self._level(c)
            levels[lv].add(c)
            while c > 0:
                c = (c - 1) // self.branch
                levels[self._level(c)].add(c)
        self.level_codes = [
            np.asarray(sorted(s), np.int64) for s in levels
        ]
        self.total_nodes = int(
            (self.branch ** (self.max_level + 1) - 1) // (self.branch - 1)
            if self.branch > 1 else self.codes.max() + 1
        )
        self._anc_matrix = None  # lazy (items, max_level) ancestor cache
        self._item_order = None

    # -- structure ----------------------------------------------------------
    def _level(self, code: int) -> int:
        lv = 0
        while code > 0:
            code = (code - 1) // self.branch
            lv += 1
        return lv

    def ancestors(self, code: int) -> List[int]:
        """Codes from the leaf up to (excluding) the root."""
        out = []
        while code > 0:
            out.append(code)
            code = (code - 1) // self.branch
        return out

    def children(self, code: int) -> List[int]:
        return [self.branch * code + k for k in range(1, self.branch + 1)]

    # -- construction ---------------------------------------------------------
    @classmethod
    def build_by_category(cls, item_ids, cat_ids, branch: int = 2):
        order = np.lexsort((np.asarray(item_ids), np.asarray(cat_ids)))
        ids = np.asarray(item_ids, np.int64)[order]
        codes = np.zeros(len(ids), np.int64)

        def gen(start, end, code):
            if end <= start:
                return
            if end == start + 1:
                codes[start] = code
                return
            num, remain = divmod(end - start, branch)
            for i in range(branch):
                sub_end = start + num + (1 if remain > 0 else 0)
                remain = max(remain - 1, 0)
                sub_end = min(sub_end, end)
                gen(start, sub_end, branch * code + branch - i)
                start = sub_end

        gen(0, len(ids), 0)
        # push all leaves to the deepest level (same alignment as
        # build_by_kmeans): sample()'s ancestor matrix assumes uniform
        # leaf depth — unpadded shallow leaves would train on wrong
        # positives whenever the catalog size is not a branch power
        max_level = max(cls._static_level(int(c), branch) for c in codes)
        for i in range(len(codes)):
            c = int(codes[i])
            while cls._static_level(c, branch) < max_level:
                c = branch * c + branch
            codes[i] = c
        return cls(ids, codes, branch)

    @classmethod
    def build_by_kmeans(cls, item_ids, embeddings, branch: int = 2,
                        seed: int = 0):
        """Recursive balanced 2-means (tree_init_by_kmeans)."""
        ids = np.asarray(item_ids, np.int64)
        data = np.asarray(embeddings, np.float64)
        rng = np.random.RandomState(seed)
        codes = np.zeros(len(ids), np.int64)
        stack = [(0, np.arange(len(ids)))]
        while stack:
            code, index = stack.pop()
            if len(index) <= branch:
                # assign leaves directly (reference _minbatch)
                for i, idx in enumerate(np.sort(index)):
                    codes[idx] = branch * code + branch - i
                continue
            left, right = _balanced_two_means(data[index], rng)
            stack.append((branch * code + branch, index[left]))
            stack.append((branch * code + branch - 1, index[right]))
        # push all leaves to the deepest level so every leaf has the same
        # ancestor count (the reference pads codes the same way via the
        # builder's level alignment)
        max_level = max(cls._static_level(int(c), branch) for c in codes)
        for i in range(len(codes)):
            c = int(codes[i])
            while cls._static_level(c, branch) < max_level:
                c = branch * c + branch
            codes[i] = c
        return cls(ids, codes, branch)

    @staticmethod
    def _static_level(code: int, branch: int) -> int:
        lv = 0
        while code > 0:
            code = (code - 1) // branch
            lv += 1
        return lv

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(
            path, item_ids=self.item_ids, codes=self.codes,
            branch=self.branch,
        )

    @classmethod
    def load(cls, path: str) -> "TreeIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(z["item_ids"], z["codes"], int(z["branch"]))

    # -- sampling (the tdm_sample analog) --------------------------------------
    def sample(
        self,
        target_items: np.ndarray,
        neg_per_layer: int,
        rng: np.random.RandomState,
        start_level: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """For each target item: positives = its ancestors per layer,
        negatives = ``neg_per_layer`` uniform same-layer codes ≠ positive.

        Returns (unit_codes (B, T), labels (B, T)) with
        T = (#layers)·(1 + neg_per_layer).  Vectorized: ancestor chains
        and per-layer negatives are drawn with array ops (the Python
        per-example loop capped TDM ingestion at ~30 rows/s)."""
        layers = list(range(start_level, self.max_level + 1))
        per = 1 + neg_per_layer
        n = len(np.asarray(target_items).reshape(-1))
        units = np.zeros((n, len(layers) * per), np.int64)
        labels = np.zeros((n, len(layers) * per), np.float32)

        if self._anc_matrix is None:
            # (#items, max_level) ancestor codes per leaf, level 1..max
            anc = np.zeros((len(self.item_ids), self.max_level), np.int64)
            for i, code in enumerate(self.codes):
                c = int(code)
                for lv in range(self.max_level, 0, -1):
                    anc[i, lv - 1] = c
                    c = (c - 1) // self.branch
            order = np.argsort(self.item_ids)
            self._anc_matrix = anc
            self._item_order = order

        items = np.asarray(target_items, np.int64).reshape(-1)
        sorted_ids = self.item_ids[self._item_order]
        pos_idx = np.searchsorted(sorted_ids, items)
        pos_idx = np.clip(pos_idx, 0, len(sorted_ids) - 1)
        row = self._item_order[pos_idx]
        known = sorted_ids[pos_idx] == items

        for li, lv in enumerate(layers):
            col = li * per
            pos = np.where(known, self._anc_matrix[row, lv - 1], 0)
            units[:, col] = pos
            labels[:, col] = known.astype(np.float32)
            cand = self.level_codes[lv]
            negs = cand[rng.randint(0, len(cand), (n, neg_per_layer))]
            if len(cand) > 1:  # resample collisions with the positive once,
                # then shift deterministically (bias-free enough for training)
                clash = negs == pos[:, None]
                redraw = cand[rng.randint(0, len(cand), (n, neg_per_layer))]
                negs = np.where(clash, redraw, negs)
                clash = negs == pos[:, None]
                alt_idx = (
                    np.searchsorted(cand, negs.reshape(-1)) + 1
                ) % len(cand)
                negs = np.where(
                    clash, cand[alt_idx].reshape(n, neg_per_layer), negs
                )
            units[:, col + 1 : col + per] = negs
        return units, labels

    # -- retrieval ------------------------------------------------------------
    def beam_layers(self, beam: int) -> List[np.ndarray]:
        """Per-level candidate code arrays, starting at the first level
        whose node count exceeds the beam (infer.py:115-131)."""
        start = next(
            (lv for lv, codes in enumerate(self.level_codes)
             if len(codes) > beam),
            self.max_level,
        )
        return self.level_codes[start:]

    def leaf_items(self, codes) -> List[int]:
        return [
            self.code_to_item[c]
            for c in np.asarray(codes).reshape(-1).tolist()
            if c in self.code_to_item
        ]


def _balanced_two_means(
    data: np.ndarray, rng: np.random.RandomState, iters: int = 10
):
    """2-means with exact rebalancing (reference _cluster/_rebalance,
    tree_index_builder.py:222-245): sort by distance-gap and split the
    index set into two equal halves."""
    n = len(data)
    c = data[rng.choice(n, 2, replace=False)]
    for _ in range(iters):
        d = ((data[:, None, :] - c[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(2):
            pts = data[assign == k]
            if len(pts):
                c[k] = pts.mean(0)
    d = ((data[:, None, :] - c[None]) ** 2).sum(-1)
    gap = d[:, 0] - d[:, 1]
    order = np.argsort(gap)  # most-left first
    half = (n + 1) // 2
    return order[:half], order[half:]
