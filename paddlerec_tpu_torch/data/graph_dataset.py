"""Chunked graph-walk dataset: memory-capped passes over the native graph
engine.

Counterpart of ``paddlerec_tpu/data/graph_dataset.py`` (numpy only): walks
are generated pass by pass from a bounded chunk of start nodes
(``hyper_parameters.graph_chunk_nodes``, 8,192 by default), and the next
pass is produced by a preload thread while the current one trains.  The
walker and sampler are the port's build of ``native/graph_engine.cpp``
(``native/graph.py``).  The producer thread (pass shuffles, walk seeds) and
the consumer (neighbour-sample seeds) draw from two independent
``RandomState``s, so a run is reproducible from ``runner.seed``: epoch e
seeds them ``seed + e`` and ``seed + e + 10,000,019``.  One process reads
every file (the JAX package's process 0 of 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np


def window_pairs(walks: np.ndarray, win: int) -> np.ndarray:
    """(C, L) walks with -1 padding → (N, 2) (center, context) pairs for
    every |i-j| <= win, j != i, in both directions."""
    outs = []
    for off in range(1, win + 1):
        if walks.shape[1] <= off:
            break
        a, b = walks[:, :-off], walks[:, off:]
        valid = (a >= 0) & (b >= 0)
        av, bv = a[valid], b[valid]
        outs.append(np.stack([av, bv], 1))
        outs.append(np.stack([bv, av], 1))
    if not outs:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(outs, 0)


class GraphChunkedDataset:
    """Edge files → native engine → chunked walk passes → model batches
    (``pair_nodes`` and, for each hop of ``md.samples``, ``neigh_i`` and
    ``neigh_mask_i``).  Peak host memory is O(chunk_nodes · walk_len · win)
    pairs, not O(nodes · walks)."""

    def __init__(self, files: Sequence[str], md, batch_size: int,
                 seed: int = 2023, chunk_nodes: Optional[int] = None,
                 num_parts: int = 4, preload: bool = True):
        from paddlerec_tpu_torch.native.graph import GraphEngine

        self.md = md
        self.batch_size = int(batch_size)
        self.seed = seed
        self.chunk_nodes = int(chunk_nodes or int(md.config.hyper("graph_chunk_nodes", 8192)))
        self.preload = preload
        self.engine = GraphEngine(symmetry=True)
        files = list(files)
        # sharded load: bounded parse buffers per part
        parts = max(1, min(num_parts, len(files)))
        for p in range(parts):
            shard = files[p::parts]
            if shard:
                self.engine.load(shard)
        self._nodes = self.engine.nodes()
        self._epoch = 0

    def _passes(self, rng: np.random.RandomState):
        md = self.md
        nodes = self._nodes.copy()
        for _ in range(md.walk_times):
            rng.shuffle(nodes)
            for c0 in range(0, len(nodes), self.chunk_nodes):
                chunk = nodes[c0:c0 + self.chunk_nodes]
                walks = self.engine.walks(chunk, md.walk_len, seed=rng.randint(2**31))
                pairs = window_pairs(walks, md.win_size)
                if len(pairs):
                    rng.shuffle(pairs)
                yield pairs

    def _batches_of(self, pairs: np.ndarray, rem: Optional[np.ndarray],
                    rng: np.random.RandomState):
        if rem is not None and len(rem):
            pairs = np.concatenate([rem, pairs], 0)
        bs = self.batch_size
        stop = len(pairs) - (len(pairs) % bs)
        for i in range(0, stop, bs):
            yield self._batch(pairs[i:i + bs], rng)
        yield None, pairs[stop:]  # the remainder, carried into the next pass

    def _batch(self, pairs: np.ndarray, rng: np.random.RandomState):
        out = {"pair_nodes": pairs}
        prev = pairs
        for i, fanout in enumerate(self.md.samples):
            nb, mask = self.engine.sample(prev, fanout, seed=rng.randint(2**31))
            out[f"neigh_{i}"] = nb
            out[f"neigh_mask_{i}"] = mask
            prev = nb
        return out, None

    def __iter__(self):
        prod_rng = np.random.RandomState(self.seed + self._epoch)
        rng = np.random.RandomState(self.seed + self._epoch + 10_000_019)
        self._epoch += 1
        pass_iter = self._passes(prod_rng)
        if self.preload:
            # one pass ahead, on a thread of its own
            q: "queue.Queue" = queue.Queue(maxsize=1)
            done = object()

            def producer():
                try:
                    for p in pass_iter:
                        q.put(p)
                except BaseException as e:  # handed to the consumer, which raises it
                    q.put(e)
                q.put(done)

            threading.Thread(target=producer, daemon=True).start()

            def passes():
                while True:
                    item = q.get()
                    if item is done:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item

            source = passes()
        else:
            source = pass_iter
        rem: Optional[np.ndarray] = None
        for pairs in source:
            for item, tail in self._batches_of(pairs, rem, rng):
                if item is None:
                    rem = tail
                else:
                    yield item
