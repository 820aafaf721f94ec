"""DeepWalk: skip-gram node embeddings from random walks.

Counterpart of ``paddlerec_tpu/models/recall/deepwalk/model.py``, registered
as ``recall.deepwalk``: one node table ``node_embedding`` (``num_nodes`` ×
``embed_size``, 10,312 × 16 by default) drawn uniform on [-1, 1); the logit
of a pair is the product of the source's and the destination's rows, the
positive followed by ``neg_num`` uniform negatives; the loss is the mean of
the positives' and of the negatives' sigmoid cross-entropies, averaged.  The
AUC of the sigmoid logits is logged as ``auc``.

The source (N = B) and the destinations (N = B·(1 + neg_num)) are read in one
K1 launch (``Embed(src, dsts)``), so a step is one K1 and one K1b launch.
``node_embeddings`` is the serving call.

``WalkPairDataset`` is a copy of the JAX package's reader (numpy only):
``src dst`` edge lines, symmetric adjacency, ``walks_per_node`` walks of
``walk_len`` from every node in a shuffled order, window pairs of
``win_size``, negatives uniform over the nodes, all from one
``RandomState(runner.seed)``; the tail that does not fill a batch is
dropped.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.embedding import Embed


class SkipGramNet(nn.Module):
    """src (B,), dsts (B, 1 + neg) → logits (B, 1 + neg)."""

    def __init__(self, num_nodes: int, embed_size: int = 16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_embedding = Embed(num_nodes, embed_size, uniform=(-1.0, 1.0),
                                    device=device, generator=generator)

    def forward(self, src, dsts):
        src_e, dst_e = self.node_embedding(src, dsts)
        return torch.einsum("be,bne->bn", src_e, dst_e)


@register_model("recall.deepwalk")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        self.num_nodes = int(config.hyper("num_nodes", 10312))
        self.embed_size = int(config.hyper("embed_size", 16))
        self.neg_num = int(config.hyper("neg_num", 5))
        self.walk_len = int(config.hyper("walk_len", 40))
        self.win_size = int(config.hyper("win_size", 5))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return SkipGramNet(self.num_nodes, self.embed_size, device=device,
                           generator=generator)

    def model_inputs(self, batch):
        return (batch["src"], batch["dsts"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "src": rng.randint(0, self.num_nodes, batch_size).astype(np.int64),
            "dsts": rng.randint(0, self.num_nodes,
                                (batch_size, 1 + self.neg_num)).astype(np.int64),
        }

    def train_forward(self, module, batch):
        logits = module(*self.model_inputs(batch))
        pos, neg = logits[:, :1], logits[:, 1:]
        # -log σ(pos) and -log σ(-neg), as optax's sigmoid cross-entropy
        loss = (-F.logsigmoid(pos).mean() - F.logsigmoid(-neg).mean()) / 2
        labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)], dim=1)
        return loss, {"predictions": torch.sigmoid(logits).reshape(-1),
                      "labels": labels.reshape(-1)}

    @staticmethod
    def node_embeddings(module, nodes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The serving call: the whole node table (as the JAX package's
        ``node_embeddings``), or the rows of ``nodes`` through one K1
        launch."""
        if nodes is None:
            return module.node_embedding.embedding.detach()
        return module.node_embedding(nodes)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return WalkPairDataset(list_data_files(data_dir), self, batch_size,
                               seed=int(self.config.runner("seed", 2023)))


class WalkPairDataset:
    """Edge-list files (``src dst`` per line) → random walks → (center,
    context) skip-gram pairs with uniform negative sampling."""

    def __init__(self, files, md, batch_size, walks_per_node=2, seed=2023):
        self.files = files
        self.md = md
        self.batch_size = batch_size
        self.walks_per_node = walks_per_node
        self.seed = seed

    def _adjacency(self):
        adj = {}
        for path in self.files:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) < 2:
                        continue
                    a, b = int(toks[0]), int(toks[1])
                    adj.setdefault(a, []).append(b)
                    adj.setdefault(b, []).append(a)
        return adj

    def __iter__(self):
        md = self.md
        rng = np.random.RandomState(self.seed)
        adj = self._adjacency()
        if not adj:
            return
        nodes = list(adj)
        src_buf, dst_buf = [], []
        for _ in range(self.walks_per_node):
            rng.shuffle(nodes)
            for start in nodes:
                walk = [start]
                for _ in range(md.walk_len - 1):
                    nbrs = adj.get(walk[-1])
                    if not nbrs:
                        break
                    walk.append(nbrs[rng.randint(len(nbrs))])
                for i, center in enumerate(walk):
                    lo, hi = max(0, i - md.win_size), min(len(walk), i + md.win_size + 1)
                    for j in range(lo, hi):
                        if j == i:
                            continue
                        src_buf.append(center)
                        dst_buf.append(walk[j])
                        if len(src_buf) == self.batch_size:
                            negs = rng.randint(0, md.num_nodes, (self.batch_size, md.neg_num))
                            yield {
                                "src": np.asarray(src_buf, np.int64),
                                "dsts": np.concatenate(
                                    [np.asarray(dst_buf, np.int64)[:, None], negs], axis=1),
                            }
                            src_buf, dst_buf = [], []
