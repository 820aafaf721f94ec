"""Graph learning: metapath-walk skip-gram with an optional GNN encoder.

Counterpart of ``paddlerec_tpu/models/graph/gnn/model.py``, registered as
``graph.gnn`` and under the reference's yaml names ``graph.lightgcn``,
``graph.transformer_conv`` (``sage_layer_type`` and ``sage_mode: true`` by
default) and ``graph.deepwalk_million`` (``sage_mode: false``, the pure
skip-gram).  One node table ``node_embedding`` (``num_nodes`` × ``emb_size``,
10,000 × 64 by default, flax's normal init) is read for the (src, pos) pair
nodes and every hop of sampled neighbours in one K1 launch (N = B·2·(1 + K₀
+ K₀K₁ + ...)); with ``sage_mode`` a stack of convs (``models/graph/
layers.py``, one per hop of ``samples``) aggregates from the deepest hop
inwards.  The logits are src · [pos ‖ in-batch negatives], the negatives
the positives rolled by 1..``neg_num`` rows; a rolled row whose node equals
the row's own positive is masked (``neg_ok``) out of the loss and the AUC.
Losses: ``nce`` (default; the softmax of ``nce_tao``·logits over the
positive and the unmasked negatives), ``hinge`` (``margin``) and
``sigmoid`` (the positive weighted ``neg_num``), each summed over the batch.

Input: edge files ``src dst [etype]``.  By default (``runner.graph_engine:
native``) batches come from ``GraphChunkedDataset`` over the native walk
engine, in ``runner.graph_num_parts`` shards; with ``graph_engine: python``,
or where the engine cannot be built (no ``g++``), from the Python walker
``GraphWalkDataset``, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.models.graph.layers import CONV_REGISTRY
from paddlerec_tpu_torch.ops.embedding import Embed

logger = logging.getLogger("paddlerec_tpu_torch")


class GNNEncoder(nn.Module):
    def __init__(self, num_nodes: int, emb_size: int, conv_type: str = "lightgcn",
                 num_layers: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.num_layers = num_layers
        self.node_embedding = Embed(num_nodes, emb_size, **kw)
        conv_cls = CONV_REGISTRY[conv_type]
        for layer in range(num_layers):
            setattr(self, f"conv_{layer}", conv_cls(emb_size, emb_size, **kw))

    def forward(self, nodes, neighbors=None, neighbor_mask=None):
        """nodes (...,); neighbors [(..., K₀), (..., K₀, K₁), ...] and their
        masks → (..., E)."""
        if neighbors is None or self.num_layers == 0:
            return self.node_embedding(nodes)
        feats = list(self.node_embedding(nodes, *neighbors))
        masks = list(neighbor_mask)
        # masks[d] always belongs to hop d+1's fan-out, whatever the layer
        for layer in range(self.num_layers):
            conv = getattr(self, f"conv_{layer}")
            feats = [conv(feats[d], feats[d + 1], masks[d]) for d in range(len(feats) - 1)]
        return feats[0]


@register_model("graph.gnn")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.num_nodes = int(h("num_nodes", 10000))
        self.emb_size = int(h("emb_size", 64))
        self.neg_num = int(h("neg_num", 5))
        self.win_size = int(h("win_size", 2))
        self.walk_len = int(h("walk_len", 4))
        self.walk_times = int(h("walk_times", 10))
        self.sage_mode = bool(h("sage_mode", True))
        samples = h("samples", "5")
        if not isinstance(samples, (list, tuple)):  # "5,5" in a yaml, or 5
            samples = str(samples).split(",")
        self.samples = [int(x) for x in samples] if self.sage_mode else []
        self.loss_type = str(h("loss_type", "nce"))
        self.margin = float(h("margin", 2.0))
        self.nce_tao = float(h("nce_tao", 5.0))
        self.conv_type = str(h("sage_layer_type", "lightgcn")).lower()

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return GNNEncoder(self.num_nodes, self.emb_size, self.conv_type,
                          len(self.samples), device=device, generator=generator)

    def model_inputs(self, batch):
        if not self.sage_mode:
            return (batch["pair_nodes"], None, None)
        hops = range(len(self.samples))
        return (batch["pair_nodes"], [batch[f"neigh_{i}"] for i in hops],
                [batch[f"neigh_mask_{i}"] for i in hops])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        out = {"pair_nodes": rng.randint(0, self.num_nodes, (batch_size, 2)).astype(np.int64)}
        shape = (batch_size, 2)
        for i, k in enumerate(self.samples):
            shape = shape + (k,)
            out[f"neigh_{i}"] = rng.randint(0, self.num_nodes, shape).astype(np.int64)
            out[f"neigh_mask_{i}"] = (rng.rand(*shape) < 0.8).astype(np.float32)
        return out

    def train_forward(self, module, batch):
        feature = module(*self.model_inputs(batch))  # (B, 2, E)
        src, pos = feature[:, 0], feature[:, 1]
        pos_ids = batch["pair_nodes"][:, 1]
        shifts = range(1, self.neg_num + 1)
        negs = [torch.roll(pos, k, dims=0) for k in shifts]
        neg_ok = torch.stack([torch.roll(pos_ids, k, dims=0) != pos_ids for k in shifts],
                             dim=1).float()  # (B, neg)
        dsts = torch.stack([pos] + negs, dim=1)  # (B, 1 + neg, E)
        logits = torch.einsum("be,bne->bn", src, dsts)
        ones = torch.ones_like(logits[:, :1])
        labels = torch.cat([ones, torch.zeros_like(logits[:, 1:])], -1)
        if self.loss_type == "hinge":
            loss = torch.sum(F.relu(logits[:, 1:] - logits[:, :1] + self.margin) * neg_ok)
        elif self.loss_type == "sigmoid":
            weight = torch.cat([ones * self.neg_num, neg_ok], -1)
            per = -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)
            loss = torch.sum(per * weight)
        else:  # nce: collided negatives add exp(-1e9) = 0 to the partition
            scaled = logits * self.nce_tao
            scaled = torch.cat([scaled[:, :1], torch.where(
                neg_ok > 0, scaled[:, 1:], scaled.new_tensor(-1e9))], -1)
            loss = torch.sum(-torch.log_softmax(scaled, -1)[:, 0])
        return loss, {"predictions": torch.sigmoid(logits).reshape(-1),
                      "labels": labels.reshape(-1),
                      "mask": torch.cat([ones, neg_ok], -1).reshape(-1)}

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        files = list_data_files(data_dir)
        seed = int(self.config.runner("seed", 2023))
        engine = str(self.config.runner("graph_engine", "native")).lower()
        if engine != "python":
            from paddlerec_tpu_torch.native.graph import NativeUnavailable

            try:
                from paddlerec_tpu_torch.data.graph_dataset import GraphChunkedDataset

                return GraphChunkedDataset(
                    files, self, batch_size, seed=seed,
                    num_parts=int(self.config.runner("graph_num_parts", 4)))
            except NativeUnavailable as e:
                logger.warning("native graph engine unavailable (%s); walking in "
                               "Python", e)
        return GraphWalkDataset(files, self, batch_size, seed=seed)


@register_model("graph.lightgcn")
class LightGCNModelDef(ModelDef):
    def __init__(self, config):
        config._flat.setdefault("hyper_parameters.sage_layer_type", "lightgcn")
        config._flat.setdefault("hyper_parameters.sage_mode", True)
        super().__init__(config)


@register_model("graph.transformer_conv")
class TransformerConvModelDef(ModelDef):
    def __init__(self, config):
        config._flat.setdefault("hyper_parameters.sage_layer_type", "transformer_conv")
        config._flat.setdefault("hyper_parameters.sage_mode", True)
        super().__init__(config)


@register_model("graph.deepwalk_million")
class DeepwalkMillionModelDef(ModelDef):
    def __init__(self, config):
        config._flat.setdefault("hyper_parameters.sage_mode", False)
        super().__init__(config)


class GraphWalkDataset:
    """Edge files ``src dst [etype]`` → random walks → (src, pos) window
    pairs with fixed-fanout neighbour samples, in Python: a copy of the JAX
    package's walker.  One ``RandomState(seed)`` for the life of the object,
    so every epoch walks anew; the adjacency is parsed once."""

    def __init__(self, files, md, batch_size, seed=2023):
        self.files = files
        self.md = md
        self.batch_size = batch_size
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._adj_cache = None

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
                    adj.setdefault(b, []).append(a)  # symmetric
        return adj

    @staticmethod
    def _sample_neighbors(nodes, adj, rng, fanout):
        flat = nodes.reshape(-1)
        out = np.zeros((len(flat), fanout), np.int64)
        mask = np.zeros((len(flat), fanout), np.float32)
        for i, n in enumerate(flat):
            nbrs = adj.get(int(n))
            if not nbrs:
                continue
            pick = rng.randint(0, len(nbrs), fanout)
            out[i] = [nbrs[p] for p in pick]
            mask[i] = 1.0
        return out.reshape(nodes.shape + (fanout,)), mask.reshape(nodes.shape + (fanout,))

    def __iter__(self):
        md, rng = self.md, self._rng
        if self._adj_cache is None:
            self._adj_cache = self._adjacency()
        adj = self._adj_cache
        if not adj:
            return
        nodes = list(adj)
        pairs = []
        for _ in range(md.walk_times):
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
                        if j != i:
                            pairs.append((center, walk[j]))
                            if len(pairs) == self.batch_size:
                                yield self._batch(pairs, adj, rng)
                                pairs = []

    def _batch(self, pairs, adj, rng):
        out = {"pair_nodes": np.asarray(pairs, np.int64)}
        prev = out["pair_nodes"]
        for i, fanout in enumerate(self.md.samples):
            nb, mask = self._sample_neighbors(prev, adj, rng, fanout)
            out[f"neigh_{i}"] = nb
            out[f"neigh_mask_{i}"] = mask
            prev = nb
        return out
