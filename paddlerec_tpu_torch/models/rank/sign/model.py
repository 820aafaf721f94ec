"""SIGN (L0-SIGN): beneficial feature interactions from an L0-regularized
graph neural network.

Counterpart of ``paddlerec_tpu/models/rank/sign/model.py``, registered as
``rank.sign``.  Each instance is a complete directed graph over its F
feature nodes, held dense:

  * a link predictor gives each edge (i, j) a hard-concrete gate from the
    edge embeddings' product through ``lp_fc1`` / ``lp_fc2``: in training
    sampled with uniform noise through a stretched sigmoid (``log2`` as in
    the reference, the noise clipped to [1e-6, 1 - 1e-6]), at evaluation
    the deterministic sigmoid; the L0 penalty is the gates' mean open
    probability over the real edges;
  * messages ``sign_fc2(relu(sign_fc1(x_i·x_j)))·s_ij``, one (B, F, F, D)
    product, averaged over the open edges (``s > 0``, which takes no
    gradient); graph embedding = the mean of the real nodes → ``g`` → two
    outputs clipped to [0, 1];
  * loss = MSE against the one-hot label + ``l0_weight``·L0 +
    ``l2_weight``·‖nodes‖²; AUC on output[:, 1].

The model is ``stochastic``: ``train_forward`` draws the gates' noise with
``draw_noise`` from the trainer's per-step generator; without one (eval,
serving) the gates are deterministic.  Two tables (``feature_emb``,
``feature_emb_edge``), each read once a forward: two K1 launches, two K1b a
step.  ``SIGNDataset`` is a copy of the JAX package's reader.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense


@functools.lru_cache(maxsize=None)
def _bound(value: float, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d constant on ``device``, made once per device (never an
    inference tensor: a later train step saves it for its backward)."""
    with torch.inference_mode(False):
        return torch.full((), value, device=device, dtype=dtype)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a tie
    (x exactly at a bound) is halved, as JAX's; ``torch.clamp`` passes it
    whole.  A closed gate stretched to exactly 0, or an output of exactly 0
    from a graph with every edge closed, is such a tie."""
    return torch.minimum(torch.maximum(x, _bound(lo, x.device, x.dtype)),
                         _bound(hi, x.device, x.dtype))


class SIGNNet(nn.Module):
    """Parameters ``feature_emb``, ``feature_emb_edge`` (normal(0.01)),
    ``lp_fc1``, ``lp_fc2`` (bias 0.2), ``sign_fc1``, ``sign_fc2``, ``g``.
    node_ids (B, F), node_mask (B, F), noise (B, F, F) uniform(0, 1) or
    None → (outputs (B, 2), L0 penalty, L2 penalty)."""

    def __init__(self, n_feature: int, dim: int = 8, hidden: int = 32, temp: float = 0.66,
                 inter_min: float = -0.1, inter_max: float = 1.1, pred_edges: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.temp, self.inter_min, self.inter_max = temp, inter_min, inter_max
        self.pred_edges = pred_edges
        self.feature_emb = Embed(n_feature, dim, **kw)
        if pred_edges:
            self.feature_emb_edge = Embed(n_feature, dim, stddev=0.01, **kw)
            self.lp_fc1 = flax_dense(dim, hidden, **kw)
            self.lp_fc2 = flax_dense(hidden, 1, **kw)
            with torch.no_grad():
                self.lp_fc2.bias.fill_(0.2)
        self.sign_fc1 = flax_dense(dim, hidden, **kw)
        self.sign_fc2 = flax_dense(hidden, dim, **kw)
        self.g = flax_dense(dim, 2, **kw)

    def forward(self, node_ids, node_mask, noise: Optional[torch.Tensor] = None):
        b, f = node_ids.shape
        x = self.feature_emb(node_ids)
        pair = x[:, :, None, :] * x[:, None, :, :]  # (B, F, F, D)
        off_diag = 1.0 - torch.eye(f, device=x.device, dtype=x.dtype)
        edge_mask = node_mask[:, :, None] * node_mask[:, None, :] * off_diag[None]
        if self.pred_edges:
            xe = self.feature_emb_edge(node_ids)
            pe = xe[:, :, None, :] * xe[:, None, :, :]
            loc = self.lp_fc2(torch.relu(self.lp_fc1(pe)))[..., 0]  # (B, F, F)
            if noise is not None:
                u = torch.clamp(noise, 1e-6, 1 - 1e-6)
                s = torch.sigmoid((loc + torch.log2(u) - torch.log2(1 - u)) / self.temp)
            else:
                s = torch.sigmoid(loc)
            s = clip(s * (self.inter_max - self.inter_min) + self.inter_min, 0.0, 1.0)
            l0 = torch.sigmoid(
                loc - self.temp * math.log2(-self.inter_min / self.inter_max))
            l0_penalty = (l0 * edge_mask).sum() / torch.clamp(edge_mask.sum(), min=1.0)
        else:
            s = x.new_ones((b, f, f))
            l0_penalty = x.new_zeros(())
        msg = self.sign_fc2(torch.relu(self.sign_fc1(pair))) * s[..., None]
        open_edges = edge_mask * (s > 0).to(x.dtype)
        nodes = (msg * open_edges[..., None]).sum(dim=2) / torch.clamp(
            open_edges.sum(dim=2, keepdim=True), min=1.0)  # (B, F, D)
        l2_penalty = (torch.square(nodes) * node_mask[..., None]).sum()
        graph_emb = (nodes * node_mask[..., None]).sum(dim=1) / torch.clamp(
            node_mask.sum(dim=1, keepdim=True), min=1.0)
        out = clip(self.g(graph_emb), 0.0, 1.0)
        return out, l0_penalty, l2_penalty


@register_model("rank.sign")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)
    stochastic = True  # the L0 gates sample uniform noise per train step

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.n_feature = int(h("n_feature", 1000))
        self.num_nodes = int(h("num_nodes", 3))
        l0: Sequence[float] = h("l0_para", [0.66, -0.1, 1.1])
        self.l0_para = tuple(float(v) for v in l0)
        self.l0_weight = float(h("l0_weight", 0.001))
        self.l2_weight = float(h("l2_weight", 0.001))
        self.dim = int(h("dim", 8))
        self.hidden = int(h("hidden_layer", 32))
        self.pred_edges = bool(int(h("pred_edges", 1)))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return SIGNNet(self.n_feature, self.dim, self.hidden, *self.l0_para,
                       self.pred_edges, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["nodes"], batch["node_mask"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        f = self.num_nodes
        return {
            "nodes": rng.randint(0, self.n_feature, (batch_size, f)).astype(np.int64),
            "node_mask": np.ones((batch_size, f), np.float32),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def draw_noise(self, generator: torch.Generator, shape, device) -> torch.Tensor:
        """The gates' uniform(0, 1) noise for one train step."""
        return torch.rand(shape, generator=generator, device=device)

    def _forward(self, module, batch, noise):
        nodes, node_mask = self.model_inputs(batch)
        out, l0, l2 = module(nodes, node_mask, noise)
        labels = batch["label"].reshape(-1).to(torch.float32)
        aux: Aux = {"predictions": out[:, 1], "labels": labels}
        if "mask" in batch:
            aux["mask"] = batch["mask"]
        return out, l0, l2, labels, aux

    def train_forward(self, module, batch, generator: Optional[torch.Generator] = None):
        nodes = batch["nodes"]
        b, f = nodes.shape
        noise = (None if generator is None
                 else self.draw_noise(generator, (b, f, f), nodes.device))
        out, l0, l2, labels, aux = self._forward(module, batch, noise)
        onehot = torch.stack([1 - labels, labels], dim=-1)
        w = batch.get("mask", torch.ones_like(labels))
        base = (torch.square(out - onehot).mean(dim=-1) * w).sum() / torch.clamp(
            w.sum(), min=1.0)
        return base + self.l0_weight * l0 + self.l2_weight * l2, aux

    def infer_forward(self, module, batch):
        return self._forward(module, batch, None)[-1]

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return SIGNDataset(list_data_files(data_dir), self.num_nodes, batch_size)


class SIGNDataset:
    """Lines ``label feat1 feat2 ... featF`` (frappe-style instance graphs);
    fewer features leave their nodes masked, more are cut.  The tail batch
    keeps the batch size, its missing rows masked."""

    def __init__(self, files, num_nodes, batch_size):
        self.files = files
        self.num_nodes = num_nodes
        self.batch_size = batch_size

    def __iter__(self):
        bs, f = self.batch_size, self.num_nodes
        nodes = np.zeros((bs, f), np.int64)
        nmask = np.zeros((bs, f), np.float32)
        label = np.zeros((bs,), np.float32)
        i = 0
        for path in self.files:
            with open(path) as fh:
                for line in fh:
                    toks = line.split()
                    if len(toks) < 2:
                        continue
                    label[i] = float(toks[0])
                    feats = [int(v) for v in toks[1:1 + f]]
                    nodes[i, :len(feats)] = feats
                    nmask[i, :len(feats)] = 1.0
                    i += 1
                    if i == bs:
                        yield {"nodes": nodes.copy(), "node_mask": nmask.copy(),
                               "label": label.copy(), "mask": np.ones(bs, np.float32)}
                        nodes[:] = 0
                        nmask[:] = 0
                        i = 0
        if i:
            m = np.zeros(bs, np.float32)
            m[:i] = 1.0
            yield {"nodes": nodes.copy(), "node_mask": nmask.copy(),
                   "label": label.copy(), "mask": m}
