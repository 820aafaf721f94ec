"""GNN aggregation layers over fixed-fanout neighbour samples.

Counterpart of ``paddlerec_tpu/models/graph/layers.py``: GIN, GraphSAGE
(mean, bag of words, max), GAT, LightGCN and TransformerConv, each a module
``conv(self_feat (..., E), neigh_feats (..., K, E), neigh_mask (..., K))``
→ ``(..., hidden)`` with the flax tree's parameter names (``lin``, ``w``,
``w_n``, ``a_src``, ``a_dst``, ``q``, ``k``, ``v``, ``skip``, ``gate``).
Every node carries K sampled neighbours and aggregation is a masked
reduction over the K axis, in plain PyTorch: XLA computes these outside any
Pallas kernel too.

SAGE-max fills masked neighbours with -1e9 before the max, and a node with
no neighbour gets zeros; its gradient is shared evenly among tied maxima
(``torch.amax``), as JAX's ``max`` shares it.  GAT gives a node with no
neighbour uniform weights over its K (masked) slots, as the reference does.
TransformerConv splits its heads as ``(..., h, hd)`` and gates its skip
connection on ``[out, skip, out - skip]``.  The activation is ReLU, the
reference's default and the only one its encoder uses.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.ops.layers import flax_dense


def _masked_mean(x, mask):
    return (x * mask[..., None]).sum(-2) / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)


def _masked_sum(x, mask):
    return (x * mask[..., None]).sum(-2)


def _l2norm(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class GINConv(nn.Module):
    """self + Σ neigh → linear → ReLU → + self."""

    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = flax_dense(dim, hidden, device=device, generator=generator)

    def forward(self, self_feat, neigh_feats, neigh_mask):
        out = self_feat + _masked_sum(neigh_feats, neigh_mask)
        return F.relu(self.lin(out)) + self_feat


class GraphSAGEMeanConv(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = flax_dense(2 * dim, hidden, device=device, generator=generator)

    def forward(self, self_feat, neigh_feats, neigh_mask):
        neigh = _masked_mean(neigh_feats, neigh_mask)
        return _l2norm(F.relu(self.lin(torch.cat([self_feat, neigh], -1))))


class GraphSAGEBowConv(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

    def forward(self, self_feat, neigh_feats, neigh_mask):
        return _l2norm(self_feat + _masked_mean(neigh_feats, neigh_mask))


class GraphSAGEMaxConv(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = flax_dense(2 * dim, hidden, device=device, generator=generator)

    def forward(self, self_feat, neigh_feats, neigh_mask):
        filled = torch.where(neigh_mask[..., None] > 0, neigh_feats,
                             neigh_feats.new_tensor(-1e9))
        neigh = torch.amax(filled, dim=-2)
        neigh = torch.where(neigh_mask.sum(-1, keepdim=True) > 0, neigh,
                            neigh.new_zeros(()))
        return _l2norm(F.relu(self.lin(torch.cat([self_feat, neigh], -1))))


class GATConv(nn.Module):
    """Single-head attention over the sampled neighbours."""

    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.w = flax_dense(dim, hidden, bias=False, **kw)
        self.w_n = flax_dense(dim, hidden, bias=False, **kw)
        self.a_src = flax_dense(hidden, 1, bias=False, **kw)
        self.a_dst = flax_dense(hidden, 1, bias=False, **kw)
        self.lin = flax_dense(dim + hidden, hidden, **kw)

    def forward(self, self_feat, neigh_feats, neigh_mask):
        h_neigh = self.w_n(neigh_feats)
        a_src = self.a_src(self.w(self_feat))[..., 0]
        a_dst = self.a_dst(h_neigh)[..., 0]
        e = F.leaky_relu(a_src[..., None] + a_dst)  # slope 0.01, as flax's
        e = torch.where(neigh_mask > 0, e, e.new_tensor(-1e9))
        att = torch.softmax(e, -1)
        neigh = torch.einsum("...k,...kd->...d", att, h_neigh)
        return F.relu(self.lin(torch.cat([self_feat, neigh], -1)))


class LightGCNConv(nn.Module):
    """Degree-normalized propagation, no parameters."""

    def __init__(self, dim: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

    def forward(self, self_feat, neigh_feats, neigh_mask):
        deg = torch.clamp(neigh_mask.sum(-1, keepdim=True), min=1.0)
        return _masked_sum(neigh_feats, neigh_mask) * torch.rsqrt(deg)


class TransformerConvLayer(nn.Module):
    """Multi-head attention from the node (query) to its neighbours (keys,
    values), with a gated skip connection."""

    def __init__(self, dim: int, hidden: int, heads: int = 4,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.heads, self.head_dim = heads, hidden // heads
        width = heads * self.head_dim
        self.q = flax_dense(dim, width, **kw)
        self.k = flax_dense(dim, width, **kw)
        self.v = flax_dense(dim, width, **kw)
        self.skip = flax_dense(dim, hidden, **kw)
        self.gate = flax_dense(2 * width + hidden, 1, **kw)

    def forward(self, self_feat, neigh_feats, neigh_mask):
        h, hd = self.heads, self.head_dim
        shp, kk = neigh_feats.shape[:-2], neigh_feats.shape[-2]
        qh = self.q(self_feat).reshape(shp + (h, hd))
        kh = self.k(neigh_feats).reshape(shp + (kk, h, hd))
        vh = self.v(neigh_feats).reshape(shp + (kk, h, hd))
        scores = torch.einsum("...hd,...khd->...hk", qh, kh) / hd ** 0.5
        scores = torch.where(neigh_mask[..., None, :] > 0, scores, scores.new_tensor(-1e9))
        att = torch.softmax(scores, -1)
        out = torch.einsum("...hk,...khd->...hd", att, vh).reshape(shp + (h * hd,))
        skip = self.skip(self_feat)
        gate = torch.sigmoid(self.gate(torch.cat([out, skip, out - skip], -1)))
        return F.relu(gate * skip + (1 - gate) * out)


CONV_REGISTRY = {
    "gin": GINConv,
    "graphsage_mean": GraphSAGEMeanConv,
    "graphsage_bow": GraphSAGEBowConv,
    "graphsage_max": GraphSAGEMaxConv,
    "gat": GATConv,
    "lightgcn": LightGCNConv,
    "transformer_conv": TransformerConvLayer,
}
