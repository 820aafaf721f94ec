"""MHCN: multi-channel hypergraph convolution for social recommendation,
self-supervised.

Counterpart of ``paddlerec_tpu/models/recall/mhcn/model.py``, registered as
``recall.mhcn``: motif-induced adjacency matrices H_s (social triangles),
H_j (joint purchase) and H_p (repeat purchase) and the normalized rating
matrix R, built on the host in float64 from a 0/1 social matrix (U × U) and
rating matrix (U × I) (``build_motif_adjacency``); three self-gated user
channels propagated through their motif matrices for ``n_layer`` layers, a
fourth channel through R, mixed by channel attention; the user and item
tables (``user_embeddings``, ``item_embeddings``, ``num_users`` /
``num_items`` × ``num_factors``) are raw parameters, truncated-normal(0.005),
and keep their JAX shapes, as the gates and the attention do.  The loss is
BPR over (user, positive, negative) triples plus ``ss_rate`` times the
hierarchical self-supervision of each channel (local and global mutual
information against row- and row-column-shuffled negatives).  No streaming
metric (``metrics = "none"``); ``user_item_embeddings`` is the serving call.

The graph comes from ``set_graph(social, rating)``, or with
``hyper_parameters.demo_graph: true`` from a seeded random graph of 10%
density; without either the model raises, as the JAX package's does.  The
propagation is dense ``torch.matmul`` (cuBLAS on the card; XLA did it
outside Pallas too).

The model is stochastic: ``train_forward(module, batch, generator=g)`` draws
the three permutations of each channel's shuffles from the trainer's
per-step generator (``torch.randperm``); ``perms=`` takes them explicitly,
three (U, E, U) triples, so that a test can feed the JAX package's
(``jax.random.permutation`` under ``fold_in(rng, i)`` and ``split(·, 3)``).
Without either, as in evaluation, the self-supervision term is 0.

Two K1 launches a forward and two K1b a step: the batch's users'
rows of the final user embedding, and the positives' and negatives' rows of
the item embedding in one launch (``take_rows(..., wrap=True)``, numpy-style
indexing: an id is wrapped once if negative, then clipped).

``MHCNDataset`` reads the triples; the JAX package has no reader for this
model (its trainer's slot reader cannot feed it), so this one is the port's
own: ``user item`` lines (more columns ignored, lines without two integers
skipped), ids taken modulo ``num_users`` / ``num_items``, each line a
positive with a negative drawn uniform among the other items from a
``RandomState(runner.seed)`` kept across epochs; the tail batch is short.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.embedding import take_rows


def build_motif_adjacency(social: np.ndarray, rating: np.ndarray):
    """Dense motif-induced adjacency: social (U, U) 0/1 directed follows,
    rating (U, I) 0/1 → (H_s, H_j, H_p, R_norm) float32, computed in
    float64."""
    s = social.astype(np.float64)
    y = rating.astype(np.float64)
    b = s * s.T
    u = s - b
    c1 = (u @ u) * u.T
    a1 = c1 + c1.T
    c2 = (b @ u) * u.T + (u @ b) * u.T + (u @ u) * b
    a2 = c2 + c2.T
    c3 = (b @ b) * u + (b @ u) * b + (u @ b) * b
    a3 = c3 + c3.T
    a4 = (b @ b) * b
    c5 = (u @ u) * u + (u @ u.T) * u + (u.T @ u) * u
    a5 = c5 + c5.T
    a6 = (u @ b) * u + (b @ u.T) * u.T + (u.T @ u) * b
    a7 = (u.T @ b) * u.T + (b @ u) * u + (u @ u.T) * b
    a8 = (y @ y.T) * b
    a9 = (y @ y.T) * u
    a9 = a9 + a9.T
    a10 = y @ y.T - a8 - a9

    def rownorm(m):
        denom = m.sum(axis=1, keepdims=True)
        return np.divide(m, denom, out=np.zeros_like(m), where=denom > 0)

    h_s = rownorm(a1 + a2 + a3 + a4 + a5 + a6 + a7)
    h_j = rownorm(a8 + a9)
    h_p = rownorm(a10 * (a10 > 1))
    deg_u = np.maximum(y.sum(1, keepdims=True), 1.0)
    deg_i = np.maximum(y.sum(0, keepdims=True), 1.0)
    r_norm = y / np.sqrt(deg_u) / np.sqrt(deg_i)
    return (h_s.astype(np.float32), h_j.astype(np.float32),
            h_p.astype(np.float32), r_norm.astype(np.float32))


def _xavier(shape, device, generator) -> nn.Parameter:
    w = torch.empty(shape, device=device)
    nn.init.xavier_uniform_(w, generator=generator)
    return nn.Parameter(w)


def _norm(x):
    # eps inside the root: an all-zero row (an empty motif matrix) keeps a
    # finite gradient
    return x * torch.rsqrt((x * x).sum(1, keepdim=True) + 1e-12)


class MHCNNet(nn.Module):
    GATES = ("gating1", "gating2", "gating3", "gating4", "sgating1", "sgating2", "sgating3")

    def __init__(self, num_users: int, num_items: int, emb_size: int = 50,
                 n_layers: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        e = emb_size
        tables = []
        for rows in (num_users, num_items):
            t = torch.empty((rows, e), device=device)
            nn.init.trunc_normal_(t, 0.0, 0.005, -0.01, 0.01, generator=generator)
            tables.append(nn.Parameter(t))
        self.user_embeddings, self.item_embeddings = tables
        self.attention_mat = _xavier((e, e), device, generator)
        self.attention = _xavier((1, e), device, generator)
        for name in self.GATES:
            setattr(self, f"{name}_w", _xavier((e, e), device, generator))
            setattr(self, f"{name}_b", _xavier((1, e), device, generator))

    def _gate(self, x, name):
        return x * torch.sigmoid(x @ getattr(self, f"{name}_w") + getattr(self, f"{name}_b"))

    def _channel_attention(self, *channels):
        scores = torch.stack([torch.sum(self.attention * (c @ self.attention_mat), -1)
                              for c in channels], 0)  # (C, U)
        w = torch.softmax(scores, 0)
        return sum(w[i][:, None] * c for i, c in enumerate(channels))

    def forward(self, h_s, h_j, h_p, r_norm):
        """→ final user embedding (U, E), item embedding (I, E), and the
        three self-supervised gated views of the user embedding."""
        user_w = self.user_embeddings
        c1, c2, c3 = (self._gate(user_w, f"gating{i}") for i in (1, 2, 3))
        simple = self._gate(user_w, "gating4")
        acc1, acc2, acc3, acc_s = c1, c2, c3, simple
        item = acc_i = self.item_embeddings
        for _ in range(self.n_layers):
            mixed = self._channel_attention(c1, c2, c3) + simple / 2.0
            c1 = h_s @ c1
            acc1 = acc1 + _norm(c1)
            c2 = h_j @ c2
            acc2 = acc2 + _norm(c2)
            c3 = h_p @ c3
            acc3 = acc3 + _norm(c3)
            new_item = r_norm.T @ mixed
            acc_i = acc_i + _norm(new_item)
            simple = r_norm @ item
            acc_s = acc_s + _norm(simple)
            item = new_item
        final_user = self._channel_attention(acc1, acc2, acc3) + acc_s / 2.0
        views = tuple(self._gate(final_user, f"sgating{i}") for i in (1, 2, 3))
        return final_user, acc_i, views


Perms = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@register_model("recall.mhcn")
class ModelDef(BaseModelDef):
    metrics = "none"
    metric_names = ()
    stochastic = True  # the self-supervision shuffles take the step's generator

    def __init__(self, config):
        super().__init__(config)
        self.num_users = int(config.hyper("num_users", 64))
        self.num_items = int(config.hyper("num_items", 64))
        self.emb_size = int(config.hyper("num_factors", 50))
        self.ss_rate = float(config.hyper("ss_rate", 0.01))
        self.n_layer = int(config.hyper("n_layer", 2))
        self._adj = None  # (H_s, H_j, H_p, R) as numpy, from set_graph
        self._on_device = {}  # the same on each device they were asked for

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return MHCNNet(self.num_users, self.num_items, self.emb_size, self.n_layer,
                       device=device, generator=generator)

    def set_graph(self, social: np.ndarray, rating: np.ndarray) -> None:
        self._adj = build_motif_adjacency(social, rating)
        self._on_device = {}

    def graph(self, device) -> Tuple[torch.Tensor, ...]:
        """(H_s, H_j, H_p, R) on ``device``."""
        if self._adj is None:
            if not bool(self.config.hyper("demo_graph", False)):
                raise RuntimeError(
                    "MHCN needs the social/rating adjacency: call "
                    "set_graph(social, rating) before training, or set "
                    "hyper_parameters.demo_graph: true to train on a "
                    "random synthetic graph (tests/demos only)")
            rng = np.random.RandomState(0)
            social = (rng.rand(self.num_users, self.num_users) < 0.1).astype(np.float32)
            np.fill_diagonal(social, 0)
            rating = (rng.rand(self.num_users, self.num_items) < 0.1).astype(np.float32)
            self.set_graph(social, rating)
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = tuple(torch.from_numpy(m).to(device) for m in self._adj)
        return self._on_device[device]

    def model_inputs(self, batch):
        return self.graph(batch["users"].device)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {
            "users": rng.randint(0, self.num_users, batch_size).astype(np.int64),
            "pos_items": rng.randint(0, self.num_items, batch_size).astype(np.int64),
            "neg_items": rng.randint(0, self.num_items, batch_size).astype(np.int64),
        }

    def draw_perms(self, generator: torch.Generator) -> Perms:
        """Three (U, E, U) permutations, one triple per channel."""
        u, e, dev = self.num_users, self.emb_size, generator.device
        return [tuple(torch.randperm(n, generator=generator, device=dev) for n in (u, e, u))
                for _ in range(3)]

    @staticmethod
    def _hierarchical_ss(user_emb, adj, perm):
        """Local + global mutual-information loss of one channel."""
        p1, p2, p3 = perm
        edge = adj @ user_emb

        def score(a, b):
            return torch.sum(a * b, 1)

        row_shuf = user_emb[p1]
        rc = edge[:, p2][p3]
        neg1 = score(row_shuf, edge)
        local = torch.sum(-F.logsigmoid(score(user_emb, edge) - neg1)
                          - F.logsigmoid(neg1 - score(rc, user_emb)))
        graph = edge.mean(0)
        global_ = torch.sum(-F.logsigmoid(score(edge, graph) - score(rc, graph)))
        return local + global_

    def train_forward(self, module, batch, generator: Optional[torch.Generator] = None,
                      perms: Optional[Perms] = None):
        adj = self.model_inputs(batch)
        user_emb, item_emb, views = module(*adj)
        u = take_rows(user_emb, batch["users"], wrap=True)
        pos, neg = take_rows(item_emb, torch.cat([batch["pos_items"], batch["neg_items"]]),
                             wrap=True).split(batch["pos_items"].shape[0])
        score = torch.sum(u * (pos - neg), 1)
        rec_loss = -torch.sum(torch.log(torch.sigmoid(score) + 1e-7))
        if perms is None and generator is not None:
            perms = self.draw_perms(generator)
        ss_loss = rec_loss.new_zeros(())
        for gated, a, perm in zip(views, adj[:3], perms or ()):
            ss_loss = ss_loss + self._hierarchical_ss(gated, a, perm)
        loss = rec_loss + self.ss_rate * ss_loss
        return loss, {"rec_loss": rec_loss, "ss_loss": ss_loss}

    def user_item_embeddings(self, module) -> Tuple[torch.Tensor, torch.Tensor]:
        """The serving call: the final user (U, E) and item (I, E)
        embeddings."""
        with torch.no_grad():
            user_emb, item_emb, _ = module(*self.graph(module.user_embeddings.device))
        return user_emb, item_emb

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return MHCNDataset(list_data_files(data_dir), self.num_users, self.num_items,
                           batch_size, seed=int(self.config.runner("seed", 2023)))


class MHCNDataset:
    """``user item`` lines → (users, pos_items, neg_items) batches; see the
    module docstring."""

    def __init__(self, files, num_users, num_items, batch_size, seed=2023):
        self.files = list(files)
        self.num_users = num_users
        self.num_items = num_items
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)
        self._pairs = None

    def _read(self):
        pairs = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) < 2 or not all(t.lstrip("-").isdigit() for t in toks[:2]):
                        continue
                    pairs.append((int(toks[0]) % self.num_users, int(toks[1]) % self.num_items))
        return np.asarray(pairs, np.int64).reshape(-1, 2)

    def __iter__(self):
        if self._pairs is None:
            self._pairs = self._read()
        pairs, bs = self._pairs, self.batch_size
        for i in range(0, len(pairs), bs):
            users, pos = pairs[i:i + bs, 0], pairs[i:i + bs, 1]
            neg = (pos + self._rng.randint(1, self.num_items, len(pos))) % self.num_items
            yield {"users": users, "pos_items": pos, "neg_items": neg.astype(np.int64)}
