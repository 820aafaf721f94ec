"""KIM: knowledge-aware interactive matching for news recommendation.

Counterpart of ``paddlerec_tpu/models/match/kim/model.py``, registered as
``match.kim``, with its parameter tree:
  * the title encoder (``title_word_embedding`` 1,891 × 300, a width-3
    ``SAME`` conv to 400 channels plus a 20 × 20-head self-attention, each
    with a ReLU, summed);
  * the word-level co-attention of every clicked title with the candidate's
    title, its cross terms scaled by 0.001;
  * the entity level: for each clicked news, the user's entity graph (10
    zero-hop entities and 10 × 10 one-hop neighbours of 100-d KG vectors)
    co-attends with the candidate's through ``GraphCoAttNet`` twice
    (``PairGraph``);
  * the news-level co-attention over the 50 clicked news, cross terms scaled
    by 0.01, and the dot product of the user and news vectors;
  * 1 + ``npratio`` candidates a row, trained with the softmax
    cross-entropy of ``labels`` (B, C); the AUC over every candidate's
    sigmoid score is logged as ``auc``.
``heads = 20 if hidden_size % 20 == 0 else 4``, as in the JAX package.  The
JAX package's two reproduced slips of the reference (``news_can`` fused from
the news' own zero hop, the news side of the news-level attention through
``match_fc2``) are kept, in its intended form.

The JAX module scores the candidates one ``PairScorer`` call each, and each
call re-encodes the 50 clicked titles and each clicked news' entity graph.
The port encodes every title once, runs the part of ``PairGraph`` that sees
one news alone (``PairGraph.side``: the entity encoder over its one-hop
neighbours, ``gat_fuse``) once per clicked news and once per candidate, and
scores every candidate in one batched pass (a candidate axis ``c`` in the
products): the same function.  Every lookup of the word table in a forward,
the clicked titles' and the candidates', is ONE ``Embed`` call: one K1
launch a forward, one K1b a step (about 50,000 ids a batch of 32 onto 1,891
rows).

``KIMDataset`` is a copy of the JAX package's reader (numpy only).  A batch
of 32 holds 32 × 50 × 10 × 10 × 100 floats of clicked one-hop vectors (64
MB): serve it at batch 32.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef, masked_mean
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import SameConv1d, flax_dense

ENT_DIM = 100  # the KG entity vectors' width (fixed in the reference)
# the spread of the entity vectors of ``example_batch``: entries of about
# ±0.1, as 100-d TransE vectors of a knowledge graph have.  The JAX package
# draws standard normals, which at the default widths give initial scores of
# up to ~230 and a loss of ~74, where float32 holds a loss to ~1e-5 only.
EXAMPLE_KG_SCALE = 0.1


class SelfAttention(nn.Module):
    """``heads`` × ``head_dim`` multi-head attention with bias-free ``wq``,
    ``wk``, ``wv`` over ``in_dim`` inputs: q, k, v (B, T, in) → (B, T,
    heads·head_dim)."""

    def __init__(self, in_dim: int, heads: int, head_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        kw = {"device": device, "generator": generator, "bias": False}
        self.wq = flax_dense(in_dim, heads * head_dim, **kw)
        self.wk = flax_dense(in_dim, heads * head_dim, **kw)
        self.wv = flax_dense(in_dim, heads * head_dim, **kw)

    def forward(self, q, k, v):
        b, t, _ = q.shape
        h, hd = self.heads, self.head_dim

        def split(x):
            return x.reshape(b, -1, h, hd).transpose(1, 2)

        a = torch.einsum("bhqd,bhkd->bhqk", split(self.wq(q)), split(self.wk(k))) / hd ** 0.5
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(a, -1), split(self.wv(v)))
        return o.transpose(1, 2).reshape(b, t, h * hd)


class AttentivePooling(nn.Module):
    """``fc2(tanh(fc1(x)))`` softmax weights over the N axis: (..., N, D) →
    (..., D)."""

    def __init__(self, dim: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = flax_dense(dim, 200, device=device, generator=generator)
        self.fc2 = flax_dense(200, 1, device=device, generator=generator)

    def forward(self, x):
        a = torch.softmax(self.fc2(torch.tanh(self.fc1(x))), dim=-2)
        return (x * a).sum(-2)


class GraphCoAttNet(nn.Module):
    """Self-attend the entities (the first half of the N axis), co-attend
    with the candidates (the second half): (B, 2N, 100) → (B, 100)."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.attn = SelfAttention(ENT_DIM, 5, 20, **kw)
        for name in ("d1", "d2", "d3"):
            self.add_module(name, flax_dense(ENT_DIM, ENT_DIM, **kw))
        self.d5 = flax_dense(ENT_DIM, 1, **kw)

    def forward(self, x):
        ent, cand = torch.chunk(x, 2, dim=-2)
        ev = self.attn(ent, ent, ent)
        s = torch.einsum("bnd,bmd->bnm", self.d1(ev), self.d2(cand))
        att = torch.tanh(self.d3(ev) + torch.einsum("bnm,bmd->bnd", s, cand))
        return (ev * self.d5(att)).sum(-2)


class PairGraph(nn.Module):
    """Entity-graph matching of (clicked news, candidate news) pairs: (B,
    2·(E²+E), 100), the user's one-hop then zero-hop vectors and the news'
    the same → (B, 200), the user's then the news' vector.  ``side`` is the
    part of one news alone (its hops and their fused vectors), ``pair`` the
    rest, so that a caller can run ``side`` once per news and pair the
    results."""

    def __init__(self, max_entity: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.max_entity = max_entity
        self.entity_encoder = AttentivePooling(ENT_DIM, **kw)
        self.gat_fuse = flax_dense(2 * ENT_DIM, ENT_DIM, **kw)
        self.gcat = GraphCoAttNet(**kw)
        self.merge = flax_dense(2 * ENT_DIM, ENT_DIM, **kw)
        self.gcat0 = GraphCoAttNet(**kw)

    def side(self, graph):
        """(N, E²+E, 100) → the one-hop (N, E, E, 100) and zero-hop (N, E,
        100) vectors and their fused vectors (N, E, 100)."""
        e, n = self.max_entity, graph.shape[0]
        onehop, zerohop = graph[:, : e * e].reshape(n, e, e, ENT_DIM), graph[:, e * e:]
        pooled = self.entity_encoder(onehop.reshape(n * e, e, ENT_DIM)).reshape(n, e, ENT_DIM)
        return onehop, zerohop, self.gat_fuse(torch.cat([pooled, zerohop], -1))

    def pair(self, user, news):
        """``side``'s triples of the user's and the news' graphs, of one
        leading size N → (N, 200)."""
        e = self.max_entity
        (u_one, u_zero, u_fused), (n_one, n_zero, n_fused) = user, news
        b = u_one.shape[0]

        def graph_match(onehop, other_fused):
            # every entity row sees the full fused set of the other side
            joined = torch.cat([onehop, other_fused[:, None].expand(b, e, e, ENT_DIM)], -2)
            return self.gcat(joined.reshape(b * e, 2 * e, ENT_DIM)).reshape(b, e, ENT_DIM)

        u_vecs = self.merge(torch.cat([u_zero, graph_match(u_one, n_fused)], -1))
        n_vecs = self.merge(torch.cat([n_zero, graph_match(n_one, u_fused)], -1))
        u_vec = self.gcat0(torch.cat([u_vecs, n_zero], -2))
        n_vec = self.gcat0(torch.cat([n_vecs, u_zero], -2))
        return torch.cat([u_vec, n_vec], -1)

    def forward(self, x):
        user_in, news_in = torch.chunk(x, 2, dim=-2)
        return self.pair(self.side(user_in), self.side(news_in))


class PairScorer(nn.Module):
    """The JAX package's ``PairScorer`` parameters (``title_word_embedding``,
    ``conv``, ``word_attn``, ``attn_fc1``, ``attn_fc2``, ``pair_graph``,
    ``merge_layer``, ``match_fc1``, ``match_fc2``, ``match_reduce``); it
    scores C candidates against one click history at once (``score``)."""

    def __init__(self, vocab_size: int, embedding_size: int, hidden_size: int,
                 max_entity: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.hidden_size = hidden_size
        self.title_word_embedding = Embed(vocab_size, embedding_size, **kw)
        self.conv = SameConv1d(embedding_size, hidden_size, 3, **kw)
        heads = 20 if hidden_size % 20 == 0 else 4
        self.word_attn = SelfAttention(embedding_size, heads, hidden_size // heads, **kw)
        self.attn_fc1 = flax_dense(hidden_size, 200, **kw)
        self.attn_fc2 = flax_dense(200, 1, **kw)
        self.pair_graph = PairGraph(max_entity, **kw)
        self.merge_layer = flax_dense(hidden_size + ENT_DIM, hidden_size, **kw)
        self.match_fc1 = flax_dense(hidden_size, ENT_DIM, **kw)
        self.match_fc2 = flax_dense(ENT_DIM, 1, **kw)
        self.match_reduce = flax_dense(hidden_size, ENT_DIM, **kw)

    def encode(self, wv):
        """Word vectors (N, W, emb) → (N, W, hidden)."""
        return torch.relu(self.conv(wv)) + torch.relu(self.word_attn(wv, wv, wv))

    def score(self, clicked_wv, candi_wv, clicked_graph, news_graph):
        """clicked_wv (B, S, W, H), candi_wv (B, C, W, H), clicked_graph (B,
        S, E²+E, 100), news_graph (B, C, E²+E, 100) → scores (B, C)."""
        b, s = clicked_wv.shape[:2]
        c = candi_wv.shape[1]
        clicked_av = torch.tanh(self.attn_fc1(clicked_wv))  # (B, S, W, 200)
        clicked_att0 = self.attn_fc2(clicked_av)[..., 0]  # (B, S, W)
        candi_av = torch.tanh(self.attn_fc1(candi_wv))  # (B, C, V, 200)
        candi_att0 = self.attn_fc2(candi_av)[..., 0]  # (B, C, V)

        # word-level cross attention
        cross = torch.einsum("bswd,bcvd->bcswv", clicked_av, candi_av)
        cross_candi = torch.softmax(cross, -1) @ candi_att0[:, :, None, :, None]
        clicked_att = torch.softmax(clicked_att0[:, None] + cross_candi[..., 0] * 0.001, -1)
        cross_click = (cross.transpose(-1, -2) * clicked_att[..., None, :]).sum(-1) * 0.001
        candi_att = torch.softmax(candi_att0[:, :, None, :] + cross_click, -1)  # (B,C,S,V)
        candi_title_vecs = torch.einsum("bcsv,bcvd->bcsd", candi_att, candi_wv)
        clicked_title_vecs = torch.einsum("bcsw,bswd->bcsd", clicked_att, clicked_wv)

        # the entity graphs of every (clicked news, candidate) pair: each
        # news' own part once, then every pair
        g = clicked_graph.shape[-2]
        user = self.pair_graph.side(clicked_graph.reshape(b * s, g, ENT_DIM))
        news = self.pair_graph.side(news_graph.reshape(b * c, g, ENT_DIM))
        user = [t.reshape(b, 1, s, *t.shape[1:]).expand(b, c, s, *t.shape[1:])
                .reshape(b * c * s, *t.shape[1:]) for t in user]
        news = [t.reshape(b, c, 1, *t.shape[1:]).expand(b, c, s, *t.shape[1:])
                .reshape(b * c * s, *t.shape[1:]) for t in news]
        pair_out = self.pair_graph.pair(user, news)
        user_ent, news_ent = torch.chunk(pair_out.reshape(b, c, s, 2 * ENT_DIM), 2, dim=-1)
        user_vecs = self.merge_layer(torch.cat([clicked_title_vecs, user_ent], -1))
        news_vecs = self.merge_layer(torch.cat([candi_title_vecs, news_ent], -1))

        # news-level co-attention
        u_att1 = self.match_fc2(torch.tanh(self.match_fc1(user_vecs)))  # (B, C, S, 1)
        n_att1 = self.match_fc2(torch.tanh(self.match_fc1(news_vecs)))
        cross2 = torch.einsum("bcsd,bctd->bcst", self.match_reduce(user_vecs),
                              self.match_reduce(news_vecs))
        u_att = torch.softmax(
            u_att1[..., 0] + (torch.softmax(cross2, -1) @ n_att1)[..., 0] * 0.01, -1)
        n_att = torch.softmax(
            n_att1[..., 0]
            + (torch.softmax(cross2.transpose(-1, -2), -1) @ u_att1)[..., 0] * 0.01, -1)
        user_vec = torch.einsum("bcs,bcsd->bcd", u_att, user_vecs)
        news_vec = torch.einsum("bcs,bcsd->bcd", n_att, news_vecs)
        return (user_vec * news_vec).sum(-1)


class KIMNet(nn.Module):
    """Parameters under ``pair_model``; titles (B, C, W), entities (B, C,
    E, 100), one_hops (B, C, E, E, 100), clicked_title (B, S, W),
    clicked_entity (B, S, E, 100), clicked_one_hop (B, S, E, E, 100) →
    scores (B, C)."""

    def __init__(self, vocab_size: int, embedding_size: int, hidden_size: int,
                 max_entity: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_entity = max_entity
        self.pair_model = PairScorer(vocab_size, embedding_size, hidden_size, max_entity,
                                     device=device, generator=generator)

    def forward(self, titles, entities, one_hops, clicked_title, clicked_entity,
                clicked_one_hop):
        pm, e = self.pair_model, self.max_entity
        b, c, w = titles.shape
        s = clicked_title.shape[1]
        clicked_w, candi_w = pm.title_word_embedding(clicked_title.reshape(b * s, w),
                                                     titles.reshape(b * c, w))
        clicked_wv = pm.encode(clicked_w).reshape(b, s, w, pm.hidden_size)
        candi_wv = pm.encode(candi_w).reshape(b, c, w, pm.hidden_size)
        clicked_graph = torch.cat([clicked_one_hop.reshape(b, s, e * e, ENT_DIM),
                                   clicked_entity], -2)
        news_graph = torch.cat([one_hops.reshape(b, c, e * e, ENT_DIM), entities], -2)
        return pm.score(clicked_wv, candi_wv, clicked_graph, news_graph)


@register_model("match.kim")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.vocab_size = int(h("vocab_size", 1891))
        self.max_sents = int(h("max_sents", 50))
        self.max_sentence = int(h("max_sentence", 30))
        self.max_entity = int(h("max_entity_num", 10))
        self.npratio = int(h("npratio", 4))
        self.embedding_size = int(h("embedding_size", 300))
        self.hidden_size = int(h("hidden_size", 400))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return KIMNet(self.vocab_size, self.embedding_size, self.hidden_size,
                      self.max_entity, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["titles"], batch["entities"], batch["one_hops"],
                batch["clicked_title"], batch["clicked_entity"], batch["clicked_one_hop"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        c = 1 + self.npratio
        s, w, e = self.max_sents, self.max_sentence, self.max_entity
        labels = np.zeros((batch_size, c), np.float32)
        labels[:, 0] = 1.0

        def kg(*shape):
            return (rng.randn(*shape, ENT_DIM) * EXAMPLE_KG_SCALE).astype(np.float32)

        return {
            "titles": rng.randint(0, self.vocab_size, (batch_size, c, w)).astype(np.int64),
            "entities": kg(batch_size, c, e),
            "one_hops": kg(batch_size, c, e, e),
            "clicked_title": rng.randint(0, self.vocab_size, (batch_size, s, w)).astype(np.int64),
            "clicked_entity": kg(batch_size, s, e),
            "clicked_one_hop": kg(batch_size, s, e, e),
            "labels": labels,
        }

    def _aux(self, scores, batch) -> Aux:
        aux: Aux = {"predictions": torch.sigmoid(scores).reshape(-1),
                    "labels": batch["labels"].to(torch.float32).reshape(-1)}
        if "mask" in batch:
            aux["mask"] = batch["mask"][:, None].expand(-1, scores.shape[1]).reshape(-1)
        return aux

    def train_forward(self, module, batch):
        scores = module(*self.model_inputs(batch))
        labels = batch["labels"].to(torch.float32)
        per = -(labels * torch.log_softmax(scores, -1)).sum(-1)
        return masked_mean(per, batch.get("mask")), self._aux(scores, batch)

    def infer_forward(self, module, batch):
        # the loss is left out, as XLA drops it from the JAX package's
        return self._aux(module(*self.model_inputs(batch)), batch)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return KIMDataset(self, data_dir, list_data_files(data_dir), batch_size)


class KIMDataset:
    """The news-matching reader over numeric files.  The data directory
    holds

      news.tsv       ``news_id<TAB>tok tok ...<TAB>ent ent ...``
      graph.tsv      ``ent neigh neigh ...``      (one-hop KG neighbours)
      entity_emb.npy (num_entities, 100) float32  (KG entity vectors)
      behaviors*     ``clicked,ids<TAB>pos<TAB>neg,neg,...``

    Each behavior row becomes 1 + npratio candidates (the positive first,
    ``labels[:, 0] = 1``), the real negatives cycled up to ``npratio``; rows
    whose positive is unknown or that have no known click or negative are
    skipped; titles padded to ``max_sentence`` tokens (ids mod the
    vocabulary), entity sets to ``max_entity`` (ids mod the entity count),
    each entity's one-hop tensor gathered from its neighbours' vectors; the
    last ``max_sents`` clicks kept; the tail batch padded with ``mask``
    0."""

    def __init__(self, md, data_dir, files, batch_size):
        self.md = md
        self.batch_size = batch_size
        self.behaviors = [f for f in files if os.path.basename(f).startswith("behaviors")]
        root = data_dir
        self.emb = np.load(os.path.join(root, "entity_emb.npy")).astype(np.float32)
        e, w = md.max_entity, md.max_sentence
        self.news = {}
        with open(os.path.join(root, "news.tsv")) as f:
            for line in f:
                nid, toks, ents = line.rstrip("\n").split("\t")
                title = np.zeros(w, np.int64)
                tt = [int(x) % md.vocab_size for x in toks.split()][:w]
                title[: len(tt)] = tt
                ent = np.zeros(e, np.int64)
                ee = [int(x) % len(self.emb) for x in ents.split()][:e]
                ent[: len(ee)] = ee
                self.news[nid] = (title, ent)
        self.graph = {}
        with open(os.path.join(root, "graph.tsv")) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                nb = np.zeros(e, np.int64)
                ns = [int(x) % len(self.emb) for x in toks[1:]][:e]
                nb[: len(ns)] = ns
                self.graph[int(toks[0]) % len(self.emb)] = nb

    def _news_feats(self, nid):
        title, ent = self.news[nid]
        e = self.md.max_entity
        vecs = self.emb[ent]
        zero = np.zeros(e, np.int64)
        hops = self.emb[np.stack([self.graph.get(int(x), zero) for x in ent])]
        return title, ent, vecs, hops

    def __iter__(self):
        md = self.md
        c, s = 1 + md.npratio, md.max_sents
        buf = []
        for path in self.behaviors:
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 3:
                        continue
                    clicked = [x for x in parts[0].split(",") if x in self.news]
                    negs = [x for x in parts[2].split(",") if x in self.news]
                    if parts[1] not in self.news or not clicked or not negs:
                        continue
                    negs = (negs * md.npratio)[: md.npratio]
                    cands = ([parts[1]] + negs)[:c]
                    buf.append((clicked[-s:], cands))
                    if len(buf) == self.batch_size:
                        yield self._batch(buf, self.batch_size)
                        buf = []
        if buf:
            yield self._batch(buf, self.batch_size)

    def _batch(self, rows, batch_size=None):
        md = self.md
        n = batch_size or len(rows)
        c, s = 1 + md.npratio, md.max_sents
        e, w, d = md.max_entity, md.max_sentence, self.emb.shape[1]
        out = {
            "titles": np.zeros((n, c, w), np.int64),
            "entities": np.zeros((n, c, e, d), np.float32),
            "one_hops": np.zeros((n, c, e, e, d), np.float32),
            "clicked_title": np.zeros((n, s, w), np.int64),
            "clicked_entity": np.zeros((n, s, e, d), np.float32),
            "clicked_one_hop": np.zeros((n, s, e, e, d), np.float32),
            "labels": np.zeros((n, c), np.float32),
        }
        out["labels"][: len(rows), 0] = 1.0
        out["mask"] = np.zeros((n,), np.float32)
        out["mask"][: len(rows)] = 1.0
        for i, (clicked, cands) in enumerate(rows):
            for j, nid in enumerate(cands):
                title, _, vecs, hops = self._news_feats(nid)
                out["titles"][i, j] = title
                out["entities"][i, j] = vecs
                out["one_hops"][i, j] = hops
            for j, nid in enumerate(clicked):
                title, _, vecs, hops = self._news_feats(nid)
                out["clicked_title"][i, j] = title
                out["clicked_entity"][i, j] = vecs
                out["clicked_one_hop"][i, j] = hops
        return out
