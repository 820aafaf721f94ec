"""TiSASRec: time-interval-aware self-attention for sequential
recommendation.

Counterpart of ``paddlerec_tpu/models/recall/tisas/model.py``, registered as
``recall.tisas``: the item table ``item_emb`` ((``item_num`` + 1) ×
``hidden_units``, 3,418 × 50 by default, row 0 the padding) scaled by √d,
absolute-position K and V tables (``maxlen`` × d) and time-interval K and V
tables ((``time_span`` + 1) × d) read at each user's (T, T) interval matrix
after ``clip(0, time_span)``; ``num_blocks`` pre-norm blocks of causal,
padding-masked time-aware attention (score ``QKᵀ + Q·posKᵀ + timeK·Q``, the
masked scores set to -2³¹; output ``A·V + A·posV + A·timeV``), LayerNorm at
eps 1e-8 and a two-layer ReLU feed-forward.  Training takes per-position
logits of the next item against a sampled negative, the sigmoid
cross-entropy over the positions with a positive; the AUC of both is logged
as ``auc``.  ``score_items`` scores candidate items against the last
position's feature: the serving call.

Five K1 launches a forward, five K1b a step: the item table once for the
history, the positives and the negatives together (N = 3·B·T; with
candidates, the history and the candidates together), each position table
at N = B·T, and each time-interval table at N = B·T², 80,000 ids at B = 32
and T = 50.

``TiSASDataset`` is a copy of the JAX package's reader (numpy only).
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
from paddlerec_tpu_torch.ops.layers import LayerNorm, flax_dense

NEG = -(2.0 ** 31)


class TimeAwareAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.heads, self.head_dim = heads, hidden // heads
        self.q = flax_dense(hidden, hidden, **kw)
        self.k = flax_dense(hidden, hidden, **kw)
        self.v = flax_dense(hidden, hidden, **kw)

    def forward(self, q_in, kv_in, pad_mask, time_k, time_v, pos_k, pos_v):
        """q_in, kv_in (B, T, D); pad_mask (B, T), 1 where valid; time_k,
        time_v (B, T, T, D); pos_k, pos_v (B, T, D)."""
        b, t, d = q_in.shape
        h, hd = self.heads, self.head_dim

        def split(x):  # (B, T, D) → (B, H, T, hd)
            return x.reshape(b, t, h, hd).transpose(1, 2)

        qh, kh, vh = split(self.q(q_in)), split(self.k(kv_in)), split(self.v(kv_in))
        pkh, pvh = split(pos_k), split(pos_v)
        tkh = time_k.reshape(b, t, t, h, hd).permute(0, 3, 1, 2, 4)
        tvh = time_v.reshape(b, t, t, h, hd).permute(0, 3, 1, 2, 4)
        scores = (torch.einsum("bhqd,bhkd->bhqk", qh, kh)
                  + torch.einsum("bhqd,bhkd->bhqk", qh, pkh)
                  + torch.einsum("bhqkd,bhqd->bhqk", tkh, qh)) / hd ** 0.5
        causal = torch.tril(torch.ones((t, t), device=q_in.device))
        valid = pad_mask[:, None, None, :] * causal
        att = torch.softmax(torch.where(valid > 0, scores, scores.new_tensor(NEG)), -1)
        out = (torch.einsum("bhqk,bhkd->bhqd", att, vh)
               + torch.einsum("bhqk,bhkd->bhqd", att, pvh)
               + torch.einsum("bhqk,bhqkd->bhqd", att, tvh))
        return out.transpose(1, 2).reshape(b, t, d)


class TiSASRecNet(nn.Module):
    def __init__(self, item_num: int, hidden: int = 50, maxlen: int = 50,
                 time_span: int = 256, num_blocks: int = 2, num_heads: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.hidden, self.time_span, self.num_blocks = hidden, time_span, num_blocks
        self.item_emb = Embed(item_num + 1, hidden, **kw)
        self.abs_pos_K_emb = Embed(maxlen, hidden, **kw)
        self.abs_pos_V_emb = Embed(maxlen, hidden, **kw)
        self.time_matrix_K_emb = Embed(time_span + 1, hidden, **kw)
        self.time_matrix_V_emb = Embed(time_span + 1, hidden, **kw)
        for i in range(num_blocks):
            setattr(self, f"att_ln_{i}", LayerNorm(hidden, eps=1e-8, device=device))
            setattr(self, f"att_{i}", TimeAwareAttention(hidden, num_heads, **kw))
            setattr(self, f"ffn_ln_{i}", LayerNorm(hidden, eps=1e-8, device=device))
            setattr(self, f"ffn_{i}_1", flax_dense(hidden, hidden, **kw))
            setattr(self, f"ffn_{i}_2", flax_dense(hidden, hidden, **kw))
        self.last_ln = LayerNorm(hidden, eps=1e-8, device=device)

    def seq2feats(self, seq_emb, log_seqs, time_matrices):
        d = self.hidden
        b, t = log_seqs.shape
        x = seq_emb * d ** 0.5
        positions = torch.arange(t, device=log_seqs.device).expand(b, t)
        pos_k, pos_v = self.abs_pos_K_emb(positions), self.abs_pos_V_emb(positions)
        tm = time_matrices.clamp(0, self.time_span)
        time_k, time_v = self.time_matrix_K_emb(tm), self.time_matrix_V_emb(tm)
        pad = (log_seqs != 0).to(x.dtype)
        x = x * pad[..., None]
        for i in range(self.num_blocks):
            q = getattr(self, f"att_ln_{i}")(x)
            x = q + getattr(self, f"att_{i}")(q, x, pad, time_k, time_v, pos_k, pos_v)
            x = getattr(self, f"ffn_ln_{i}")(x)
            ff = getattr(self, f"ffn_{i}_2")(F.relu(getattr(self, f"ffn_{i}_1")(x)))
            x = (x + ff) * pad[..., None]
        return self.last_ln(x)

    def forward(self, log_seqs, time_matrices, pos_seqs=None, neg_seqs=None,
                item_indices=None):
        """→ (pos_logits, neg_logits) (B, T), or with ``item_indices`` (B, I)
        the candidates' scores at the last position."""
        if item_indices is not None:
            seq_emb, cand = self.item_emb(log_seqs, item_indices)
            feats = self.seq2feats(seq_emb, log_seqs, time_matrices)
            return torch.einsum("bid,bd->bi", cand, feats[:, -1, :])
        seq_emb, pos, neg = self.item_emb(log_seqs, pos_seqs, neg_seqs)
        feats = self.seq2feats(seq_emb, log_seqs, time_matrices)
        return (feats * pos).sum(-1), (feats * neg).sum(-1)


@register_model("recall.tisas")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.item_num = int(h("item_num", 3417))
        self.maxlen = int(h("maxlen", 50))
        self.time_span = int(h("time_span", 256))
        self.hidden = int(h("hidden_units", 50))
        self.num_blocks = int(h("num_blocks", 2))
        self.num_heads = int(h("num_heads", 1))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return TiSASRecNet(self.item_num, self.hidden, self.maxlen, self.time_span,
                           self.num_blocks, self.num_heads, device=device,
                           generator=generator)

    def model_inputs(self, batch):
        return (batch["log_seqs"], batch["time_matrices"], batch["pos_seqs"],
                batch["neg_seqs"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.maxlen
        seqs = rng.randint(1, self.item_num + 1, (batch_size, t))
        seqs[:, :t // 2] = 0  # left-padded histories
        times = rng.randint(0, self.time_span, (batch_size, t, t))
        return {
            "log_seqs": seqs.astype(np.int64),
            "time_matrices": times.astype(np.int64),
            "pos_seqs": rng.randint(1, self.item_num + 1, (batch_size, t)).astype(np.int64),
            "neg_seqs": rng.randint(1, self.item_num + 1, (batch_size, t)).astype(np.int64),
        }

    def train_forward(self, module, batch):
        pos_logits, neg_logits = module(*self.model_inputs(batch))
        valid = (batch["pos_seqs"] != 0).float()
        per = -F.logsigmoid(pos_logits) - F.logsigmoid(-neg_logits)
        loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        preds = torch.cat([torch.sigmoid(pos_logits), torch.sigmoid(neg_logits)]).reshape(-1)
        labels = torch.cat([torch.ones_like(pos_logits),
                            torch.zeros_like(neg_logits)]).reshape(-1)
        return loss, {"predictions": preds, "labels": labels,
                      "mask": torch.cat([valid, valid]).reshape(-1)}

    @staticmethod
    def score_items(module, log_seqs, time_matrices, item_indices):
        """The serving call: (B, I) scores of candidate items from the last
        position."""
        return module(log_seqs, time_matrices, item_indices=item_indices)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return TiSASDataset(list_data_files(data_dir), self.item_num, self.maxlen,
                            self.time_span, batch_size)


class TiSASDataset:
    """TSV ``user item rating timestamp`` (the reference's movielens
    format).  Interactions are grouped per user in time order; each row
    holds the left-padded item history, the next-item positives, uniform
    negatives unequal to the positive, and the personalized time-relation
    matrix ``clip(|t_i - t_j| // min_gap, time_span - 1)``; users in sorted
    order, one ``RandomState(seed)`` an epoch."""

    def __init__(self, files, item_num, maxlen, time_span, batch_size, seed=2023):
        self.files = list(files)
        self.item_num = item_num
        self.maxlen = maxlen
        self.time_span = time_span
        self.batch_size = batch_size
        self.seed = seed

    def _row(self, events, rng):
        t = self.maxlen
        events.sort()
        seq = [(it % self.item_num) + 1 for _, it in events]
        ts = [e[0] for e in events]
        seq, ts = seq[-(t + 1):], ts[-(t + 1):]
        log = np.zeros(t, np.int64)
        pos = np.zeros(t, np.int64)
        tvec = np.full(t, ts[0], np.int64)
        n = len(seq) - 1
        log[t - n:] = seq[:-1]
        pos[t - n:] = seq[1:]
        tvec[t - n:] = ts[:-1]
        gaps = np.diff(sorted(set(ts)))
        min_gap = int(gaps.min()) if len(gaps) else 1
        rel = np.abs(tvec[:, None] - tvec[None, :]) // max(min_gap, 1)
        tmat = np.clip(rel, 0, self.time_span - 1).astype(np.int64)
        neg = np.where(
            pos > 0, ((pos - 1 + rng.randint(1, self.item_num, t)) % self.item_num) + 1, 0,
        ).astype(np.int64)
        return log, tmat, pos, neg

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        by_user = {}
        for path in self.files:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if len(toks) < 4:
                        continue
                    by_user.setdefault(toks[0], []).append((int(float(toks[3])), int(toks[1])))
        buf = []
        for user in sorted(by_user):
            if len(by_user[user]) < 2:
                continue
            buf.append(self._row(by_user[user], rng))
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf:
            yield self._batch(buf)

    @staticmethod
    def _batch(rows):
        log, tmat, pos, neg = (np.stack(x) for x in zip(*rows))
        return {"log_seqs": log, "time_matrices": tmat, "pos_seqs": pos, "neg_seqs": neg}
