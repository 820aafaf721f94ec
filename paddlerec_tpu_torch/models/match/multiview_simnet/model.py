"""Multiview-SimNet: multi-slot two-tower matching.

Counterpart of ``paddlerec_tpu/models/match/multiview_simnet/model.py``,
registered as ``match.multiview_simnet``: the query's and the title's slots
of token ids (``query_slots``, ``title_slots`` of ``max_len`` tokens) are
each pooled as a bag of words, ``emb(slots)·mask`` summed over the tokens,
from one shared table (``sparse_feature_number`` 89,777 × 128), flattened
over the slots and projected (``query_proj``, ``title_proj``, tanh); the
score is the cosine, trained with a pairwise hinge against the in-batch
negative (each query against the previous row's title).

Both views' bags come out of ONE K1 launch in ``fill`` mode with the mask as
weights (``Embed.pool``), the same function as flax's take, multiply and
sum; its gradient is one weighted K1b.

``MultiviewDataset`` is a copy of the JAX package's reader (numpy only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import (
    Aux, ModelDef as BaseModelDef, masked_mean, pair_metric,
)
from paddlerec_tpu_torch.models.match.dssm.model import cosine
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import flax_dense


class MultiviewSimnetNet(nn.Module):
    """Parameters ``embedding``, ``query_proj``, ``title_proj``; returns the
    query and title vectors (B, hidden)."""

    def __init__(self, vocab_size: int, emb_dim: int, hidden_size: int, query_slots: int,
                 title_slots: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.embedding = Embed(vocab_size, emb_dim, **kw)
        self.query_proj = flax_dense(query_slots * emb_dim, hidden_size, **kw)
        self.title_proj = flax_dense(title_slots * emb_dim, hidden_size, **kw)

    def forward(self, q_slots, q_mask, t_slots, t_mask):
        b, t = q_slots.shape[0], q_slots.shape[-1]
        nq = q_slots.numel() // t
        bags = self.embedding.pool(
            torch.cat([q_slots.reshape(-1, t), t_slots.reshape(-1, t)]),
            torch.cat([q_mask.reshape(-1, t), t_mask.reshape(-1, t)]))
        q = torch.tanh(self.query_proj(bags[:nq].reshape(b, -1)))
        title = torch.tanh(self.title_proj(bags[nq:].reshape(b, -1)))
        return q, title


@register_model("match.multiview_simnet")
class ModelDef(BaseModelDef):
    metric_names = ("pnr",)

    def __init__(self, config):
        super().__init__(config)
        self.vocab_size = int(
            config.hyper("sparse_feature_number", config.hyper("vocab_size", 89777)))
        self.query_slots = int(config.hyper("query_slots", 1))
        self.title_slots = int(config.hyper("title_slots", 1))
        self.max_len = int(config.hyper("max_len", 8))
        self.margin = float(config.hyper("margin", 0.1))
        self.emb_dim = int(config.hyper("embedding_dim", 128))
        self.hidden_size = int(config.hyper("hidden_size", 128))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return MultiviewSimnetNet(self.vocab_size, self.emb_dim, self.hidden_size,
                                  self.query_slots, self.title_slots, device=device,
                                  generator=generator)

    def model_inputs(self, batch):
        return (batch["q_slots"], batch["q_mask"], batch["t_slots"], batch["t_mask"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)

        def slots(s):
            ids = rng.randint(1, self.vocab_size, (batch_size, s, self.max_len)).astype(np.int32)
            m = (rng.rand(batch_size, s, self.max_len) < 0.8).astype(np.float32)
            m[:, :, 0] = 1
            return ids, m

        q, qm = slots(self.query_slots)
        t, tm = slots(self.title_slots)
        return {"q_slots": q, "q_mask": qm, "t_slots": t, "t_mask": tm,
                "mask": np.ones(batch_size, np.float32)}

    def train_forward(self, module, batch):
        q, t = module(*self.model_inputs(batch))
        pos = cosine(q, t)
        # the in-batch negative: the previous row's title
        neg = cosine(q, torch.roll(t, shifts=1, dims=0))
        per = torch.clamp(self.margin - pos + neg, min=0.0)
        mask = batch.get("mask")
        aux: Aux = {"sim_pos": pos, "sim_neg": neg[:, None]}
        if mask is None:
            return per.mean(), aux
        # a rolled negative is only real if its own row is too
        neg_mask = mask * torch.roll(mask, shifts=1, dims=0)
        aux["mask"] = mask
        aux["neg_mask"] = neg_mask
        return masked_mean(per, neg_mask), aux

    def metric_updates(self, aux):
        return {"pnr": pair_metric((aux["sim_pos"] + 1.0) / 2.0,
                                   (aux["sim_neg"] + 1.0) / 2.0, aux.get("mask"),
                                   aux.get("neg_mask"))}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return MultiviewDataset(list_data_files(data_dir), self.query_slots,
                                self.title_slots, self.max_len, batch_size)


class MultiviewDataset:
    """Lines ``q_tokens...<TAB>t_tokens...``, slots separated by ``;`` and
    tokens by spaces, each slot cut to ``max_len``; the tail batch is padded
    with zero rows and ``mask`` 0."""

    def __init__(self, files, query_slots, title_slots, max_len, batch_size):
        self.files = files
        self.query_slots = query_slots
        self.title_slots = title_slots
        self.max_len = max_len
        self.batch_size = batch_size

    def __iter__(self):
        bs, t = self.batch_size, self.max_len
        q = np.zeros((bs, self.query_slots, t), np.int32)
        qm = np.zeros((bs, self.query_slots, t), np.float32)
        ti = np.zeros((bs, self.title_slots, t), np.int32)
        tm = np.zeros((bs, self.title_slots, t), np.float32)
        row = 0
        for path in self.files:
            with open(path) as f:
                for line in f:
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 2:
                        continue
                    for dst, dstm, spec, n_slots in (
                        (q, qm, cols[0], self.query_slots),
                        (ti, tm, cols[1], self.title_slots),
                    ):
                        for si, slot in enumerate(spec.split(";")[:n_slots]):
                            toks = [int(x) for x in slot.split()][:t]
                            dst[row, si, : len(toks)] = toks
                            dstm[row, si, : len(toks)] = 1.0
                    row += 1
                    if row == bs:
                        yield {
                            "q_slots": q.copy(), "q_mask": qm.copy(),
                            "t_slots": ti.copy(), "t_mask": tm.copy(),
                            "mask": np.ones(bs, np.float32),
                        }
                        q[:] = 0
                        qm[:] = 0
                        ti[:] = 0
                        tm[:] = 0
                        row = 0
        if row:
            mask = np.zeros(bs, np.float32)
            mask[:row] = 1.0
            yield {
                "q_slots": q.copy(), "q_mask": qm.copy(),
                "t_slots": ti.copy(), "t_mask": tm.copy(),
                "mask": mask,
            }
