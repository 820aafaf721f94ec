"""TagSpace: text to tag matching with a margin ranking loss.

Counterpart of ``paddlerec_tpu/models/contentunderstanding/tagspace/model.py``,
registered as ``contentunderstanding.tagspace``: token embeddings
(``text_emb``, ``vocab_text_size`` 75,378 × 10) masked by ``seq_mask``, a
``SAME`` conv of width ``win_size`` 5 to ``hid_dim`` 1,000 with tanh, a max
over time where the mask is set (-1e9 elsewhere), a tanh projection
(``proj``) to the text vector, and its dot products with the embeddings of
the positive tag and of ``neg_size`` negative tags (``tag_emb``, 4 × 10),
trained with ``Σ max(0, margin - pos + neg)`` over the negatives.

Two K1 launches a forward: the words, and the tag table read once for the
positive and the negatives together (``Embed(pos_tag, neg_tags)``: 32 + 96
ids onto 4 rows at batch 32); two K1b a step.  The metric is logged as
``pnr``: the AUC of the sigmoid similarities, positives against negatives.

``TagSpaceDataset`` is a copy of the JAX package's reader (numpy only): its
negatives are ``(pos + randint(1, vocab_tag)) % vocab_tag`` from
``RandomState(seed)``, the same draws as the JAX reader's.
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
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import SameConv1d, flax_dense, masked_max


class TagSpaceNet(nn.Module):
    """Parameters ``text_emb``, ``tag_emb``, ``conv``, ``proj``; returns
    (pos_sim (B,), neg_sim (B, N))."""

    def __init__(self, vocab_text_size: int, vocab_tag_size: int, emb_dim: int,
                 hid_dim: int, win_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.text_emb = Embed(vocab_text_size, emb_dim, **kw)
        self.tag_emb = Embed(vocab_tag_size, emb_dim, **kw)
        self.conv = SameConv1d(emb_dim, hid_dim, win_size, **kw)
        self.proj = flax_dense(hid_dim, emb_dim, **kw)

    def forward(self, tokens, seq_mask, pos_tag, neg_tags):
        x = self.text_emb(tokens) * seq_mask[..., None]
        pooled = masked_max(torch.tanh(self.conv(x)), seq_mask)
        text_vec = torch.tanh(self.proj(pooled))
        pos, neg = self.tag_emb(pos_tag, neg_tags)
        return (text_vec * pos).sum(-1), torch.einsum("be,bne->bn", text_vec, neg)


@register_model("contentunderstanding.tagspace")
class ModelDef(BaseModelDef):
    metric_names = ("pnr",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.vocab_text_size = int(h("vocab_text_size", 75378))
        self.vocab_tag_size = int(h("vocab_tag_size", 4))
        self.neg_size = int(h("neg_size", 3))
        self.margin = float(h("margin", 0.1))
        self.max_len = int(h("max_len", 32))
        self.emb_dim = int(h("emb_dim", 10))
        self.hid_dim = int(h("hid_dim", 1000))
        self.win_size = int(h("win_size", 5))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return TagSpaceNet(self.vocab_text_size, self.vocab_tag_size, self.emb_dim,
                           self.hid_dim, self.win_size, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["tokens"], batch["seq_mask"], batch["pos_tag"], batch["neg_tags"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.max_len
        lens = rng.randint(1, t + 1, batch_size)
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        return {
            "tokens": (rng.randint(0, self.vocab_text_size, (batch_size, t))
                       * seq_mask).astype(np.int32),
            "seq_mask": seq_mask,
            "pos_tag": rng.randint(0, self.vocab_tag_size, batch_size).astype(np.int32),
            "neg_tags": rng.randint(0, self.vocab_tag_size,
                                    (batch_size, self.neg_size)).astype(np.int32),
            "mask": np.ones(batch_size, np.float32),
        }

    def train_forward(self, module, batch):
        pos_sim, neg_sim = module(*self.model_inputs(batch))
        per = torch.clamp(self.margin - pos_sim[:, None] + neg_sim, min=0.0).sum(-1)
        mask = batch.get("mask")
        aux: Aux = {"pos_sim": pos_sim, "neg_sim": neg_sim}
        if mask is not None:
            aux["mask"] = mask
        return masked_mean(per, mask), aux

    def metric_updates(self, aux):
        return {"pnr": pair_metric(torch.sigmoid(aux["pos_sim"]),
                                   torch.sigmoid(aux["neg_sim"]), aux.get("mask"))}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return TagSpaceDataset(list_data_files(data_dir), self.vocab_tag_size,
                               self.neg_size, self.max_len, batch_size)


class TagSpaceDataset:
    """Lines ``tok tok ...<TAB>tag``; tokens cut to ``max_len``; a line
    without a tab skipped; the tail batch padded to the batch with ``mask``
    0.  Each batch draws its negative tags, the padded rows' too."""

    def __init__(self, files, vocab_tag, neg_size, max_len, batch_size, seed=0):
        self.files = files
        self.vocab_tag = vocab_tag
        self.neg_size = neg_size
        self.max_len = max_len
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        bs, t = self.batch_size, self.max_len
        rows = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    toks = [int(x) for x in parts[0].split()][:t]
                    tag = int(parts[1].split()[0])
                    rows.append((toks, tag))
                    if len(rows) == bs:
                        yield self._emit(rows)
                        rows = []
        if rows:
            yield self._emit(rows, pad_to=bs)

    def _emit(self, rows, pad_to=None):
        bs = pad_to or len(rows)
        t = self.max_len
        tokens = np.zeros((bs, t), np.int32)
        seq_mask = np.zeros((bs, t), np.float32)
        pos = np.zeros((bs,), np.int32)
        mask = np.zeros((bs,), np.float32)
        for r, (toks, tag) in enumerate(rows):
            tokens[r, : len(toks)] = toks
            seq_mask[r, : len(toks)] = 1.0
            pos[r] = tag
            mask[r] = 1.0
        return {
            "tokens": tokens,
            "seq_mask": seq_mask,
            "pos_tag": pos,
            # the offset keeps every negative off the positive
            "neg_tags": ((pos[:, None]
                          + self.rng.randint(1, self.vocab_tag, (bs, self.neg_size)))
                         % self.vocab_tag).astype(np.int32),
            "mask": mask,
        }
