"""DSIN: deep session interest network (Alimama display-ad CTR).

Counterpart of ``paddlerec_tpu/models/rank/dsin/model.py``, registered as
``rank.dsin``: 15 profile, ad and context fields, each its own table of
width 4 (the category and brand tables shared with the session sequences);
a session-interest extractor (sinusoidal positions + one transformer block of
8 heads of width 1 over all sessions at once, the masked mean over time); a
2-layer BiLSTM over the 5 session vectors, forward and backward halves
averaged; DIN-style attention of both against the ad's category + brand
query; a ReLU MLP [200, 80] and a head over [field embeddings, both pooled
interests, price].  15 K1 launches a forward, 15 K1b a step: the category and
brand tables each serve the field and the sessions in one lookup.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import LogitModelDef
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import MLP, TargetAttention, flax_dense
from paddlerec_tpu_torch.ops.sequence import (
    BiLSTM, TransformerBlock, positions, sinusoidal_position_encoding,
)

# sparse_input column order (the reference's net.py:255-269)
FIELDS = (
    "user", "adgroup", "pid", "cms_segid", "cms_group", "gender", "age",
    "pvalue", "shopping", "occupation", "new_user_class", "campaign",
    "customer", "cate", "brand",
)
CATE, BRAND = FIELDS.index("cate"), FIELDS.index("brand")


class DSINNet(nn.Module):
    """Parameters: ``<field>_emb`` for each of ``FIELDS``,
    ``sess_transformer``, ``bilstm.{fwd,bwd}_{0,1}``,
    ``{tr,lstm}_actpool.att_mlp.fc_i``, ``mlp.fc_i``, ``head``."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 4,
                 att_embedding_size: int = 8, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        for name, v in zip(FIELDS, vocab_sizes):
            self.add_module(f"{name}_emb", Embed(v, embed_dim, **kw))
        d = 2 * embed_dim
        self.sess_transformer = TransformerBlock(
            d, 8, max(att_embedding_size // 8, 1), 64, **kw)
        self.bilstm = BiLSTM(d, d, num_layers=2, **kw)
        self.tr_actpool = TargetAttention(d, (64, 16), use_softmax=True, **kw)
        self.lstm_actpool = TargetAttention(d, (64, 16), use_softmax=True, **kw)
        self.mlp = MLP(len(FIELDS) * embed_dim + 2 * d + 1, [200, 80], **kw)
        self.head = flax_dense(80, 1, **kw)

    def forward(self, sparse, price, sess_input, sess_length):
        """sparse (B, 15) ids; price (B,); sess_input (B, 2·S, L): rows ::2
        are category ids, rows 1::2 brand ids; sess_length (B,) sessions."""
        field_embs = [None] * len(FIELDS)
        for i, name in enumerate(FIELDS):
            if i not in (CATE, BRAND):
                field_embs[i] = getattr(self, f"{name}_emb")(sparse[:, i])
        field_embs[CATE], cate_sess = self.cate_emb(sparse[:, CATE], sess_input[:, ::2, :])
        field_embs[BRAND], brand_sess = self.brand_emb(sparse[:, BRAND],
                                                       sess_input[:, 1::2, :])
        deep_input = torch.cat(field_embs, dim=-1)
        query = torch.cat([field_embs[CATE], field_embs[BRAND]], dim=-1)
        tr_input = torch.cat([cate_sess, brand_sess], dim=-1)  # (B, S, L, 8)

        b, s, length, d = tr_input.shape
        # pad positions (category id 0) neither attend nor pool
        flat_mask = (sess_input[:, ::2, :] > 0).to(tr_input.dtype).reshape(b * s, length)
        flat = tr_input.reshape(b * s, length, d) + sinusoidal_position_encoding(
            length, d, tr_input.device)[None]
        flat = self.sess_transformer(flat, flat_mask)
        denom = torch.clamp(flat_mask.sum(dim=-1, keepdim=True), min=1.0)
        sess_fea = ((flat * flat_mask[..., None]).sum(dim=1) / denom).reshape(b, s, d)

        sess_mask = (positions(s, s, sess_length.device)[None, :]
                     < sess_length[:, None]).to(flat.dtype)
        lstm_out = self.bilstm(sess_fea, sess_mask)
        lstm_out = (lstm_out[..., :d] + lstm_out[..., d:]) / 2
        att_tr = self.tr_actpool(sess_fea, query, sess_mask)
        att_lstm = self.lstm_actpool(lstm_out, query, sess_mask)
        mlp_in = torch.cat([deep_input, att_tr, att_lstm, price[:, None]], dim=-1)
        return self.head(self.mlp(mlp_in))[:, 0]


_VOCAB_KEYS = (
    ("user_size", 265442), ("adgroup_size", 512431), ("pid_size", 2),
    ("cms_segid_size", 97), ("cms_group_size", 13), ("final_gender_size", 2),
    ("age_level_size", 7), ("pvalue_level_size", 4), ("shopping_level_size", 3),
    ("occupation_size", 2), ("new_user_class_level_size", 5),
    ("campaign_size", 309448), ("customer_size", 195841), ("cate_size", 12974),
    ("brand_size", 461499),
)


@register_model("rank.dsin")
class ModelDef(LogitModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.vocab_sizes = tuple(int(h(k, d)) for k, d in _VOCAB_KEYS)
        self.sess_count = int(h("sess_count", 5))
        self.sess_max_length = int(h("sess_max_length", 10))
        self.embed_dim = int(h("feat_embed_size", 4))
        self.att_embedding_size = int(h("att_embedding_size", 8))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DSINNet(self.vocab_sizes, self.embed_dim, self.att_embedding_size,
                       device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["sparse"], batch["price"], batch["sess_input"],
                batch["sess_length"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        sparse = np.stack(
            [rng.randint(0, v, batch_size) for v in self.vocab_sizes], axis=1
        ).astype(np.int64)
        return {
            "sparse": sparse,
            "price": rng.rand(batch_size).astype(np.float32),
            "sess_input": rng.randint(
                0, min(self.vocab_sizes[CATE], self.vocab_sizes[BRAND]),
                (batch_size, 2 * self.sess_count, self.sess_max_length),
            ).astype(np.int64),
            "sess_length": rng.randint(1, self.sess_count + 1, batch_size
                                       ).astype(np.int32),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return DSINDataset(list_data_files(data_dir), batch_size, self.sess_count,
                           self.sess_max_length)


class DSINDataset:
    """Text lines: ``label;15 sparse ids;price;sess ids (2S·L,
    comma-separated);sess_length``.  A copy of the JAX package's reader
    (numpy only): the tail is zero-padded to the full batch, the mask marks
    the real rows."""

    def __init__(self, files, batch_size, sess_count, sess_max_length):
        self.files = files
        self.batch_size = batch_size
        self.rows = 2 * sess_count
        self.cols = sess_max_length

    def __iter__(self):
        bs = self.batch_size
        buf = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(";")
                    if len(parts) < 5:
                        continue
                    buf.append(parts)
                    if len(buf) == bs:
                        yield self._batch(buf)
                        buf = []
        if buf:
            yield self._batch(buf, pad_to=bs)

    def _batch(self, rows, pad_to=None):
        n = pad_to or len(rows)
        sparse = np.zeros((n, 15), np.int64)
        price = np.zeros((n,), np.float32)
        sess = np.zeros((n, self.rows, self.cols), np.int64)
        sess_len = np.zeros((n,), np.int32)
        label = np.zeros((n,), np.float32)
        valid = len(rows)
        for i, p in enumerate(rows):
            label[i] = float(p[0])
            sp = [int(v) for v in p[1].split(",")][:15]
            sparse[i, : len(sp)] = sp  # short rows: zero-pad
            price[i] = float(p[2])
            ids = [int(v) for v in p[3].split(",")][: self.rows * self.cols]
            ids = ids + [0] * (self.rows * self.cols - len(ids))
            sess[i] = np.asarray(ids).reshape(self.rows, self.cols)
            sess_len[i] = int(p[4])
        mask = np.zeros(n, np.float32)
        mask[:valid] = 1.0
        return {
            "sparse": sparse, "price": price, "sess_input": sess,
            "sess_length": sess_len, "label": label, "mask": mask,
        }
