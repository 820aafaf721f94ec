"""DMR: deep match to rank (Alimama display-ad CTR).

Counterpart of ``paddlerec_tpu/models/rank/dmr/model.py``, registered as
``rank.dmr``: two relevance subnets over a length-T behaviour history.

* User-to-item: a position + behaviour-type query scores the history, a
  causal (lower-triangular) softmax mixes it at every prefix, and a PReLU
  projection of the mix at T-1 is the user vector; rel_u2i is its product
  with the target category's ``dm_item_emb`` row.  The auxiliary loss is a
  log-softmax over every category (``dm_item_emb.attend`` + ``dm_item_bias``)
  predicting the last clicked category from the T-2 prefix, × 0.1, averaged
  over the whole batch without the mask.
* Item-to-item: target-aware attention with position context; rel_i2i is the
  sum of the unnormalised scores over valid positions.

A ``LayerNorm`` (flax's epsilon) and a PReLU MLP 512-256-128-1 over the
features give the logit; the loss is the masked log-loss plus the auxiliary
loss.  Masked scores are filled with -2^31, a finite value as in the JAX
module.  20 tables, 20 K1 launches a forward and 20 K1b a step (the
category and brand tables serve target and history in one lookup each).
``infer_forward`` leaves the auxiliary loss out: the JAX package's jitted
inference drops it as dead code.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import LogitModelDef, binary_logloss
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import LayerNorm, flax_dense
from paddlerec_tpu_torch.ops.sequence import positions

PROFILE_FIELDS = (
    "cms_segid", "cms_group_id", "final_gender_code", "age_level",
    "pvalue_level", "shopping_level", "occupation", "new_user_class_level",
)
_FILL = -(2.0 ** 31)


class PReLU(nn.Module):
    """``where(x >= 0, x, alpha * x)`` with ``alpha`` (init 0.1) of the
    broadcast shape the flax module gives it: per position on axis 1 for a
    (B, T, C) activation (the reference's ``PReLU(num_parameters=T)``), per
    channel for (B, C)."""

    def __init__(self, shape: Tuple[int, ...], device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(shape, 0.1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


@functools.lru_cache(maxsize=None)
def _causal(t: int, device: torch.device) -> torch.Tensor:
    """(t, t) booleans: row i may attend to positions <= i."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))


def _take_fill(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp, labels[:, None], 1)[:, 0]`` with jnp's default
    mode: a negative label wraps once, one still out of range gives NaN."""
    c = logp.shape[1]
    labels = torch.where(labels < 0, labels + c, labels)
    inside = (labels >= 0) & (labels < c)
    picked = logp.gather(1, labels.clamp(0, c - 1).long()[:, None])[:, 0]
    return picked.masked_fill(~inside, float("nan"))


class DMRNet(nn.Module):
    """Parameters, named as the flax tree names them: ``<name>_emb`` tables,
    ``dm_item_bias``, the ``dm_*`` and ``dmr_*`` / ``tg_att_*`` layers of the
    two subnets with their PReLUs, ``inp_norm``, ``f0``-``f3`` and
    ``prelu0``-``prelu3``."""

    def __init__(self, vocab: dict, main_e: int = 32, other_e: int = 8,
                 history_length: int = 50, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        m, o, t, v = main_e, other_e, history_length, vocab
        for name, size, width in (
            ("uid", v["user"], m), ("mid", v["adgroup_id"], m), ("cate", v["cate"], m),
            ("brand", v["brand"], m), ("btag", v["btag"], o), ("dm_btag", v["btag"], o),
            ("campaign", v["campaign_id"], m), ("customer", v["customer"], m),
            ("pid", v["pid"], o), *((n, v[n], o) for n in PROFILE_FIELDS),
            ("position", t, o), ("dm_position", t, o), ("dm_item", v["cate"], m),
        ):
            self.add_module(f"{name}_emb", Embed(size, width, **kw))
        self.dm_item_bias = nn.Parameter(torch.zeros(v["cate"], device=device))
        self.dm_align = flax_dense(2 * o, 2 * m, **kw)
        self.dm_prelu = PReLU((1, t, 1), device)
        self.dm_att_1 = flax_dense(8 * m, 80, **kw)
        self.dm_att_2 = flax_dense(80, 40, **kw)
        self.dm_att_3 = flax_dense(40, 1, **kw)
        self.dm_fcn_1 = flax_dense(2 * m, m, **kw)
        self.dm_fcn_prelu = PReLU((1, t, 1), device)
        self.dmr_align = flax_dense(2 * m + 2 * o, 2 * m, **kw)
        self.dmr_prelu = PReLU((1, t, 1), device)
        self.tg_att_1 = flax_dense(8 * m, 80, **kw)
        self.tg_att_2 = flax_dense(80, 40, **kw)
        self.tg_att_3 = flax_dense(40, 1, **kw)
        width = 12 * m + 9 * o + 3
        self.inp_norm = LayerNorm(width, device=device)
        for i, d in enumerate((512, 256, 128, 1)):
            self.add_module(f"f{i}", flax_dense(width, d, **kw))
            self.add_module(f"prelu{i}", PReLU((1, d), device))
            width = d

    def forward(self, hist_btag, hist_cate, hist_brand, mask, match_mask,
                profile, uid, mid, cate_id, campaign, customer, brand, pid, price,
                with_aux: bool = True):
        """→ (logits (B,), aux_loss); ``with_aux=False`` gives ``None`` for
        the auxiliary loss and skips its (B, categories) product."""
        b, t = hist_cate.shape
        uid_e, mid_e = self.uid_emb(uid), self.mid_emb(mid)
        cate_e, cate_his_e = self.cate_emb(cate_id, hist_cate)
        brand_e, brand_his_e = self.brand_emb(brand, hist_brand)
        btag_his_e, dm_btag_his_e = self.btag_emb(hist_btag), self.dm_btag_emb(hist_btag)
        camp_e, cust_e = self.campaign_emb(campaign), self.customer_emb(customer)
        pid_e = self.pid_emb(pid)
        profile_e = [getattr(self, f"{n}_emb")(profile[:, i])
                     for i, n in enumerate(PROFILE_FIELDS)]
        # one row per position, the same for every example
        steps = positions(t, t, hist_cate.device)
        pos_his = self.position_emb(steps).expand(b, t, -1)
        dm_pos_his = self.dm_position_emb(steps).expand(b, t, -1)

        user_feat = torch.cat([uid_e] + profile_e, dim=-1)
        item_his_eb = torch.cat([cate_his_e, brand_his_e], dim=-1)  # (B, T, 2M)
        item_his_sum = (item_his_eb * mask[..., None]).sum(dim=1)
        item_feat = torch.cat([mid_e, cate_e, brand_e, camp_e, cust_e, price[:, None]],
                              dim=-1)
        item_eb = torch.cat([cate_e, brand_e], dim=-1)  # (B, 2M)
        pos_ctx = torch.cat([pos_his, btag_his_e], dim=-1)
        dm_pos_ctx = torch.cat([dm_pos_his, dm_btag_his_e], dim=-1)

        # user-to-item deep match
        q = self.dm_prelu(self.dm_align(dm_pos_ctx))
        att_in = torch.cat([q, item_his_eb, q - item_his_eb, q * item_his_eb], dim=-1)
        s = torch.sigmoid(self.dm_att_2(torch.sigmoid(self.dm_att_1(att_in))))
        scores = self.dm_att_3(s)[..., 0].masked_fill(mask <= 0, _FILL)  # (B, T)
        # causal prefix softmax: row i attends to history positions <= i
        tiled = scores[:, None, :].expand(b, t, t).masked_fill(
            ~_causal(t, scores.device), _FILL)
        probs = torch.softmax(tiled, dim=-1)
        att_hist = torch.einsum("bts,bse->bte", probs, item_his_eb)
        dnn1 = self.dm_fcn_prelu(self.dm_fcn_1(att_hist))  # (B, T, M)
        user_vector = dnn1[:, -1, :]
        aux_loss = None
        if with_aux:
            user_vector2 = dnn1[:, -2, :] * match_mask[:, -2:-1]
            logits_aux = self.dm_item_emb.attend(user_vector2) + self.dm_item_bias
            logp = F.log_softmax(logits_aux, dim=-1)
            aux_loss = -_take_fill(logp, hist_cate[:, -1]).mean() * 0.1
        rel_u2i = (user_vector * self.dm_item_emb(cate_id)).sum(dim=-1, keepdim=True)

        # item-to-item attention
        item_tile = item_eb[:, None, :].expand(b, t, item_eb.shape[-1])
        q2 = self.dmr_prelu(self.dmr_align(torch.cat([item_tile, pos_ctx], dim=-1)))
        att2_in = torch.cat([q2, item_his_eb, q2 - item_his_eb, q2 * item_his_eb],
                            dim=-1)
        s2 = torch.sigmoid(self.tg_att_2(torch.sigmoid(self.tg_att_1(att2_in))))
        scores2 = self.tg_att_3(s2)[..., 0]  # (B, T)
        rel_i2i = scores2.masked_fill(mask <= 0, 0.0).sum(dim=-1, keepdim=True)
        w2 = torch.softmax(scores2.masked_fill(mask <= 0, _FILL), dim=-1)
        att_out = torch.einsum("bt,bte->be", w2, item_his_eb)

        h = self.inp_norm(torch.cat([
            user_feat, item_feat, pid_e, item_his_sum, item_eb * item_his_sum,
            rel_u2i, rel_i2i, att_out], dim=-1))
        for i in range(4):
            h = getattr(self, f"prelu{i}")(getattr(self, f"f{i}")(h))
        return h[:, 0], aux_loss


_VOCAB_KEYS = (
    ("user", "user_size", 1141730), ("cms_segid", "cms_segid_size", 97),
    ("cms_group_id", "cms_group_id_size", 13),
    ("final_gender_code", "final_gender_code_size", 3),
    ("age_level", "age_level_size", 7), ("pvalue_level", "pvalue_level_size", 4),
    ("shopping_level", "shopping_level_size", 4), ("occupation", "occupation_size", 3),
    ("new_user_class_level", "new_user_class_level_size", 5),
    ("adgroup_id", "adgroup_id_size", 846812), ("cate", "cate_size", 12978),
    ("campaign_id", "campaign_id_size", 423437), ("customer", "customer_size", 255876),
    ("brand", "brand_size", 461529), ("btag", "btag_size", 5), ("pid", "pid_size", 2),
)


@register_model("rank.dmr")
class ModelDef(LogitModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        h = config.hyper
        self.vocab = {name: int(h(key, d)) for name, key, d in _VOCAB_KEYS}
        self.history_length = int(h("history_length", 50))
        self.main_e = int(h("main_embedding_size", 32))
        self.other_e = int(h("other_embedding_size", 8))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DMRNet(self.vocab, self.main_e, self.other_e, self.history_length,
                      device=device, generator=generator)

    def model_inputs(self, batch):
        return (
            batch["hist_btag"], batch["hist_cate"], batch["hist_brand"],
            batch["hist_mask"], batch["match_mask"], batch["profile"],
            batch["uid"], batch["mid"], batch["cate_id"], batch["campaign"],
            batch["customer"], batch["brand"], batch["pid"], batch["price"],
        )

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t, v = self.history_length, self.vocab
        lens = rng.randint(1, t + 1, batch_size)
        # histories right-aligned (most recent at T-1)
        hist_mask = (np.arange(t)[None, :] >= (t - lens[:, None])).astype(np.float32)
        return {
            "hist_btag": rng.randint(0, v["btag"], (batch_size, t)).astype(np.int64),
            "hist_cate": rng.randint(0, v["cate"], (batch_size, t)).astype(np.int64),
            "hist_brand": rng.randint(0, v["brand"], (batch_size, t)).astype(np.int64),
            "hist_mask": hist_mask,
            "match_mask": hist_mask.copy(),
            "profile": np.stack(
                [rng.randint(0, v[n], batch_size) for n in PROFILE_FIELDS], 1
            ).astype(np.int64),
            "uid": rng.randint(0, v["user"], batch_size).astype(np.int64),
            "mid": rng.randint(0, v["adgroup_id"], batch_size).astype(np.int64),
            "cate_id": rng.randint(0, v["cate"], batch_size).astype(np.int64),
            "campaign": rng.randint(0, v["campaign_id"], batch_size).astype(np.int64),
            "customer": rng.randint(0, v["customer"], batch_size).astype(np.int64),
            "brand": rng.randint(0, v["brand"], batch_size).astype(np.int64),
            "pid": rng.randint(0, v["pid"], batch_size).astype(np.int64),
            "price": rng.rand(batch_size).astype(np.float32),
            "label": (rng.rand(batch_size) < 0.5).astype(np.float32),
            "mask": np.ones(batch_size, np.float32),
        }

    def train_forward(self, module: nn.Module, batch):
        logits, aux_loss = module(*self.model_inputs(batch))
        aux = self._aux(logits, batch)
        return binary_logloss(logits, aux["labels"], aux.get("mask")) + aux_loss, aux

    def infer_forward(self, module: nn.Module, batch):
        logits, _ = module(*self.model_inputs(batch), with_aux=False)
        return self._aux(logits, batch)

    def make_dataset(self, data_dir, batch_size, shuffle=False):
        return DMRDataset(list_data_files(data_dir), batch_size, self.history_length)


class DMRDataset:
    """The reference's Alimama format: each line is 5·T history columns
    (btag, cate, brand, mask, match_mask) then 16 scalar ids + label,
    comma-separated.  A copy of the JAX package's reader (numpy only): the
    tail is zero-padded to the full batch, the mask marks the real rows."""

    def __init__(self, files, batch_size, history_length):
        self.files = files
        self.batch_size = batch_size
        self.T = history_length

    def __iter__(self):
        bs, t = self.batch_size, self.T
        buf = []
        for path in self.files:
            with open(path) as f:
                for line in f:
                    vals = line.strip().split(",")
                    if len(vals) < 5 * t + 17:
                        continue
                    buf.append([float(x) for x in vals])
                    if len(buf) == bs:
                        yield self._batch(np.asarray(buf))
                        buf = []
        if buf:
            yield self._batch(np.asarray(buf), valid=len(buf), pad_to=bs)

    def _batch(self, a, valid=None, pad_to=None):
        t = self.T
        if pad_to and len(a) < pad_to:
            a = np.concatenate([a, np.zeros((pad_to - len(a), a.shape[1]), a.dtype)])
        n = len(a)
        ids = a.astype(np.int64)
        scalars = ids[:, 5 * t:]
        return {
            "hist_btag": ids[:, 0:t],
            "hist_cate": ids[:, t:2 * t],
            "hist_brand": ids[:, 2 * t:3 * t],
            "hist_mask": a[:, 3 * t:4 * t].astype(np.float32),
            "match_mask": a[:, 4 * t:5 * t].astype(np.float32),
            "uid": scalars[:, 0],
            "profile": scalars[:, 1:9],
            "mid": scalars[:, 9],
            "cate_id": scalars[:, 10],
            "campaign": scalars[:, 11],
            "customer": scalars[:, 12],
            "brand": scalars[:, 13],
            "price": a[:, 5 * t + 14].astype(np.float32),
            "pid": scalars[:, 15],
            "label": a[:, 5 * t + 16].astype(np.float32),
            "mask": (np.arange(n) < (n if valid is None else valid)).astype(np.float32),
        }
