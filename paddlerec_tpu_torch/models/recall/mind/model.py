"""MIND: multi-interest network with dynamic (capsule) routing.

Counterpart of ``paddlerec_tpu/models/recall/mind/model.py``, registered as
``recall.mind``: the history's item vectors (one table ``item_emb``,
``item_count`` × ``embedding_dim``, 367,983 × 64 by default) are routed into
``interest_num`` capsules by three iterations of behaviour-to-interest
routing (``CapsuleRouting``: a shared bilinear map ``bilinear_w`` and the
routing logits ``routing_logits``), label-aware attention (``pow_p``) mixes
the capsules for the target, and the loss is a sampled softmax of the target
against ``neg_samples`` uniform negatives, averaged under the batch's mask.
The AUC of the positive against the first eight negatives is logged as
``auc``.

``routing_logits`` is a random start the reference stops the gradient of
(``stop_gradient``): its gradient is exactly zero, but it stays a leaf the
optimizer steps, so Adam leaves it as it is while AdamW's decay moves it.
The port does the same: ``_StopGradient`` passes the value and gives back a
zero gradient (not none), so the optimizer steps the leaf as optax does.

The history (N = B·maxlen), the targets (B) and the negatives
(B·neg_samples) are read in one K1 launch (``Embed(*ids)``), so a step is
one K1 and one K1b launch.  ``user_capsules`` is the serving call (the
interest capsules for ANN recall).

``MINDDataset`` is a copy of the JAX package's reader (numpy only): CSV
``user,item,timestamp`` → per-user time-sorted histories, each prefix the
history of the next item (the last ``maxlen`` kept), uniform negatives from
``RandomState(0)``, the tail batch padded with ``mask`` 0.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.base import Aux, ModelDef as BaseModelDef, masked_mean, \
    pair_metric
from paddlerec_tpu_torch.ops.embedding import Embed


class _StopGradient(torch.autograd.Function):
    """JAX's ``stop_gradient`` on a parameter: the value forward, a zero
    gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


class CapsuleRouting(nn.Module):
    """B2I dynamic routing: (B, T, E) history → (B, K, E) interests."""

    def __init__(self, embedding_dim: int, interest_num: int, maxlen: int,
                 routing_iters: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.routing_iters = routing_iters
        e = embedding_dim
        self.bilinear_w = nn.Parameter(
            torch.randn(e, e, device=device, generator=generator) / math.sqrt(e))
        self.routing_logits = nn.Parameter(
            torch.randn(1, interest_num, maxlen, device=device, generator=generator))

    def forward(self, hist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = hist.shape[0]
        u_hat = torch.einsum("bte,ef->btf", hist, self.bilinear_w)
        logits = _StopGradient.apply(self.routing_logits).expand(b, -1, -1)
        keep = mask[:, None, :]
        caps = None
        for _ in range(self.routing_iters):
            w = torch.softmax(torch.where(keep > 0, logits, logits.new_tensor(-1e9)), dim=1)
            caps = torch.einsum("bkt,bte->bke", w * keep, u_hat)
            norm2 = (caps * caps).sum(-1, keepdim=True)  # squash
            caps = caps * (norm2 / (1 + norm2)) / torch.sqrt(norm2 + 1e-9)
            logits = logits + torch.einsum("bke,bte->bkt", caps, u_hat)
        return caps


class MINDNet(nn.Module):
    def __init__(self, item_count: int, embedding_dim: int, interest_num: int,
                 maxlen: int, pow_p: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.pow_p = pow_p
        self.item_emb = Embed(item_count, embedding_dim, **kw)
        self.routing = CapsuleRouting(embedding_dim, interest_num, maxlen, **kw)

    def forward(self, hist_items, seq_mask, target_items, neg_items):
        """→ pos_logit (B,), neg_logit (B, N), capsules (B, K, E)."""
        hist, tgt, neg = self.item_emb(hist_items, target_items, neg_items)
        caps = self.routing(hist, seq_mask)
        att = torch.softmax(torch.pow(torch.clamp(
            torch.einsum("bke,be->bk", caps, tgt), min=1e-9), self.pow_p), dim=-1)
        user_vec = torch.einsum("bk,bke->be", att, caps)
        pos_logit = (user_vec * tgt).sum(-1)
        neg_logit = torch.einsum("be,bne->bn", user_vec, neg)
        return pos_logit, neg_logit, caps

    def user_capsules(self, hist_items, seq_mask):
        """The serving call: the interest capsules (B, K, E) of a history."""
        return self.routing(self.item_emb(hist_items), seq_mask)


@register_model("recall.mind")
class ModelDef(BaseModelDef):
    metric_names = ("auc",)

    def __init__(self, config):
        super().__init__(config)
        self.item_count = int(config.hyper("item_count", 367983))
        self.embedding_dim = int(config.hyper("embedding_dim", 64))
        self.interest_num = int(config.hyper("interest_num", 4))
        self.neg_samples = int(config.hyper("neg_samples", 128))
        self.maxlen = int(config.hyper("maxlen", 20))
        self.pow_p = float(config.hyper("pow_p", 1.0))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return MINDNet(self.item_count, self.embedding_dim, self.interest_num,
                       self.maxlen, self.pow_p, device=device, generator=generator)

    def model_inputs(self, batch):
        return (batch["hist_items"], batch["seq_mask"], batch["target_items"],
                batch["neg_items"])

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        t = self.maxlen
        lens = rng.randint(1, t + 1, batch_size)
        seq_mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        return {
            "hist_items": (rng.randint(0, self.item_count, (batch_size, t))
                           * seq_mask).astype(np.int32),
            "seq_mask": seq_mask,
            "target_items": rng.randint(0, self.item_count, batch_size).astype(np.int32),
            "neg_items": rng.randint(0, self.item_count,
                                     (batch_size, self.neg_samples)).astype(np.int32),
            "mask": np.ones(batch_size, np.float32),
        }

    def train_forward(self, module, batch):
        pos_logit, neg_logit, _ = module(*self.model_inputs(batch))
        logits = torch.cat([pos_logit[:, None], neg_logit], dim=1)
        per = -torch.log_softmax(logits, dim=1)[:, 0]  # sampled softmax
        mask = batch.get("mask")
        aux: Aux = {"pos_logit": pos_logit, "neg_logit": neg_logit}
        if mask is not None:
            aux["mask"] = mask
        return masked_mean(per, mask), aux

    def metric_updates(self, aux):
        k = min(8, aux["neg_logit"].shape[1])  # the first k negatives
        return {"auc": pair_metric(torch.sigmoid(aux["pos_logit"]),
                                   torch.sigmoid(aux["neg_logit"][:, :k]), aux.get("mask"))}

    def make_dataset(self, data_dir: str, batch_size: int, shuffle=False):
        return MINDDataset(list_data_files(data_dir), self.item_count, self.maxlen,
                           self.neg_samples, batch_size)


class MINDDataset:
    """CSV ``user,item,timestamp`` → per-user time-sorted histories; each
    step uses the prefix as history and the next item as target, with
    uniform negatives."""

    def __init__(self, files, item_count, maxlen, neg_samples, batch_size, seed=0):
        self.files = files
        self.item_count = item_count
        self.maxlen = maxlen
        self.neg_samples = neg_samples
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)

    def _sequences(self):
        graph = {}
        for path in self.files:
            with open(path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 3:
                        continue
                    u, i, ts = int(parts[0]), int(parts[1]), int(parts[2])
                    graph.setdefault(u, []).append((ts, i))
        for u, items in graph.items():
            items.sort()
            yield [i for _, i in items]

    def __iter__(self):
        t = self.maxlen
        rows = []
        for seq in self._sequences():
            for split in range(1, len(seq)):
                rows.append((seq[max(0, split - t):split], seq[split]))
                if len(rows) == self.batch_size:
                    yield self._emit(rows)
                    rows = []
        if rows:
            yield self._emit(rows, pad_to=self.batch_size)

    def _emit(self, rows, pad_to=None):
        bs = pad_to or len(rows)
        t = self.maxlen
        hist = np.zeros((bs, t), np.int32)
        seq_mask = np.zeros((bs, t), np.float32)
        target = np.zeros((bs,), np.int32)
        mask = np.zeros((bs,), np.float32)
        for r, (h, tgt) in enumerate(rows):
            hist[r, :len(h)] = h
            seq_mask[r, :len(h)] = 1.0
            target[r] = tgt
            mask[r] = 1.0
        return {
            "hist_items": hist, "seq_mask": seq_mask, "target_items": target,
            "neg_items": self.rng.randint(0, self.item_count,
                                          (bs, self.neg_samples)).astype(np.int32),
            "mask": mask,
        }
