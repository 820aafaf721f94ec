"""AITM: adaptive information transfer along the click → conversion funnel.

Counterpart of ``paddlerec_tpu/models/multitask/aitm/model.py``, registered
as ``multitask.aitm``: the shared field embedding of esmm, a click and a
conversion tower (``MLP`` with a relu after the last layer too), the click
tower's information transferred through ``info`` (relu), a two-token
attention (``att_q``, ``att_k``, ``att_v``, no bias, scores over
``sqrt(dim)``) over [conversion tower, transferred info], sigmoid heads.
The loss adds to the two BCEs the funnel constraint ``max(p_conv −
p_click, 0)`` weighted by ``constraint_weight`` and **summed** over the
rows the mask keeps, not averaged, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.multitask.base import (
    AliCCPModelDef, bce, clip_prob, masked_mean,
)
from paddlerec_tpu_torch.models.multitask.esmm.model import field_features
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense


class AITMNet(nn.Module):
    def __init__(self, vocab_size: int, embedding_dim: int, num_field: int,
                 tower_dims: Sequence[int] = (128, 64, 32), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        dims = list(tower_dims)
        self.dim = dim = dims[-1]
        feat = num_field * embedding_dim
        self.embedding = SlotEmbedding(vocab_size, embedding_dim, combiner="sum", **kw)
        self.click_tower = MLP(feat, dims, output_activation="relu", **kw)
        self.conversion_tower = MLP(feat, dims, output_activation="relu", **kw)
        self.info = flax_dense(dim, dim, **kw)
        for name in ("att_q", "att_k", "att_v"):
            self.add_module(name, flax_dense(dim, dim, bias=False, **kw))
        self.click_head = flax_dense(dim, 1, **kw)
        self.conv_head = flax_dense(dim, 1, **kw)

    def forward(self, sparse_ids, sparse_mask=None):
        feat = field_features(self.embedding, sparse_ids, sparse_mask)
        t_click = self.click_tower(feat)
        t_conv = self.conversion_tower(feat)
        info = torch.relu(self.info(t_click))
        stack = torch.stack([t_conv, info], dim=1)  # (B, 2, D)
        q, k, v = self.att_q(stack), self.att_k(stack), self.att_v(stack)
        a = torch.softmax((q * k).sum(-1) / math.sqrt(self.dim), dim=1)  # (B, 2)
        fused = (a[..., None] * v).sum(dim=1)
        click_prob = torch.sigmoid(self.click_head(t_click))[:, 0]
        conv_prob = torch.sigmoid(self.conv_head(fused))[:, 0]
        return click_prob, conv_prob


@register_model("multitask.aitm")
class ModelDef(AliCCPModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.constraint_weight = float(config.hyper("constraint_weight", 0.6))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return AITMNet(self.vocab_size, self.embedding_dim, self.num_field,
                       self.config.hyper("tower_dims", [128, 64, 32]),
                       device=device, generator=generator)

    def train_forward(self, module, batch):
        # AITM predicts the conversion directly (not ctr·cvr)
        click_prob, conv_prob = module(*self.model_inputs(batch))
        click_prob, conv_prob = clip_prob(click_prob), clip_prob(conv_prob)
        aux = self._aux(click_prob, conv_prob, batch)
        mask = batch.get("mask")
        constraint = torch.clamp(conv_prob - click_prob, min=0.0)
        constraint = (constraint * mask).sum() if mask is not None else constraint.sum()
        loss = (masked_mean(bce(click_prob, aux["click"]), mask)
                + masked_mean(bce(conv_prob, aux["conversion"]), mask)
                + self.constraint_weight * constraint)
        return loss, aux
