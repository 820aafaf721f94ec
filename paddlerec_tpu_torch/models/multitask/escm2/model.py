"""ESCM²: entire-space counterfactual multitask (CTR / CVR / CTCVR).

Counterpart of ``paddlerec_tpu/models/multitask/escm2/model.py``, registered
as ``multitask.escm2``: an MMoE over the sum-pooled Ali-CCP fields
(``expert_<i>`` relu, per tower a softmax gate ``gate_<i>``, ``tower_<i>``
relu, ``tower_out_<i>`` softmax-2 whose class-1 probability is clipped).
``runner.counterfact_mode`` picks the CVR loss: ``IPW`` (inverse propensity
weighting, two towers) or ``DR`` (doubly robust, a third imputation tower).
Both weight by ``ips`` computed without a gradient (``.detach()``, the JAX
package's ``stop_gradient``).  Loss = BCE(ctr) + ``counterfactual_w``·L_cvr
+ ``global_w``·BCE(ctcvr); the AUCs are ``ctr``, ``cvr`` (against the
conversion label, on the entire space) and ``ctcvr``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import Aux
from paddlerec_tpu_torch.models.multitask.base import AliCCPModelDef, bce, clip_prob
from paddlerec_tpu_torch.models.multitask.esmm.model import field_features
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import flax_dense


class ESCMNet(nn.Module):
    def __init__(self, vocab_size: int, embedding_dim: int, num_field: int,
                 expert_num: int, expert_size: int, tower_size: int, gate_num: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.expert_num, self.gate_num = expert_num, gate_num
        feat = num_field * embedding_dim
        self.embedding = SlotEmbedding(vocab_size, embedding_dim, combiner="sum", **kw)
        for i in range(expert_num):
            self.add_module(f"expert_{i}", flax_dense(feat, expert_size, **kw))
        for i in range(gate_num):
            self.add_module(f"gate_{i}", flax_dense(feat, expert_num, **kw))
            self.add_module(f"tower_{i}", flax_dense(expert_size, tower_size, **kw))
            self.add_module(f"tower_out_{i}", flax_dense(tower_size, 2, **kw))

    def forward(self, sparse_ids, sparse_mask=None):
        feat = field_features(self.embedding, sparse_ids, sparse_mask)
        experts = torch.stack([torch.relu(getattr(self, f"expert_{i}")(feat))
                               for i in range(self.expert_num)], dim=1)  # (B, N, S)
        probs = []
        for i in range(self.gate_num):
            gate = torch.softmax(getattr(self, f"gate_{i}")(feat), dim=-1)
            mixed = torch.einsum("bns,bn->bs", experts, gate)
            tower = torch.relu(getattr(self, f"tower_{i}")(mixed))
            out = torch.softmax(getattr(self, f"tower_out_{i}")(tower), dim=-1)
            probs.append(clip_prob(out[:, 1]))
        return tuple(probs)


@register_model("multitask.escm2")
class ModelDef(AliCCPModelDef):
    metric_names = ("ctr", "cvr", "ctcvr")

    def __init__(self, config):
        super().__init__(config)
        self.counterfact_mode = str(config.runner("counterfact_mode", "IPW") or "IPW")
        self.global_w = float(config.hyper("global_w", 0.5))
        self.counterfactual_w = float(config.hyper("counterfactual_w", 0.5))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        h = self.config.hyper
        return ESCMNet(self.vocab_size, self.embedding_dim, self.num_field,
                       int(h("expert_num", 8)), int(h("expert_size", 16)),
                       int(h("tower_size", 8)), 3 if self.counterfact_mode == "DR" else 2,
                       device=device, generator=generator)

    def train_forward(self, module, batch):
        outs = module(*self.model_inputs(batch))
        ctr_prob, cvr_prob = outs[0], outs[1]
        ctcvr_prob = clip_prob(ctr_prob * cvr_prob)
        click, conversion = batch["labels"][:, 0], batch["labels"][:, 1]
        mask = batch.get("mask")
        w = mask if mask is not None else torch.ones_like(click)
        n = torch.clamp(w.sum(), min=1.0)
        loss_ctr = (bce(ctr_prob, click) * w).sum() / n
        loss_ctcvr = (bce(ctcvr_prob, conversion) * w).sum() / n
        loss_cvr_per = bce(cvr_prob, conversion)
        if self.counterfact_mode == "DR":
            # doubly robust: the imputation tower predicts the CVR loss, the
            # propensity corrects it on clicked rows
            imp = outs[2]
            e = loss_cvr_per - imp
            ips = torch.clamp(click / torch.clamp(ctr_prob, min=1e-6), -15, 15).detach()
            loss_cvr = ((imp + e * ips + (e * e) * ips) * w).sum() / n
        else:
            # inverse propensity weighting: clicked rows weighted by
            # batch size / (pCTR · clicks)
            ctr_num = torch.sum(click * w)
            ps = torch.clamp(ctr_prob * ctr_num, min=1e-6)
            ips = (torch.clamp(1.0 / ps, -15, 15) * n).detach()
            loss_cvr = (loss_cvr_per * ips * click * w).sum() / n
        loss = loss_ctr + self.counterfactual_w * loss_cvr + self.global_w * loss_ctcvr
        aux: Aux = {"ctr": ctr_prob, "cvr": cvr_prob, "ctcvr": ctcvr_prob,
                    "click": click, "conversion": conversion}
        if mask is not None:
            aux["mask"] = mask
        return loss, aux

    def metric_updates(self, aux):
        mask = aux.get("mask")
        return {"ctr": (aux["ctr"], aux["click"], mask),
                "cvr": (aux["cvr"], aux["conversion"], mask),
                "ctcvr": (aux["ctcvr"], aux["conversion"], mask)}
