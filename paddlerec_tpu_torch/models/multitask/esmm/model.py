"""ESMM: entire-space multitask CTR × CVR.

Counterpart of ``paddlerec_tpu/models/multitask/esmm/model.py``, registered
as ``multitask.esmm``: one packed ``SlotEmbedding`` shared by the 23 Ali-CCP
fields, each a multi-hot field sum-pooled under its mask, then the
``ctr_tower`` and ``cvr_tower`` MLPs and their sigmoid heads; the loss is
``AliCCPModelDef``'s BCE(ctr) + BCE(ctr·cvr).  The lookup is one K1 launch
a forward (N = B·23 fields, L = 3 ids, the mask as weights) and one K1b a
step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.multitask.base import AliCCPModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense


def field_features(embedding: SlotEmbedding, sparse_ids, sparse_mask) -> torch.Tensor:
    """(B, F, L) ids and mask → the sum-pooled fields flattened, (B, F·E)."""
    emb = embedding(sparse_ids, sparse_mask)
    return emb.reshape(emb.shape[0], -1)


class ESMMNet(nn.Module):
    def __init__(self, vocab_size: int, embedding_dim: int, num_field: int,
                 ctr_fc_sizes: Sequence[int], cvr_fc_sizes: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.embedding = SlotEmbedding(vocab_size, embedding_dim, combiner="sum", **kw)
        feat = num_field * embedding_dim
        self.ctr_tower = MLP(feat, list(ctr_fc_sizes), **kw)
        self.ctr_head = flax_dense(list(ctr_fc_sizes)[-1], 1, **kw)
        self.cvr_tower = MLP(feat, list(cvr_fc_sizes), **kw)
        self.cvr_head = flax_dense(list(cvr_fc_sizes)[-1], 1, **kw)

    def forward(self, sparse_ids, sparse_mask=None):
        feat = field_features(self.embedding, sparse_ids, sparse_mask)
        ctr_prob = torch.sigmoid(self.ctr_head(self.ctr_tower(feat)))[:, 0]
        cvr_prob = torch.sigmoid(self.cvr_head(self.cvr_tower(feat)))[:, 0]
        return ctr_prob, cvr_prob


@register_model("multitask.esmm")
class ModelDef(AliCCPModelDef):
    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        h = self.config.hyper
        return ESMMNet(self.vocab_size, self.embedding_dim, self.num_field,
                       h("ctr_fc_sizes", [256, 64]), h("cvr_fc_sizes", [256, 64]),
                       device=device, generator=generator)
