"""DCN: CrossNet (v1) + DNN in parallel, concat → logit.

Counterpart of ``paddlerec_tpu/models/rank/dcn/model.py``, registered as
``rank.dcn``: ``cross_num`` cross layers sharing one weight over
[embeddings, dense], a DNN branch, a concatenated head; ``l2_reg_cross``
penalizes Σ_layers Σ (x ⊙ w)² of the batch, and ``clip_by_norm`` clips the
gradient's global norm in the optimizer.  The JAX module sows the penalty
into its intermediates; here the module's forward returns it beside the
logits.  ``dnn_use_bn`` is read and ignored, as there.

With ``sparse_update: true`` the table is in external-update mode and the
row-wise rules step it, as for every model of the port.  (The JAX model's own
``train_forward`` runs outside the embedding context, so there the table of a
sparse dcn run is read densely, frozen by the optimizer and never stepped.)
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import (
    Aux, Batch, CTRModelDef, binary_logloss,
)
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, CrossNet, flax_dense


class DCNNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``crossnet.layer_w`` / ``.layer_b``, ``tower.fc_i``, ``head``.  The
    forward returns ``(logits (B,), cross_l2 ())``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 cross_num: int = 2, dnn_use_bn: bool = False,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        dim = num_sparse * embedding_dim + dense_dim
        self.crossnet = CrossNet(dim, cross_num, share_weights=True,
                                 return_l2=True, device=device,
                                 generator=generator)
        self.tower = MLP(dim, fc_sizes, device=device, generator=generator)
        self.head = flax_dense(dim + fc_sizes[-1], 1, device=device,
                               generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        emb = self.embedding(sparse_ids)
        x0 = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                       dim=-1)
        cross_out, cross_l2 = self.crossnet(x0)
        final = torch.cat([cross_out, self.tower(x0)], dim=-1)
        return self.head(final)[:, 0], cross_l2


@register_model("rank.dcn")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [512, 256, 128]))
        self.cross_num = int(config.hyper("cross_num", 2))
        self.dnn_use_bn = bool(config.hyper("dnn_use_bn", False))
        self.l2_reg_cross = float(config.hyper("l2_reg_cross", 0.0))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DCNNet(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, self.cross_num, self.dnn_use_bn,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )

    def _logits_and_aux(self, module: nn.Module,
                        batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits, _ = module(*self.model_inputs(batch))
        logits = logits.reshape(-1)
        return logits, self._aux(logits, batch)

    def train_forward(self, module: nn.Module,
                      batch: Batch) -> Tuple[torch.Tensor, Aux]:
        logits, cross_l2 = module(*self.model_inputs(batch))
        logits = logits.reshape(-1)
        aux = self._aux(logits, batch)
        loss = binary_logloss(logits, aux["labels"], aux.get("mask"))
        if self.l2_reg_cross:
            loss = loss + self.l2_reg_cross * cross_l2
        return loss, aux
