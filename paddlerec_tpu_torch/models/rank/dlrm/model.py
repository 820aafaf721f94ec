"""DLRM: bottom MLP on dense + dot-interaction + top MLP.

Counterpart of ``paddlerec_tpu/models/rank/dlrm/model.py``, registered as
``rank.dlrm``: ``bot_layer_sizes`` project the dense features to the
embedding width; the pairwise dot products between that vector and all slot
embeddings (upper triangle, row-major) feed the top MLP.  A 2-unit head is
read as ``top[:, 1] - top[:, 0]``.  As in the JAX package, the MLP's
activation follows the last layer of both towers too.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, triu_pairs


class DLRMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``bot_mlp.fc_i``, ``top_mlp.fc_i``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 bot_layer_sizes: Sequence[int], top_layer_sizes: Sequence[int],
                 num_sparse: int, dense_dim: int, self_interaction: bool = False,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        self.bot_mlp = MLP(dense_dim, bot_layer_sizes, device=device,
                           generator=generator)
        self.offset = 0 if self_interaction else 1
        n = num_sparse + 1
        pairs = n * (n + 1) // 2 if self_interaction else n * (n - 1) // 2
        self.top_mlp = MLP(bot_layer_sizes[-1] + pairs, top_layer_sizes,
                           device=device, generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)  # (B, S, E)
        bot = self.bot_mlp(dense)  # (B, E)
        vecs = torch.cat([bot[:, None, :], emb.to(bot.dtype)], dim=1)
        dots = torch.einsum("bie,bje->bij", vecs, vecs)
        i, j = triu_pairs(vecs.shape[1], self.offset, vecs.device)
        flat = dots[:, i, j]  # (B, pairs), row-major upper triangle
        top = self.top_mlp(torch.cat([bot, flat], dim=-1))
        if top.shape[-1] == 2:  # a 2-unit softmax head, read as one logit
            return top[:, 1] - top[:, 0]
        return top[:, 0]


@register_model("rank.dlrm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.bot_layer_sizes = list(config.hyper(
            "bot_layer_sizes", [512, 256, 64, self.embedding_dim]))
        self.top_layer_sizes = list(config.hyper("top_layer_sizes", [512, 256, 2]))
        self.self_interaction = bool(config.hyper("self_interaction", False))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DLRMNet(
            self.vocab_size, self.embedding_dim, self.bot_layer_sizes,
            self.top_layer_sizes, self.num_sparse, self.dense_dim,
            self.self_interaction, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
