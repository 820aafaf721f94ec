"""DeepFM: FM first + second order + DNN over shared embeddings.

Counterpart of ``paddlerec_tpu/models/rank/deepfm/model.py``, registered as
``rank.deepfm``.  The FM first-order weight is the extra lane E of one fused
E+1 table, so ONE lookup (one K1 launch) serves first order, second order
and the deep tower.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense, fm_second_order


class DeepFMNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (packed (R, 128)), ``dense_w``, ``fm_bias``, ``tower.fc_i``, ``head``.

    With a bfloat16 table the dtype flow is the JAX package's: the lookup
    and ``fm_second_order`` stay bf16, and the concat with the dense
    features and the sum with ``dense @ dense_w`` promote to float32.  In
    external-update mode (``hyper_parameters.sparse_update``) the lookup is
    float32 already."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = first-order weight
        self.dense_w = nn.Parameter(
            torch.randn(dense_dim, generator=generator, device=device) * 1e-4
        )
        self.fm_bias = nn.Parameter(torch.zeros((), device=device))
        self.tower = MLP(num_sparse * embedding_dim + dense_dim, fc_sizes,
                         device=device, generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)  # (B, S, E+1)
        emb = fused[..., :e]
        first = fused[..., e].sum(dim=1) + dense @ self.dense_w
        second = fm_second_order(emb)
        b = emb.shape[0]
        feat = torch.cat([emb.reshape(b, -1).to(dense.dtype), dense], dim=-1)
        deep = self.head(self.tower(feat))[:, 0]
        return first + second + deep + self.fm_bias


@register_model("rank.deepfm")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [512, 256, 128, 32]))
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused w1 lane

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return DeepFMNet(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
