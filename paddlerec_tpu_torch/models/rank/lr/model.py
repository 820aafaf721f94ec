"""Logistic regression over sparse one-hot features.

Counterpart of ``paddlerec_tpu/models/rank/lr/model.py``, registered as
``rank.lr`` and ``rank.logistic_regression``: a rank-1 weight per sparse id
plus bias (and dense weights where the config has dense inputs).  One K1
launch per forward, on the 8-lane view of the width-1 packed table.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.layers import FMFirstOrder


class LRNet(nn.Module):
    """Parameters, named as the flax tree names them:
    ``FMFirstOrder_0.sparse_w`` (packed (R, 128), float32 whatever
    ``sparse_feature_dtype`` says, as in the JAX package), ``.dense_w``,
    ``.bias``."""

    def __init__(self, vocab_size: int, dense_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.FMFirstOrder_0 = FMFirstOrder(vocab_size, dense_dim, device=device,
                                           generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.FMFirstOrder_0(sparse_ids, dense)


@register_model("rank.lr")
@register_model("rank.logistic_regression")
class ModelDef(CTRModelDef):
    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return LRNet(self.vocab_size, self.dense_dim, device=device,
                     generator=generator)
