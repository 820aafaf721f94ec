"""GateNet (GateDnn): embedding gates + hidden gates over a DNN.

Counterpart of ``paddlerec_tpu/models/rank/gatenet/model.py``, registered as
``rank.gatenet``: a per-field embedding gate (emb·w → sigmoid → scale emb)
and a per-layer hidden gate ``x * tanh(x @ g)``.  The gate matrices are raw
``(size, size)`` parameters applied as ``x @ g``: not linear layers, so the
conversion leaves them as they are.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import normal_param, scaled_dense


class GateNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``embedding_gate_weight`` (S, 1), ``fc_i``, ``hidden_gate_weight_i``,
    ``last_layer``."""

    def __init__(self, vocab_size: int, embedding_dim: int,
                 fc_sizes: Sequence[int], num_sparse: int, dense_dim: int,
                 use_embedding_gate: bool = True, use_hidden_gate: bool = True,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_embedding_gate = use_embedding_gate
        self.use_hidden_gate = use_hidden_gate
        self.num_layers = len(fc_sizes)
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        if use_embedding_gate:
            self.embedding_gate_weight = normal_param((num_sparse, 1), 1.0,
                                                      device, generator)
        fan_in = num_sparse * embedding_dim + dense_dim
        for i, size in enumerate(fc_sizes):
            self.add_module(f"fc_{i}", scaled_dense(
                fan_in, size, device=device, generator=generator))
            if use_hidden_gate:
                setattr(self, f"hidden_gate_weight_{i}", normal_param(
                    (size, size), 1.0 / math.sqrt(size), device, generator))
            fan_in = size
        self.last_layer = scaled_dense(fan_in, 1, device=device,
                                       generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)  # (B, S, E)
        if self.use_embedding_gate:
            gate = torch.sigmoid(
                (emb * self.embedding_gate_weight).sum(dim=-1, keepdim=True))
            emb = emb * gate
        x = torch.cat([emb.reshape(emb.shape[0], -1).to(dense.dtype), dense],
                      dim=-1)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
            if self.use_hidden_gate:
                x = x * torch.tanh(x @ getattr(self, f"hidden_gate_weight_{i}"))
        return self.last_layer(x)[:, 0]


@register_model("rank.gatenet")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.fc_sizes = list(config.hyper("fc_sizes", [512, 256, 128, 32]))
        self.use_embedding_gate = bool(config.hyper("use_embedding_gate", True))
        self.use_hidden_gate = bool(config.hyper("use_hidden_gate", True))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return GateNet(
            self.vocab_size, self.embedding_dim, self.fc_sizes,
            self.num_sparse, self.dense_dim, self.use_embedding_gate,
            self.use_hidden_gate, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )
