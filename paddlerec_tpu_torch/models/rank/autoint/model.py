"""AutoInt: multi-head self-attention interaction over field embeddings.

Counterpart of ``paddlerec_tpu/models/rank/autoint/model.py``, registered as
``rank.autoint``: the sparse slots and the dense values (each projected to
one field vector) go through stacked interacting layers of multi-head
attention with a residual projection and ReLU, then one linear layer to the
logit.  The attention is written out with ``einsum`` and ``softmax`` as the
JAX module writes it: its scores are not scaled by √d.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import flax_dense, normal_param


class InteractingLayer(nn.Module):
    """One AutoInt block: MHA over the field axis + residual projection
    (``q``, ``k``, ``v``, ``res``, none with a bias)."""

    def __init__(self, in_dim: int, att_dim: int, num_heads: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.att_dim, self.num_heads = att_dim, num_heads
        d = att_dim * num_heads
        for name in ("q", "k", "v", "res"):  # res is created last, as in flax
            self.add_module(name, flax_dense(in_dim, d, device=device,
                                             generator=generator, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, F, D)
        b, f, _ = x.shape

        def split(t):  # (B, F, H*A) → (B, H, F, A)
            return t.reshape(b, f, self.num_heads, self.att_dim).transpose(1, 2)

        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        weights = torch.softmax(torch.einsum("bhfa,bhga->bhfg", qh, kh), dim=-1)
        out = torch.einsum("bhfg,bhga->bhfa", weights, vh)
        out = out.transpose(1, 2).reshape(b, f, -1)
        return torch.relu(out + self.res(x))


class AutoIntNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``dense_field_w`` (D, E), ``att_i.{q,k,v,res}``, ``head``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_sparse: int,
                 dense_dim: int, att_layer_num: int = 3, att_dim: int = 8,
                 num_heads: int = 2,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.att_layer_num = att_layer_num
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        self.dense_field_w = normal_param((dense_dim, embedding_dim), 1e-2,
                                          device, generator)
        width = embedding_dim
        for i in range(att_layer_num):
            self.add_module(f"att_{i}", InteractingLayer(
                width, att_dim, num_heads, device=device, generator=generator))
            width = att_dim * num_heads
        self.head = flax_dense((num_sparse + dense_dim) * width, 1,
                               device=device, generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids)  # (B, S, E)
        dense_fields = dense[..., None] * self.dense_field_w[None]  # (B, D, E)
        x = torch.cat([emb.to(dense_fields.dtype), dense_fields], dim=1)
        for i in range(self.att_layer_num):
            x = getattr(self, f"att_{i}")(x)
        return self.head(x.reshape(x.shape[0], -1))[:, 0]


@register_model("rank.autoint")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.att_layer_num = int(config.hyper(
            "attn_layer_num", config.hyper("att_layer_num", 3)))
        self.att_dim = int(config.hyper("attn_dim", config.hyper("att_dim", 8)))
        self.num_heads = int(config.hyper("num_heads", 2))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return AutoIntNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.dense_dim, self.att_layer_num, self.att_dim, self.num_heads,
            table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
