"""FGCNN: feature generation by CNN + deep classifier.

Counterpart of ``paddlerec_tpu/models/rank/fgcnn/model.py``, registered as
``rank.fgcnn``: convolutions and poolings over the (fields × embedding)
image generate feature maps that are recombined into extra fields; original
and generated fields feed an inner-product interaction and a DNN.

flax convolves NHWC, ``Conv2d`` NCHW.  ``convert`` carries the 4-D kernels
``(H, W, in, out)`` ↔ ``(out, in, H, W)``; the flatten before
``recombine_i`` runs over ``(fields, E, channels)`` in the JAX module, so the
maps are permuted back to that order before it and the converted
``recombine_i`` weights meet their own columns.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import MLP, flax_dense, lecun_normal_, triu_pairs


def flax_conv(in_channels: int, out_channels: int, kernel_rows: int,
              device=None,
              generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """A ``(kernel_rows, 1)`` convolution with flax's ``Conv`` defaults:
    ``padding="SAME"`` at stride 1 (``kernel_rows`` odd), ``lecun_normal``
    weights over fan_in = kernel_rows · in_channels, zero bias."""
    conv = nn.Conv2d(in_channels, out_channels, (kernel_rows, 1),
                     padding=(kernel_rows // 2, 0), device=device)
    lecun_normal_(conv.weight, kernel_rows * in_channels, generator)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


class FGCNNNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``,
    ``conv_i`` (weight (out, in, 7, 1)), ``recombine_i``, ``tower.fc_i``,
    ``head``."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 dense_dim: int, conv_filters: Sequence[int] = (38, 40),
                 new_maps: Sequence[int] = (3, 3),
                 pool_sizes: Sequence[int] = (2, 2),
                 fc_sizes: Sequence[int] = (128, 64),
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        e = embedding_dim
        self.pool_sizes = list(pool_sizes)[:min(len(conv_filters), len(new_maps))]
        self.embedding = SlotEmbedding(
            vocab_size, e, device=device, generator=generator,
            **(table_kwargs or {}),
        )
        fields, channels, total = num_fields, 1, num_fields
        for i, (filt, maps, pool) in enumerate(
                zip(conv_filters, new_maps, pool_sizes)):
            self.add_module(f"conv_{i}", flax_conv(channels, filt, 7, device,
                                                   generator))
            fields //= pool
            self.add_module(f"recombine_{i}", flax_dense(
                fields * e * filt, fields * maps * e, device=device,
                generator=generator))
            channels = filt
            total += fields * maps
        self.num_all_fields = total
        self.tower = MLP(total * e + total * (total - 1) // 2 + dense_dim,
                         fc_sizes, device=device, generator=generator)
        self.head = flax_dense(fc_sizes[-1], 1, device=device,
                               generator=generator)

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(sparse_ids).to(dense.dtype)  # (B, S, E)
        b, _, e = emb.shape
        x = emb[:, None]  # (B, 1, S, E): one channel
        generated = []
        for i, pool in enumerate(self.pool_sizes):
            x = torch.tanh(getattr(self, f"conv_{i}")(x))
            x = F.max_pool2d(x, (pool, 1))  # the remainder rows are dropped
            flat = x.permute(0, 2, 3, 1).reshape(b, -1)  # (fields, E, channels)
            new_feats = torch.tanh(getattr(self, f"recombine_{i}")(flat))
            generated.append(new_feats.reshape(b, -1, e))
        all_fields = torch.cat([emb] + generated, dim=1)  # (B, F', E)
        dots = torch.einsum("bie,bje->bij", all_fields, all_fields)
        i, j = triu_pairs(all_fields.shape[1], 1, dots.device)
        dnn_in = torch.cat([all_fields.reshape(b, -1), dots[:, i, j], dense],
                           dim=-1)
        return self.head(self.tower(dnn_in))[:, 0]


@register_model("rank.fgcnn")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.conv_filters = list(config.hyper("conv_filters", [38, 40]))
        self.new_maps = list(config.hyper("new_maps", [3, 3]))
        self.pool_sizes = list(config.hyper("pooling_sizes", [2, 2]))
        self.fc_sizes = list(config.hyper("fc_sizes", [128, 64]))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return FGCNNNet(
            self.vocab_size, self.embedding_dim, self.num_sparse,
            self.dense_dim, self.conv_filters, self.new_maps, self.pool_sizes,
            self.fc_sizes, table_kwargs=self.table_kwargs(), device=device,
            generator=generator,
        )
