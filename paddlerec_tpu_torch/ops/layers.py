"""Shared layers: the MLP tower and the FM second-order interaction.

Counterparts of ``MLP`` and ``fm_second_order`` in
``paddlerec_tpu/ops/layers.py``.  Dense products stay ``nn.Linear`` (cuBLAS
on the card), as the JAX package left them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default gelu
    "leaky_relu": F.leaky_relu,  # slope 0.01 in both frameworks
    "prelu": F.relu,  # as in the JAX package
    "none": lambda x: x,
    "linear": lambda x: x,
}


class MLP(nn.Module):
    """Stacked fully-connected tower (layers ``fc_0``, ``fc_1``, ...).

    As in the JAX package, ``activation`` follows the LAST layer too when
    ``output_activation`` is None.  Weights init normal(1/sqrt(fan_in)),
    biases zero.
    """

    def __init__(self, in_dim: int, layer_sizes: Sequence[int],
                 activation: str = "relu",
                 output_activation: Optional[str] = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.out_act = _ACTIVATIONS[output_activation or activation]
        self.num_layers = len(layer_sizes)
        fan_in = in_dim
        for i, size in enumerate(layer_sizes):
            fc = nn.Linear(fan_in, size, bias=use_bias, device=device, dtype=dtype)
            with torch.no_grad():
                fc.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if use_bias:
                    fc.bias.zero_()
            self.add_module(f"fc_{i}", fc)
            fan_in = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc_{i}")(x)
            x = self.act(x) if i < self.num_layers - 1 else self.out_act(x)
        return x


def flax_dense(in_dim: int, out_dim: int, device=None,
               generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A linear layer initialized as flax's ``Dense`` default:
    ``lecun_normal`` weights (a normal of variance 1/fan_in, truncated at
    two standard deviations), zero bias."""
    fc = nn.Linear(in_dim, out_dim, device=device)
    with torch.no_grad():
        std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
        nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        fc.bias.zero_()
    return fc


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """FM second-order interaction: 0.5 * ((Σv)² − Σv²) summed over dim.

    emb: (B, S, E) field embeddings → (B,) interaction scalar, in emb's dtype.
    """
    summed = emb.sum(dim=1)  # (B, E)
    sum_sq = summed * summed
    sq_sum = (emb * emb).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=-1)
