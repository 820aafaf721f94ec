"""Sequence layers of the behaviour-sequence models: GRU, AUGRU, LSTM,
BiLSTM, the sinusoidal position table and the transformer encoder block.

Counterparts of ``paddlerec_tpu/ops/sequence.py``, with the flax tree's
parameter names.  The JAX package runs each recurrence as an ``nn.scan`` that
XLA compiles into one fused step; here it is a Python loop over the time
axis, a handful of small launches per step (``PERF.md`` section 5 counts
them).  The input projections are computed for all steps at once and
unbound along time, and each step's gates split, not sliced: their backward
is then one stack or concatenation, where indexing would zero-fill a
full-size gradient for every step.  The cells are written out because
``torch.nn.GRU`` / cuDNN keep another layout: flax's recurrent weight ``wh``
has no bias, the GRU's gates are ordered r, z, n with
``n = tanh(xn + r * hn)``, the LSTM's i, f, g, o.
Every recurrence keeps the carry where the mask is 0 (``where(m > 0, h_new,
h)``), so padded positions leave the state alone.

Attention is plain torch (``einsum`` and ``softmax``), as the JAX package left
it to XLA; masked scores are filled with the same finite -1e9, so a row with
no valid key gets uniform weights as in JAX, not the NaN that -inf or a
boolean attention mask would give.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.ops.layers import _ACTIVATIONS, LayerNorm, flax_dense


def _keep(mask: Optional[torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, T) mask → T (B, 1) booleans: the rows whose carry steps at each
    position (all of them without a mask)."""
    if mask is None:
        return (torch.ones(x.shape[0], 1, dtype=torch.bool, device=x.device),) * x.shape[1]
    return (mask > 0)[..., None].unbind(1)


class GRU(nn.Module):
    """Masked GRU over (B, T, D) → outputs (B, T, H), final state (B, H).
    Parameters ``wi`` (D → 3H, with bias) and ``wh`` (H → 3H, no bias)."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.wi = flax_dense(input_size, 3 * hidden_size, device, generator)
        self.wh = flax_dense(hidden_size, 3 * hidden_size, device, generator,
                             bias=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                att: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hs = self.hidden_size
        keep = _keep(mask, x)
        a = None if att is None else att.unbind(1)
        h = x.new_zeros(x.shape[0], hs)
        outs = []
        for t, xi_t in enumerate(self.wi(x).unbind(1)):  # (B, 3H) each
            x_rz, x_n = xi_t.split([2 * hs, hs], dim=-1)
            h_rz, h_n = self.wh(h).split([2 * hs, hs], dim=-1)
            r, z = torch.sigmoid(x_rz + h_rz).chunk(2, dim=-1)
            n = torch.tanh(x_n + r * h_n)
            if a is None:
                h_new = (1 - z) * n + z * h
            else:  # AUGRU: the attention scales the update gate
                z = z * a[t][:, None]
                h_new = (1 - z) * h + z * n
            h = torch.where(keep[t], h_new, h)
            outs.append(h)
        return torch.stack(outs, dim=1), h


class AUGRU(GRU):
    """GRU with an attention-scaled update gate (DIEN's interest evolution):
    ``z = sigmoid(xz + hz) * att_t``, ``h = (1 - z) * h + z * n``.  att (B, T)
    scores in [0, 1]."""

    def forward(self, x: torch.Tensor, att: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return super().forward(x, mask, att)


class LSTM(nn.Module):
    """Masked LSTM over (B, T, D) → outputs (B, T, H), final state h (B, H).
    Parameters ``wi`` (D → 4H, with bias) and ``wh`` (H → 4H, no bias); gates
    i, f, g, o.  ``reverse`` runs over the whole padded time axis backwards
    and returns the outputs in the input's order."""

    def __init__(self, input_size: int, hidden_size: int, reverse: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.wi = flax_dense(input_size, 4 * hidden_size, device, generator)
        self.wh = flax_dense(hidden_size, 4 * hidden_size, device, generator,
                             bias=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        keep = _keep(mask, x)
        xs = self.wi(x).unbind(1)  # (B, 4H) each
        h = c = x.new_zeros(x.shape[0], self.hidden_size)
        steps = range(len(xs) - 1, -1, -1) if self.reverse else range(len(xs))
        outs = [None] * len(xs)
        for t in steps:
            gates = xs[t] + self.wh(h)
            i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
            g = torch.tanh(gates.chunk(4, dim=-1)[2])
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            h = torch.where(keep[t], h_new, h)
            c = torch.where(keep[t], c_new, c)
            outs[t] = h
        return torch.stack(outs, dim=1), h


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM (layers ``fwd_i`` / ``bwd_i``) → (B, T, 2H),
    the forward and backward outputs concatenated."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        size = input_size
        for i in range(num_layers):
            self.add_module(f"fwd_{i}", LSTM(size, hidden_size, device=device,
                                             generator=generator))
            self.add_module(f"bwd_{i}", LSTM(size, hidden_size, reverse=True,
                                             device=device, generator=generator))
            size = 2 * hidden_size

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        out = x
        for i in range(self.num_layers):
            fwd, _ = getattr(self, f"fwd_{i}")(out, mask)
            bwd, _ = getattr(self, f"bwd_{i}")(out, mask)
            out = torch.cat([fwd, bwd], dim=-1)
        return out


@functools.lru_cache(maxsize=None)
def positions(n: int, size: int, device: torch.device) -> torch.Tensor:
    """``min(arange(n), size - 1)`` as int32 on ``device``: the position ids
    of a sequence of ``n`` into a table of ``size`` rows, kept once per device
    (an index tensor, not a buffer: artifacts load into a ``meta`` module)."""
    return torch.clamp(torch.arange(n, dtype=torch.int32, device=device), max=size - 1)


@functools.lru_cache(maxsize=None)
def sinusoidal_position_encoding(t: int, d: int,
                                 device: torch.device = torch.device("cpu")
                                 ) -> torch.Tensor:
    """The sin/cos position table (T, D), built in float64 numpy as the JAX
    function builds it, cast to float32 and kept once per device (a table,
    not a buffer: artifacts load into a ``meta`` module)."""
    pos = np.arange(t)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / max(d, 1))
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32)).to(device)


class TransformerBlock(nn.Module):
    """Post-norm transformer encoder block with a key-padding mask, as BST,
    DSIN and DPIN use it: ``q``, ``k``, ``v`` (D → heads·head_dim), ``proj``
    (→ D), ``ln1`` over ``x + attention``, ``ffn1`` / ``ffn2`` with relu or
    flax's gelu (tanh form), ``ln2`` over ``x + ffn``.  x (B, T, D), mask
    (B, T) → (B, T, D)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, ffn_dim: int,
                 ffn_activation: str = "relu", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.act = _ACTIVATIONS[ffn_activation]
        inner = num_heads * head_dim
        for name in ("q", "k", "v"):
            self.add_module(name, flax_dense(dim, inner, device, generator))
        self.proj = flax_dense(inner, dim, device, generator)
        self.ln1 = LayerNorm(dim, device=device)
        self.ffn1 = flax_dense(dim, ffn_dim, device, generator)
        self.ffn2 = flax_dense(ffn_dim, dim, device, generator)
        self.ln2 = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim

        def heads(fc):
            return fc(x).reshape(b, t, h, hd).transpose(1, 2)  # (B, H, T, hd)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        scores = scores.masked_fill(mask[:, None, None, :] <= 0, -1e9)
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        out = self.proj(out.transpose(1, 2).reshape(b, t, h * hd))
        x = self.ln1(x + out)
        return self.ln2(x + self.ffn2(self.act(self.ffn1(x))))
