"""Shared layers of the rank and multitask models: the MLP tower, the FM
terms, the three cross networks, CIN, DIN's target attention, and flax's
``LayerNorm``, ``DenseGeneral`` and ``Conv`` with their initializers.

Counterparts of ``MLP``, ``FMFirstOrder``, ``fm_second_order``,
``FMInteraction``, ``CrossNet``, ``CrossNetV2``, ``CrossNetMix``, ``CIN`` and
``TargetAttention`` in ``paddlerec_tpu/ops/layers.py`` and of flax's
``nn.LayerNorm``, ``nn.DenseGeneral`` and ``nn.Conv`` (``"SAME"`` padding:
``SameConv1d``, ``SameConv2d``), with the flax tree's parameter names, and
the masked max over time of the text models (``masked_max``).
Dense products stay ``nn.Linear`` / ``torch.einsum`` (cuBLAS on the card), as
the JAX package left them to XLA outside any Pallas kernel; the one lookup
here (``FMFirstOrder``) goes through kernel K1.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from paddlerec_tpu_torch.ops.packed_embedding import (
    init_packed_table, packed_lookup,
)

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


def scaled_dense(in_dim: int, out_dim: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A linear layer with normal(1/sqrt(fan_in)) weights and zero bias: the
    init of the towers' layers."""
    fc = nn.Linear(in_dim, out_dim, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        fc.weight.normal_(0.0, 1.0 / math.sqrt(in_dim), generator=generator)
        if bias:
            fc.bias.zero_()
    return fc


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
            self.add_module(f"fc_{i}", scaled_dense(
                fan_in, size, use_bias, dtype, device, generator))
            fan_in = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"fc_{i}")(x)
            x = self.act(x) if i < self.num_layers - 1 else self.out_act(x)
        return x


def flax_dense(in_dim: int, out_dim: int, device=None,
               generator: Optional[torch.Generator] = None,
               bias: bool = True) -> nn.Linear:
    """A linear layer initialized as flax's ``Dense`` default:
    ``lecun_normal`` weights (a normal of variance 1/fan_in, truncated at
    two standard deviations), zero bias (or none: ``use_bias=False``)."""
    fc = nn.Linear(in_dim, out_dim, bias=bias, device=device)
    lecun_normal_(fc.weight, in_dim, generator)
    if bias:
        with torch.no_grad():
            fc.bias.zero_()
    return fc


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal of variance 1/fan_in,
    truncated at two standard deviations (and rescaled for the cut)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def flax_conv2d(in_ch: int, out_ch: int, kernel: int, padding: int = 0,
                groups: int = 1, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """A square ``Conv2d`` initialized as flax's ``Conv`` default:
    ``lecun_normal`` over fan_in = kernel²·in/groups, zero bias.  flax's
    kernel ``(k, k, in/groups, out)`` is the weight ``(out, in/groups, k,
    k)`` (``convert.py`` permutes the axes both ways); ``padding`` 0 is
    flax's ``"VALID"``."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=padding, groups=groups,
                     device=device)
    lecun_normal_(conv.weight, kernel * kernel * in_ch // groups, generator)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


def _same_pads(kernel: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding of a stride-1 window: ``(k-1)//2`` before
    and the rest after, so an even kernel pads one more after."""
    return (kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2


class SameConv1d(nn.Conv1d):
    """flax's ``nn.Conv(out, kernel_size=(k,), padding="SAME")`` over (N, T,
    C) → (N, T, out), initialized as flax's default (``lecun_normal`` over
    fan_in = k·in, zero bias).  flax's kernel ``(k, in, out)`` is the weight
    ``(out, in, k)`` (``convert.py`` reverses the axes both ways)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel, device=device)
        lecun_normal_(self.weight, kernel * in_ch, generator)
        with torch.no_grad():
            self.bias.zero_()
        self.pads = _same_pads(kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), self.pads)
        return super().forward(x).transpose(1, 2)


class SameConv2d(nn.Conv2d):
    """flax's ``nn.Conv(out, kernel_size=(kh, kw), padding="SAME")`` over
    (N, H, W, C) → (N, H, W, out), initialized as flax's default
    (``lecun_normal`` over fan_in = kh·kw·in, zero bias).  flax's kernel
    ``(kh, kw, in, out)`` is the weight ``(out, in, kh, kw)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, tuple(kernel), device=device)
        lecun_normal_(self.weight, kernel[0] * kernel[1] * in_ch, generator)
        with torch.no_grad():
            self.bias.zero_()
        # F.pad takes the last axis first: (W before, W after, H before, H after)
        self.pads = _same_pads(kernel[1]) + _same_pads(kernel[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.permute(0, 3, 1, 2), self.pads)
        return super().forward(x).permute(0, 2, 3, 1)


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``jnp.where(mask[..., None] > 0, x, -1e9).max(axis=1)`` over (N, T,
    C): a row whose mask is all zero gets -1e9, and the gradient of a tie is
    split evenly among the tied entries, as ``jnp.max``'s is."""
    return torch.amax(torch.where(mask[..., None] > 0, x, -1e9), dim=1)


class DenseGeneral(nn.Module):
    """flax's ``nn.DenseGeneral(features=(N, E))`` over the last axis: x
    (..., in) → (..., N, E).  flax's kernel is ``(in, N, E)`` and its bias
    ``(N, E)``; the weight here is that kernel's transpose ``(E, N, in)``,
    which is what ``convert.py`` makes of every ``kernel`` leaf that is not
    4-D, so the names and the conversion are those of ``nn.Linear``.  Init
    as flax's: ``lecun_normal`` over fan_in = in (flax flattens the feature
    axes), zero bias."""

    def __init__(self, in_dim: int, features: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n, e = features
        self.weight = nn.Parameter(torch.empty((e, n, in_dim), device=device))
        lecun_normal_(self.weight, in_dim, generator)
        self.bias = nn.Parameter(torch.zeros((n, e), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...i,eni->...ne", x, self.weight) + self.bias


def normal_param(shape, stddev: float, device=None,
                 generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """A float32 parameter drawn normal(0, stddev) from ``generator``."""
    return nn.Parameter(
        torch.randn(shape, generator=generator, device=device) * stddev)


@functools.lru_cache(maxsize=None)
def triu_pairs(n: int, offset: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column indices of the upper triangle of an (n, n) matrix in
    row-major order (``jnp.triu_indices(n, k=offset)``), on ``device``; built
    once per device and kept."""
    i, j = torch.triu_indices(n, n, offset=offset, device=device)
    return i, j


@functools.lru_cache(maxsize=None)
def triu_mask(n: int, device: torch.device) -> torch.Tensor:
    """The (n, n) float32 mask of the strict upper triangle, on ``device``;
    built once per device and kept."""
    return torch.triu(torch.ones((n, n), device=device), diagonal=1)


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """FM second-order interaction: 0.5 * ((Σv)² − Σv²) summed over dim.

    emb: (B, S, E) field embeddings → (B,) interaction scalar, in emb's dtype.
    """
    summed = emb.sum(dim=1)  # (B, E)
    sum_sq = summed * summed
    sq_sum = (emb * emb).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=-1)


class FMFirstOrder(nn.Module):
    """First-order FM term: a rank-1 weight per sparse id, summed over the
    slots, plus ``dense @ dense_w`` (with ``dense_dim > 0``) and a scalar
    bias.  ``sparse_w`` is a packed table of logical width 1 (16 ids per
    128-lane row), read through one K1 launch on its ``(R·16, 8)`` view.  As
    in the JAX package it is a raw parameter, not a ``SlotEmbedding``: always
    float32, never in external-update mode."""

    def __init__(self, vocab_size: int, dense_dim: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.sparse_w = nn.Parameter(init_packed_table(
            vocab_size, 1, stddev=1e-4, generator=generator, device=device))
        if dense_dim:
            self.dense_w = normal_param((dense_dim,), 1e-4, device, generator)
        self.bias = nn.Parameter(torch.zeros((), device=device))

    def forward(self, sparse_ids: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = (sparse_ids % self.vocab_size).to(torch.int32)
        first = packed_lookup(self.sparse_w, ids, 1).sum(dim=(-2, -1))  # (B,)
        if dense is not None:
            first = first + dense @ self.dense_w
        return first + self.bias


class FMInteraction(nn.Module):
    """Second-order FM over field embeddings (B, S, E); returns (B,) or,
    with ``reduce_dim=False``, the per-lane terms (B, E)."""

    def __init__(self, reduce_dim: bool = True):
        super().__init__()
        self.reduce_dim = reduce_dim

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        summed = emb.sum(dim=1)
        sq_sum = (emb * emb).sum(dim=1)
        pair = 0.5 * (summed * summed - sq_sum)  # (B, E)
        return pair.sum(dim=-1) if self.reduce_dim else pair


class CrossNet(nn.Module):
    """DCN-v1 cross layers: x_{l+1} = x0 * (x_l · w_l) + b_l + x_l.

    ``share_weights``: one ``layer_w`` / ``layer_b`` for all layers (what
    dcn uses); else ``w_i`` / ``b_i`` per layer.  With ``return_l2`` the
    forward also returns Σ_layers Σ (x ⊙ w)², the per-batch product that
    dcn's ``l2_reg_cross`` penalizes."""

    def __init__(self, dim: int, num_layers: int, share_weights: bool = False,
                 return_l2: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.share_weights = share_weights
        self.return_l2 = return_l2
        std = 1.0 / math.sqrt(dim)
        if share_weights:
            self.layer_w = normal_param((dim,), std, device, generator)
            self.layer_b = nn.Parameter(torch.zeros(dim, device=device))
        else:
            for i in range(num_layers):
                setattr(self, f"w_{i}", normal_param((dim,), std, device, generator))
                setattr(self, f"b_{i}",
                        nn.Parameter(torch.zeros(dim, device=device)))

    def forward(self, x0: torch.Tensor):
        x = x0
        l2 = x0.new_zeros(())
        for i in range(self.num_layers):
            if self.share_weights:
                w, b = self.layer_w, self.layer_b
            else:
                w, b = getattr(self, f"w_{i}"), getattr(self, f"b_{i}")
            prod = x * w
            if self.return_l2:
                l2 = l2 + torch.sum(prod ** 2)
            x = x0 * prod.sum(dim=-1, keepdim=True) + b + x
        if self.return_l2:
            return x, l2
        return x


class CrossNetV2(nn.Module):
    """DCN-v2 cross: x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l, with full-rank
    ``cross_i`` linear layers (weights normal(1/√d), zero bias)."""

    def __init__(self, dim: int, num_layers: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"cross_{i}", scaled_dense(
                dim, dim, device=device, generator=generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"cross_{i}")(x) + x
        return x


class CrossNetMix(nn.Module):
    """DCN-v2 low-rank mixture-of-experts cross layer:

    x_{l+1} = Σ_e G_e(x_l) · (x0 ⊙ (U_e tanh(C_e tanh(V_eᵀ x_l)) + b)) + x_l

    Raw parameters per layer ``U_l``, ``V_l`` (e, d, r), ``C_l`` (e, r, r),
    ``b_l`` (d,), ``gate_l`` (e, d); all but the bias normal(1/√d), the JAX
    package's own deviation from the Xavier init of its reference."""

    def __init__(self, dim: int, num_layers: int, low_rank: int = 32,
                 num_experts: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        std = 1.0 / math.sqrt(dim)
        e, r = num_experts, low_rank
        for layer in range(num_layers):
            # in the order the flax module creates them
            setattr(self, f"U_{layer}", normal_param((e, dim, r), std, device, generator))
            setattr(self, f"V_{layer}", normal_param((e, dim, r), std, device, generator))
            setattr(self, f"C_{layer}", normal_param((e, r, r), std, device, generator))
            setattr(self, f"b_{layer}",
                    nn.Parameter(torch.zeros(dim, device=device)))
            setattr(self, f"gate_{layer}", normal_param((e, dim), std, device, generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in range(self.num_layers):
            u, v = getattr(self, f"U_{layer}"), getattr(self, f"V_{layer}")
            c, b = getattr(self, f"C_{layer}"), getattr(self, f"b_{layer}")
            gates = torch.softmax(x @ getattr(self, f"gate_{layer}").T, dim=-1)
            vx = torch.tanh(torch.einsum("bd,edr->ebr", x, v))
            cvx = torch.tanh(torch.einsum("ebr,ers->ebs", vx, c))
            ux = torch.einsum("ebr,edr->ebd", cvx, u)  # (e, B, d)
            expert_out = x0[None] * (ux + b)
            x = torch.einsum("ebd,be->bd", expert_out, gates) + x
        return x


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM) over fields (B, F, E).

    Layer k: X^k_h = Σ_{i,j} W^k_{h,i,j} (X^{k-1}_i ∘ X^0_j), with
    ``cin_w_k`` (size, f_k, f_0) normal(1/√(f_k·f_0)).  As in the JAX
    package the outer product ``z`` (B, f_k, f_0, E) is formed and then
    contracted with W, two einsums, so the order of the sums is the
    reference's; autograd keeps ``z`` for the backward pass.  With
    ``split_half`` every layer but the last sends half of its maps on and
    half to the output, and an odd size raises."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int],
                 split_half: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_sizes = list(layer_sizes)
        self.split_half = split_half
        fk = num_fields
        for k, size in enumerate(self.layer_sizes):
            setattr(self, f"cin_w_{k}", normal_param(
                (size, fk, num_fields), 1.0 / math.sqrt(fk * num_fields),
                device, generator))
            if split_half and k < len(self.layer_sizes) - 1:
                if size % 2:
                    raise ValueError("split_half requires even CIN layer sizes")
                fk = size // 2
            else:
                fk = size

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x0 = xk = emb
        outputs = []
        last = len(self.layer_sizes) - 1
        for k, size in enumerate(self.layer_sizes):
            z = torch.einsum("bie,bje->bije", xk, x0)
            xk_next = torch.einsum("bije,hij->bhe", z, getattr(self, f"cin_w_{k}"))
            if self.split_half and k < last:
                half = size // 2
                direct, xk = xk_next[:, :half], xk_next[:, half:]
            else:
                direct = xk = xk_next
            outputs.append(direct.sum(dim=-1))
        return torch.cat(outputs, dim=-1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: parameters ``scale`` (ones)
    and ``bias`` (zeros), and flax's epsilon, 1e-6 (PyTorch's default is
    1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class TargetAttention(nn.Module):
    """DIN-style target attention over a behaviour history: scores from
    ``att_mlp`` (sigmoid between its layers, none after the last) over
    ``concat[h, t, h - t, h * t]`` per position, optionally scaled by
    ``E^-0.5`` (``scale_scores``), then a softmax over the positions whose
    mask is set (``use_softmax``; the others filled with -1e9, a finite value
    as in the JAX layer, so a row with no valid position gets uniform weights,
    not NaN) or the raw scores times the mask; the weighted sum of the
    history.  history (B, T, E), target (B, E), mask (B, T) → (B, E)."""

    def __init__(self, dim: int, hidden_sizes: Sequence[int] = (80, 40),
                 use_softmax: bool = True, scale_scores: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_softmax = use_softmax
        self.scale_scores = scale_scores
        self.att_mlp = MLP(4 * dim, list(hidden_sizes) + [1], activation="sigmoid",
                           output_activation="none", device=device,
                           generator=generator)

    def forward(self, history: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        tgt = target[:, None, :].expand_as(history)
        feat = torch.cat([history, tgt, history - tgt, history * tgt], dim=-1)
        scores = self.att_mlp(feat)[..., 0]  # (B, T)
        if self.scale_scores:
            scores = scores * history.shape[-1] ** -0.5
        if self.use_softmax:
            weights = torch.softmax(scores.masked_fill(mask <= 0, -1e9), dim=-1)
        else:
            weights = scores * mask
        return torch.einsum("bt,bte->be", weights, history)
