"""AutoFIS: automatic feature-interaction selection (AutoDeepFM).

Counterpart of ``paddlerec_tpu/models/rank/autofis/model.py``, registered as
``rank.autofis``: DeepFM whose pairwise FM interactions are gated by a
learnable mask over all C(F, 2) pairs, trained in two stages:

  * stage 0 (search): Adam for every leaf but the gate, **GRDA** for the gate
    ``interaction_mask``, so gates shrink exactly to zero; the surviving
    pairs form ``comb_mask`` (``ModelDef.selected_pairs``);
  * stage 1 (``stage: 1`` with ``hyper_parameters.comb_mask``): only the
    named pairs are kept, and everything trains under Adam.

The model takes no dense input (``dense_dim = 0``).  Both normalizations are
the training-mode batch-norm computation without running averages, at
evaluation too, as in the JAX package: per-feature statistics over the batch
with the biased variance.  A served batch of one row therefore has variance
0 and normalizes to its bias.
"""

from __future__ import annotations

import functools
from itertools import combinations
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import CTRModelDef
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.layers import flax_dense
from paddlerec_tpu_torch.train.optimizers import MultiOptimizer, Optimizer

GATE = "interaction_mask"


def _batch_standardize(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """Per-feature statistics over the batch axis, biased variance (computed
    in float32 and cast to x's dtype, as ``jnp.var`` does for bfloat16)."""
    mean = x.mean(dim=0, keepdim=True)
    var = x.float().var(dim=0, unbiased=False, keepdim=True).to(x.dtype)
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


@functools.lru_cache(maxsize=None)
def _pair_indices(pairs, device: torch.device):
    """The left and right field of every pair as index tensors on
    ``device``; built once per pair set and device."""
    left = torch.tensor([p[0] for p in pairs], device=device)
    right = torch.tensor([p[1] for p in pairs], device=device)
    return left, right


class AutoFISNet(nn.Module):
    """Parameters, named as the flax tree names them: ``embedding.embedding``
    (E+1 lanes), ``bin_fc{i}``, ``bin_bn{i}_scale``, ``bin_bn{i}_bias``,
    ``bin_out``, ``interaction_mask`` (pairs,) drawn uniform(0.599, 0.601)."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_fields: int,
                 width: int = 700, depth: int = 5,
                 comb_mask: Optional[Sequence[int]] = None,
                 table_kwargs: Optional[Mapping[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim, self.depth = embedding_dim, depth
        self.embedding = SlotEmbedding(
            vocab_size, embedding_dim + 1, device=device, generator=generator,
            **(table_kwargs or {}),
        )  # lanes [0:E] = emb, lane E = first-order weight
        fan_in = num_fields * embedding_dim
        for i in range(depth):
            self.add_module(f"bin_fc{i}", flax_dense(fan_in, width, device=device,
                                                     generator=generator))
            setattr(self, f"bin_bn{i}_scale",
                    nn.Parameter(torch.ones(width, device=device)))
            setattr(self, f"bin_bn{i}_bias",
                    nn.Parameter(torch.zeros(width, device=device)))
            fan_in = width
        self.bin_out = flax_dense(fan_in, 1, device=device, generator=generator)
        pairs = list(combinations(range(num_fields), 2))
        if comb_mask is not None:
            pairs = [pairs[i] for i in comb_mask]
        self.pairs = tuple(pairs)
        gate = torch.rand(len(pairs), generator=generator, device=device)
        self.interaction_mask = nn.Parameter(0.599 + 0.002 * gate)

    def forward(self, sparse_ids: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        e = self.embedding_dim
        fused = self.embedding(sparse_ids)
        xv = fused[..., :e]  # (B, F, E)
        first = fused[..., e].sum(dim=1)
        h = xv.reshape(xv.shape[0], -1).float()
        for i in range(self.depth):
            h = getattr(self, f"bin_fc{i}")(h)
            h = torch.relu(_batch_standardize(
                h, getattr(self, f"bin_bn{i}_scale"),
                getattr(self, f"bin_bn{i}_bias")))
        h = self.bin_out(h)[:, 0]
        left, right = _pair_indices(self.pairs, xv.device)
        inter = (xv[:, left, :] * xv[:, right, :]).sum(dim=-1)  # (B, P)
        # per-pair standardization over the batch, no scale or bias
        inter = _batch_standardize(inter)
        fm_out = (inter * self.interaction_mask).sum(dim=-1)
        return first + fm_out + h


@register_model("rank.autofis")
class ModelDef(CTRModelDef):
    def __init__(self, config):
        super().__init__(config)
        self.stage = int(config.get("stage", 0))
        self.num_fields = int(config.hyper("num_inputs", self.num_sparse))
        self.num_sparse = self.num_fields
        self.vocab_size = int(config.hyper("input_size", self.vocab_size))
        self.embedding_dim = int(
            config.hyper("embedding_size", self.embedding_dim))
        comb_mask = config.hyper("comb_mask", None)
        if self.stage == 1 and comb_mask is not None:
            comb_mask = tuple(int(i) for i in comb_mask)
        else:
            comb_mask = None
        self.comb_mask = comb_mask
        self.dense_dim = 0
        self.sparse_embed_logical_dim = self.embedding_dim + 1  # fused lane
        self.width = int(config.hyper("width", 700))
        self.depth = int(config.hyper("depth", 5))

    def make_module(self, device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
        return AutoFISNet(
            self.vocab_size, self.embedding_dim, self.num_fields, self.width,
            self.depth, self.comb_mask, table_kwargs=self.table_kwargs(),
            device=device, generator=generator,
        )

    def model_inputs(self, batch):
        return (batch["sparse"], None)

    def create_optimizer(self):
        """Adam alone in stage 1; in the search stage GRDA drives the gate
        sparse while Adam trains the rest.  Adam is ``optax.adam(lr)`` here:
        both moments in the parameter's dtype, no clip, no embedding decay."""
        lr = float(self.config.hyper("optimizer.learning_rate", 0.001))
        adam = Optimizer("adam", lr=lr, mu_dtype=None)
        if self.stage == 1:
            return adam
        grda = Optimizer("grda", lr=lr,
                         grda_c=float(self.config.hyper("grad_c", 0.0005)),
                         grda_mu=float(self.config.hyper("grad_mu", 0.8)))
        return MultiOptimizer(
            {"dense": adam, "gate": grda},
            lambda name: "gate" if GATE in name.split(".") else "dense")

    def selected_pairs(self, params: Mapping[str, Any],
                       threshold: float = 0.0):
        """Host-side: indices of the pairs that survive the search stage (the
        ``comb_mask`` of a stage-1 config), from a ``state_dict``."""
        gate = params[GATE]
        if isinstance(gate, torch.Tensor):
            gate = gate.detach().cpu().numpy()
        return np.nonzero(np.abs(np.asarray(gate)) > threshold)[0].tolist()
