"""MMoE: a multi-gate mixture of experts over Census features.

Counterpart of ``paddlerec_tpu/models/multitask/mmoe/model.py``, registered
as ``multitask.mmoe``: ``experts``, a ``DenseGeneral`` to ``(expert_num,
expert_size)`` (relu); per task a softmax gate ``gate_<t>`` over the
experts, the gated mix, ``tower_<t>`` (relu) and ``head_<t>`` (sigmoid).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.multitask.base import DenseMultitaskModelDef
from paddlerec_tpu_torch.ops.layers import DenseGeneral, flax_dense


class MMoENet(nn.Module):
    def __init__(self, feature_size: int, expert_num: int = 8, expert_size: int = 16,
                 tower_size: int = 8, gate_num: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.gate_num = gate_num
        self.experts = DenseGeneral(feature_size, (expert_num, expert_size), **kw)
        for t in range(gate_num):
            self.add_module(f"gate_{t}", flax_dense(feature_size, expert_num, **kw))
            self.add_module(f"tower_{t}", flax_dense(expert_size, tower_size, **kw))
            self.add_module(f"head_{t}", flax_dense(tower_size, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, F) → (B, T)
        e = torch.relu(self.experts(x))  # (B, N, E)
        outs = []
        for t in range(self.gate_num):
            gate = torch.softmax(getattr(self, f"gate_{t}")(x), dim=-1)  # (B, N)
            mixed = torch.einsum("bne,bn->be", e, gate)
            h = torch.relu(getattr(self, f"tower_{t}")(mixed))
            outs.append(torch.sigmoid(getattr(self, f"head_{t}")(h))[:, 0])
        return torch.stack(outs, dim=-1)


@register_model("multitask.mmoe")
class ModelDef(DenseMultitaskModelDef):
    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        h = self.config.hyper
        return MMoENet(self.feature_size, int(h("expert_num", 8)), int(h("expert_size", 16)),
                       int(h("tower_size", 8)), int(h("gate_num", 2)),
                       device=device, generator=generator)
