"""PLE: progressive layered extraction, stacked CGC layers.

Counterpart of ``paddlerec_tpu/models/multitask/ple/model.py``, registered
as ``multitask.ple``: ``level_number`` layers ``cgc_<l>``, each with
per-task expert groups ``task_exp_<t>`` and shared experts ``shared_exp``
(``DenseGeneral``, relu); a task's gate mixes its own and the shared
experts, and on every level but the last ``gate_shared`` mixes all of them
into the next level's shared input; then ``tower_<t>`` (relu) and
``head_<t>`` (sigmoid).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.multitask.base import DenseMultitaskModelDef
from paddlerec_tpu_torch.ops.layers import DenseGeneral, flax_dense


class CGCLayer(nn.Module):
    """inputs: ``task_num + 1`` tensors (each task's, then the shared one)
    → ``task_num`` outputs, plus the shared one unless ``is_last``."""

    def __init__(self, in_dim: int, task_num: int, exp_per_task: int, shared_num: int,
                 expert_size: int, is_last: bool, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.task_num, self.is_last = task_num, is_last
        for t in range(task_num):
            self.add_module(f"task_exp_{t}",
                            DenseGeneral(in_dim, (exp_per_task, expert_size), **kw))
        self.shared_exp = DenseGeneral(in_dim, (shared_num, expert_size), **kw)
        for t in range(task_num):
            self.add_module(f"gate_{t}", flax_dense(in_dim, exp_per_task + shared_num, **kw))
        if not is_last:
            self.gate_shared = flax_dense(in_dim, task_num * exp_per_task + shared_num, **kw)

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        experts = [torch.relu(getattr(self, f"task_exp_{t}")(inputs[t]))
                   for t in range(self.task_num)]  # (B, P, E) each
        shared = torch.relu(self.shared_exp(inputs[-1]))  # (B, S, E)
        outs = []
        for t in range(self.task_num):
            pool = torch.cat([experts[t], shared], dim=1)
            gate = torch.softmax(getattr(self, f"gate_{t}")(inputs[t]), dim=-1)
            outs.append(torch.einsum("bne,bn->be", pool, gate))
        if not self.is_last:
            pool = torch.cat(experts + [shared], dim=1)
            gate = torch.softmax(self.gate_shared(inputs[-1]), dim=-1)
            outs.append(torch.einsum("bne,bn->be", pool, gate))
        return outs


class PLENet(nn.Module):
    def __init__(self, feature_size: int, task_num: int = 2, exp_per_task: int = 3,
                 shared_num: int = 1, expert_size: int = 16, tower_size: int = 8,
                 level_number: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.task_num, self.level_number = task_num, level_number
        for lvl in range(level_number):
            self.add_module(f"cgc_{lvl}", CGCLayer(
                feature_size if lvl == 0 else expert_size, task_num, exp_per_task,
                shared_num, expert_size, lvl == level_number - 1, **kw))
        for t in range(task_num):
            self.add_module(f"tower_{t}", flax_dense(expert_size, tower_size, **kw))
            self.add_module(f"head_{t}", flax_dense(tower_size, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, F) → (B, T)
        inputs = [x] * (self.task_num + 1)
        for lvl in range(self.level_number):
            inputs = getattr(self, f"cgc_{lvl}")(inputs)
        outs = [torch.sigmoid(getattr(self, f"head_{t}")(
            torch.relu(getattr(self, f"tower_{t}")(inputs[t]))))[:, 0]
            for t in range(self.task_num)]
        return torch.stack(outs, dim=-1)


@register_model("multitask.ple")
class ModelDef(DenseMultitaskModelDef):
    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        h = self.config.hyper
        return PLENet(self.feature_size, int(h("task_num", 2)), int(h("exp_per_task", 3)),
                      int(h("shared_num", 1)), int(h("expert_size", 16)),
                      int(h("tower_size", 8)), int(h("level_number", 1)),
                      device=device, generator=generator)
