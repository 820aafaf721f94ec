"""Share-bottom multitask: a shared bottom layer and one tower per task.

Counterpart of ``paddlerec_tpu/models/multitask/share_bottom/model.py``,
registered as ``multitask.share_bottom``: ``bottom`` (relu), then per task
``tower_<t>`` (relu) and ``head_<t>`` (sigmoid), on Census features.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.multitask.base import DenseMultitaskModelDef
from paddlerec_tpu_torch.ops.layers import flax_dense


class ShareBottomNet(nn.Module):
    def __init__(self, feature_size: int, bottom_size: int = 117, tower_size: int = 8,
                 task_num: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.task_num = task_num
        self.bottom = flax_dense(feature_size, bottom_size, **kw)
        for t in range(task_num):
            self.add_module(f"tower_{t}", flax_dense(bottom_size, tower_size, **kw))
            self.add_module(f"head_{t}", flax_dense(tower_size, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, F) → (B, T)
        bottom = torch.relu(self.bottom(x))
        outs = [torch.sigmoid(getattr(self, f"head_{t}")(
            torch.relu(getattr(self, f"tower_{t}")(bottom))))[:, 0]
            for t in range(self.task_num)]
        return torch.stack(outs, dim=-1)


@register_model("multitask.share_bottom")
class ModelDef(DenseMultitaskModelDef):
    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        h = self.config.hyper
        return ShareBottomNet(self.feature_size, int(h("bottom_size", 117)),
                              int(h("tower_size", 8)), int(h("task_num", 2)),
                              device=device, generator=generator)
