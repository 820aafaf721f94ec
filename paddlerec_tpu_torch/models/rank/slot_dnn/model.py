"""slot_dnn: slot-based online-learning CTR DNN.

Counterpart of ``paddlerec_tpu/models/rank/slot_dnn/model.py``, registered
as ``rank.slot_dnn``: the CtrDnn net, reported with the full CTR metric
bundle the streaming AUC state already carries.
"""

from __future__ import annotations

from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.rank.dnn.model import ModelDef as DnnModelDef


@register_model("rank.slot_dnn")
class ModelDef(DnnModelDef):
    pass
