"""UAPI: the high-level model facade of the port (``paddlerec_tpu/uapi``).

``RankModel(model_name)`` exposes train / evaluate / export / infer /
predict / compression with per-API prechecks, calling the port's tools
in-process with the same config-override semantics as ``-o key=value``.
"""

from paddlerec_tpu_torch.uapi.model import RankModel, UnsupportedAPIError

__all__ = ["RankModel", "UnsupportedAPIError"]
