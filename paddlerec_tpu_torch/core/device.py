"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A missing
CUDA device is an error, never a silent move to the CPU: a run that was
meant for the card and ran on the host would report the host's numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

# batch entries the host reads in the step (counts that size an allocation):
# they stay on the CPU, so reading them waits for nothing on the device
HOST_KEYS = frozenset({"sparse_num_uniq"})


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU"
        )
    return dev


def full_float32_matmul() -> None:
    """Full float32 products and convolutions on the card: the parity
    tolerances against the JAX package assume it (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensors(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch → tensors on ``device`` (``HOST_KEYS`` stay on the CPU).
    float64 becomes float32, as JAX's default (64-bit mode off) does for
    the reference."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # a read-only mmap view: torch wants its own
            a = a.copy()
        out[k] = torch.from_numpy(a) if k in HOST_KEYS else torch.from_numpy(a).to(device)
    return out
