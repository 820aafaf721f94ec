"""Checkpoint save/load.

Counterpart of ``paddlerec_tpu/train/checkpoint.py``, with the same layout:
per-epoch numbered directories under ``runner.model_save_path``, each holding
``state`` (parameters + optimizer state, and the row-wise side state of a
sparse run, for exact resume), and a
``donefile.txt`` in the save root whose lines ``<tag>\\t<path>`` record the
finished epochs, so resume is one read.

The JAX package writes ``state`` with orbax, which the port cannot read or
write; here ``state`` is a directory with one ``checkpoint.pt``
(``torch.save`` of ``{"params": state_dict, "opt_state": ...}`` and, for a
sparse run, ``"extra": {key: {field: tensor}}``; tensors on the CPU).  A JAX checkpoint crosses over only through
``convert.from_jax_params``.

The published base of the online loop (``save_params_only``, the JAX
package's inference-model analog) holds the parameters alone: a ``params``
directory beside where ``state`` would be, with one ``checkpoint.pt`` (the
state_dict on the CPU).  It adds no donefile line: the online loop records
it in its own donefile.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from paddlerec_tpu_torch.utils.fs import get_fs

DONEFILE = "donefile.txt"
_PAYLOAD = "checkpoint.pt"


def _ckpt_dir(root: str, tag) -> str:
    return os.path.join(os.path.abspath(root), str(tag))


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if hasattr(tree, "_asdict"):  # a row-wise state: saved as a plain dict
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_model(params: Mapping[str, torch.Tensor], opt_state: Any, root: str,
               tag, extra: Optional[Mapping[str, Any]] = None) -> str:
    """Save params+opt(+extra) under root/tag/state and update the donefile."""
    path = _ckpt_dir(root, tag)
    payload = {"params": _to_cpu(params), "opt_state": _to_cpu(opt_state)}
    if extra is not None:
        payload["extra"] = _to_cpu(extra)
    _save_atomic(payload, os.path.join(path, "state"))
    done = os.path.join(os.path.abspath(root), DONEFILE)
    get_fs(done).append_line(done, f"{tag}\t{path}")
    return path


def _save_atomic(payload: Any, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, _PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(directory, _PAYLOAD))  # atomic


def save_params_only(params: Mapping[str, torch.Tensor], root: str, tag) -> str:
    """Save the parameters alone under root/tag/params (no optimizer
    state); returns root/tag."""
    path = _ckpt_dir(root, tag)
    _save_atomic(_to_cpu(params), os.path.join(path, "params"))
    return path


def load_params_only(root: str, tag) -> Dict[str, torch.Tensor]:
    """The state_dict of ``save_params_only``, tensors on the CPU."""
    path = os.path.join(_ckpt_dir(root, tag), "params", _PAYLOAD)
    return torch.load(path, map_location="cpu", weights_only=True)


def has_params_only(root: str, tag) -> bool:
    return os.path.exists(os.path.join(_ckpt_dir(root, tag), "params", _PAYLOAD))


def load_model(root: str, tag) -> Tuple[Dict[str, torch.Tensor], Any, Any]:
    """Load (params, opt_state, extra) from root/tag, tensors on the CPU;
    ``extra`` is None for a checkpoint without row-wise side state."""
    path = os.path.join(_ckpt_dir(root, tag), "state", _PAYLOAD)
    restored = torch.load(path, map_location="cpu", weights_only=True)
    return restored["params"], restored["opt_state"], restored.get("extra")


def last_saved_tag(root: str) -> Optional[str]:
    """Latest tag recorded in the donefile (resume point), or None."""
    done = os.path.join(os.path.abspath(root), DONEFILE)
    fs = get_fs(done)
    if not fs.exists(done):
        return None
    lines = [l.strip() for l in fs.read_text(done).splitlines() if l.strip()]
    if not lines:
        return None
    return lines[-1].split("\t")[0]


def load_params_from_state(root: str, tag) -> Dict[str, torch.Tensor]:
    """Restore ONLY the params of a checkpoint, so export and inference
    tools load a checkpoint saved under any optimizer config: those of a
    full train checkpoint, or a params-only one (``save_params_only``)."""
    if has_params_only(root, tag):
        return load_params_only(root, tag)
    return load_model(root, tag)[0]
