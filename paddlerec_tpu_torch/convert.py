"""Parameter conversion between the JAX package's flax tree and a state_dict.

Names map one to one: the flax path ``tower/fc_0/kernel`` is the state_dict
key ``tower.fc_0.weight``, and every other leaf keeps its name with ``/``
read as ``.``.  A flax ``Dense`` kernel is ``(in, out)`` and an
``nn.Linear`` weight ``(out, in)``, so kernels are transposed.  Values are
copied bit for bit both ways, bfloat16 included.

Optax's Adam moments (``ScaleByAdamState.mu`` / ``.nu``) are trees of the
parameters' shape, so the same mapping carries them into the port's
optimizer state (``train/optimizers.py``) and back.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict → ``/``-joined keys (an already flat dict passes as is)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def _to_torch(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed to hand bf16 back to JAX

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested, or flat with ``/`` keys) → state_dict on the CPU."""
    state = {}
    for path, value in flatten_tree(tree).items():
        head, _, leaf = path.rpartition("/")
        if leaf == "kernel":
            key = f"{head}/weight" if head else "weight"
            value = np.asarray(value).T
        else:
            key = path
        state[key.replace("/", ".")] = _to_torch(value)
    return state


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """state_dict → nested flax params tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        value = _to_numpy(t)
        if leaf == "weight":
            leaf, value = "kernel", value.T.copy()
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _find_adam_state(opt_state: Any):
    """The ``ScaleByAdamState`` inside an optax state (a nest of tuples)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """Optax state of ``optax.adam`` (alone or chained after a clip) → the
    port's Adam state ``{"count", "mu", "nu"}`` on the CPU."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    return {
        "count": int(np.asarray(adam.count)),
        "mu": from_jax_params(adam.mu),
        "nu": from_jax_params(adam.nu),
    }


def adam_state_to_optax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's Adam state → ``{"count", "mu", "nu"}`` with ``mu`` and
    ``nu`` as flax-named trees of numpy arrays, to fill an optax
    ``ScaleByAdamState`` from."""
    return {
        "count": np.asarray(state["count"], np.int32),
        "mu": to_jax_params(state["mu"]),
        "nu": to_jax_params(state["nu"]),
    }
