"""Parameter conversion between the JAX package's flax tree and a state_dict.

Names map one to one: the flax path ``tower/fc_0/kernel`` is the state_dict
key ``tower.fc_0.weight``, and every other leaf keeps its name with ``/``
read as ``.``.  A flax ``Dense`` kernel is ``(in, out)`` and an
``nn.Linear`` weight ``(out, in)``, so kernels are transposed.  Values are
copied bit for bit both ways, bfloat16 included.

Optax's Adam moments (``ScaleByAdamState.mu`` / ``.nu``) are trees of the
parameters' shape, so the same mapping carries them into the port's
optimizer state (``train/optimizers.py``) and back.

Sparse runs (``hyper_parameters.sparse_update``).  The JAX package's
parameters then hold a zero ``embedding_delta`` leaf of ``(capacity, 128)``
float32 beside every table, its route for the per-position gradients; the
port has no such parameter.  ``from_jax_params`` drops those leaves and
``to_jax_params(..., delta_capacity=C)`` recreates them as zeros.  The
row-wise side state (``TrainState.extra``: ``{"<path>/embedding_delta":
RowwiseAdamState | RowwiseAdagradState}``) crosses through
``from_jax_sparse_state`` / ``to_jax_sparse_state`` as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


TABLE_NAME = "embedding"
DELTA_NAME = "embedding_delta"


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
    """Flax params (nested, or flat with ``/`` keys) → state_dict on the CPU.
    ``embedding_delta`` leaves (a sparse run's gradient taps) are dropped."""
    state = {}
    for path, value in flatten_tree(tree).items():
        head, _, leaf = path.rpartition("/")
        if leaf == DELTA_NAME:
            continue
        if leaf == "kernel":
            key = f"{head}/weight" if head else "weight"
            value = np.asarray(value).T
        else:
            key = path
        state[key.replace("/", ".")] = _to_torch(value)
    return state


def to_jax_params(state_dict: Mapping[str, torch.Tensor],
                  delta_capacity: Optional[int] = None) -> Dict[str, Any]:
    """state_dict → nested flax params tree of numpy arrays.  With
    ``delta_capacity`` every packed table (an ``embedding`` leaf of 128
    lanes) gets its zero ``embedding_delta`` ``(capacity, 128)`` float32
    sibling, as a sparse run of the JAX package holds it."""
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
        if (delta_capacity is not None and leaf == TABLE_NAME
                and value.ndim == 2 and value.shape[1] == 128):
            node[DELTA_NAME] = np.zeros((delta_capacity, 128), np.float32)
    return tree


def from_jax_sparse_state(extra: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's row-wise side state → the port's, on the CPU:
    same keys, the same NamedTuple fields (``m``, ``v``, ``count`` or
    ``acc``) as tensors."""
    from paddlerec_tpu_torch.ops.sparse_update import (
        RowwiseAdagradState, RowwiseAdamState,
    )

    out = {}
    for key, st in extra.items():
        fields = {f: _to_torch(getattr(st, f)) for f in st._fields}
        cls = RowwiseAdagradState if "acc" in fields else RowwiseAdamState
        out[key] = cls(**fields)
    return out


def to_jax_sparse_state(extra: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's row-wise side state → ``{key: {field: numpy array}}``, to
    fill the JAX package's ``RowwiseAdamState`` / ``RowwiseAdagradState``
    from (``cls(**fields)``)."""
    return {key: {f: _to_numpy(getattr(st, f)) for f in st._fields}
            for key, st in extra.items()}


def _find_adam_state(opt_state: Any):
    """The first ``ScaleByAdamState`` inside an optax state (a nest of
    tuples and, under ``multi_transform``, of dicts)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, Mapping):
        opt_state = list(opt_state.values())
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
