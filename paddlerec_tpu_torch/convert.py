"""Parameter conversion between the JAX package's flax tree and a state_dict.

Names map one to one: the flax path ``tower/fc_0/kernel`` is the state_dict
key ``tower.fc_0.weight``, and every other leaf keeps its name with ``/``
read as ``.``.  A flax ``Dense`` kernel is ``(in, out)`` and an
``nn.Linear`` weight ``(out, in)``, so kernels are transposed; a flax
``Conv`` kernel is ``(H, W, in, out)`` and an ``nn.Conv2d`` weight
``(out, in, H, W)``, so 4-D kernels are permuted; every other kernel has
its axes reversed: a 1-D ``Conv`` kernel ``(W, in, out)`` becomes the
``nn.Conv1d`` weight ``(out, in, W)``, and a ``DenseGeneral`` kernel ``(in,
N, E)`` the port's ``DenseGeneral`` weight ``(E, N, in)``
(``ops/layers.py``), which is stored in that layout for this reason.
Values are copied bit for bit both ways, bfloat16 included.

Optax's Adam moments (``ScaleByAdamState.mu`` / ``.nu``) are trees of the
parameters' shape, so the same mapping carries them into the port's
optimizer state (``train/optimizers.py``) and back.  So does GRDA's
accumulator (``GrdaState``), and the per-group states of an
``optax.multi_transform`` (AutoFIS's search stage: Adam for the dense leaves,
GRDA for the gate) map onto the ``MultiOptimizer`` state group by group.

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


def is_embedding_path(name: str) -> bool:
    """Whether a parameter is an embedding table, by its name: a copy of
    ``paddlerec_tpu/parallel/sharding.py`` ``is_embedding_path`` on the
    port's names (the flax path ``/``-joined, or a state_dict key, with
    ``.`` read as ``/``).  A component ``embedding`` or ``sparse_w`` marks a
    table; a leaf ``embedding_delta`` (the JAX package's gradient tap of a
    sparse run, which the port has not) is no table."""
    names = name.replace(".", "/").split("/")
    if names and names[-1] == DELTA_NAME:
        return False
    return any(n in (TABLE_NAME, "sparse_w") for n in names)


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


def _kernel_to_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ``Dense`` (in, out) → (out, in); ``Conv`` (H, W, in, out) →
    (out, in, H, W); 1-D ``Conv`` (W, in, out) → (out, in, W);
    ``DenseGeneral`` (in, N, E) → (E, N, in)."""
    if kernel.ndim == 4:
        return np.transpose(kernel, (3, 2, 0, 1))
    return kernel.T


def _weight_to_kernel(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:
        return np.transpose(weight, (2, 3, 1, 0)).copy()
    return weight.T.copy()


def _is_masked(leaf: Any) -> bool:
    """optax's ``MaskedNode``: the placeholder ``multi_transform`` leaves
    where a parameter belongs to another group."""
    return isinstance(leaf, tuple) and len(leaf) == 0


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested, or flat with ``/`` keys) → state_dict on the CPU.
    ``embedding_delta`` leaves (a sparse run's gradient taps) are dropped,
    and so are the masked placeholders of a ``multi_transform`` group."""
    state = {}
    for path, value in flatten_tree(tree).items():
        head, _, leaf = path.rpartition("/")
        if leaf == DELTA_NAME or _is_masked(value):
            continue
        if leaf == "kernel":
            key = f"{head}/weight" if head else "weight"
            value = _kernel_to_weight(np.asarray(value))
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
            leaf, value = "kernel", _weight_to_kernel(value)
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


_ADAM_FIELDS = ("count", "mu", "nu")
_GRDA_FIELDS = ("accumulator", "l1_accumulation", "count")


def _find_state(opt_state: Any, fields):
    """The first state with all of ``fields`` inside an optax state (a nest
    of tuples and, under ``multi_transform``, of dicts)."""
    if all(hasattr(opt_state, a) for a in fields):
        return opt_state
    if isinstance(opt_state, Mapping):
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_state(item, fields)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """Optax state of ``optax.adam`` (alone or chained after a clip) → the
    port's Adam state ``{"count", "mu", "nu"}`` on the CPU."""
    adam = _find_state(opt_state, _ADAM_FIELDS)
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


def grda_state_from_optax(opt_state: Any) -> Dict[str, Any]:
    """Optax state holding a ``GrdaState`` → the port's GRDA state
    ``{"accumulator", "l1_accumulation", "count"}`` on the CPU."""
    grda = _find_state(opt_state, _GRDA_FIELDS)
    if grda is None:
        raise ValueError("no GrdaState (accumulator, l1_accumulation, count) "
                         "in the optax state")
    return {
        "accumulator": from_jax_params(grda.accumulator),
        "l1_accumulation": float(np.asarray(grda.l1_accumulation)),
        "count": int(np.asarray(grda.count)),
    }


def grda_state_to_optax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's GRDA state → ``{"accumulator", "l1_accumulation",
    "count"}`` with the accumulator as a flax-named tree of numpy arrays, to
    fill a ``GrdaState`` from."""
    return {
        "accumulator": to_jax_params(state["accumulator"]),
        "l1_accumulation": np.asarray(state["l1_accumulation"], np.float32),
        "count": np.asarray(state["count"], np.int32),
    }


def multi_state_from_optax(opt_state: Any) -> Dict[str, Dict[str, Any]]:
    """State of ``optax.multi_transform`` over Adam and GRDA groups → the
    port's ``MultiOptimizer`` state ``{label: group state}``; each group's
    trees keep only that group's leaves."""
    inner = getattr(opt_state, "inner_states", None)
    if inner is None:
        raise ValueError("not a multi_transform state (no inner_states)")
    out = {}
    for label, group in inner.items():
        if _find_state(group, _GRDA_FIELDS) is not None:
            out[label] = grda_state_from_optax(group)
        else:
            out[label] = adam_state_from_optax(group)
    return out


def multi_state_to_optax(state: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """The port's ``MultiOptimizer`` state → ``{label: fields}``, each group
    through ``grda_state_to_optax`` or ``adam_state_to_optax``."""
    return {label: (grda_state_to_optax(group) if "accumulator" in group
                    else adam_state_to_optax(group))
            for label, group in state.items()}
