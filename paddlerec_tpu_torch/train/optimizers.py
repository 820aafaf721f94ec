"""Optimizer steps, written by hand to match the optax transformations the
JAX package builds in ``ModelDef.create_optimizer``
(``paddlerec_tpu/models/base.py:329-449``).

Each step is a plain function over lists of tensors under
``torch.no_grad()``; it updates parameters and state in place (the JAX
package returns new trees; here the state is mutated to save memory) and
never synchronises with the host.  The order of operations follows optax
0.2.6, so that a bfloat16 table steps as it does there:

* **Adam** is ``optax.adam(lr, mu_dtype=float32)``: the first moment is
  stored in float32 whatever the parameter's dtype, the second moment in the
  gradient's dtype (bfloat16 for a bfloat16 table), ``b1=0.9, b2=0.999,
  eps=1e-8, eps_root=0``, the bias correction ``1 - decay**count`` is
  computed in float32 from the incremented count, the update is
  ``-lr * m_hat / (sqrt(v_hat) + eps)`` and the parameter becomes
  ``(p + u).to(p.dtype)``.  A Python scalar meeting a bfloat16 array is
  rounded to bfloat16 first, as JAX's weak typing does: there ``b2 = 0.999``
  is 1.0, so a bfloat16 second moment never decays.  Operations between
  bfloat16 arrays round to bfloat16 one by one, except the last before a
  widening to float32 (XLA drops that rounding): the product ``(1 - b1) * g``
  and the sum ``sqrt(v_hat) + eps`` are float32.  The port copies all of
  that, as read from the optimized HLO of the jitted step on the CPU.  ``torch.optim.Adam`` keeps both moments in the parameter's
  dtype and does not match.
* **SGD** is ``optax.sgd(lr)``; **Adagrad** is ``optax.adagrad(lr,
  initial_accumulator_value)`` with ``eps=1e-7`` inside the root.
* ``clip_by_global_norm`` is ``optax.clip_by_global_norm``, applied to the
  gradients before the step.

The state is a dict of plain values: ``count`` (a Python int, the step's
int32 counter) and one ``{name: tensor}`` dict per moment, keyed like the
module's ``state_dict``, so ``convert`` maps optax's moment trees onto it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

Tensors = Mapping[str, torch.Tensor]
OptState = Dict[str, Any]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as ``optax.tree.bias_correction``."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.int32(count),
                                            dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _scalar(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: rounded
    to that dtype first (in bfloat16, ``b2 = 0.999`` is 1.0 and ``eps =
    1e-8`` is 1.0012e-8)."""
    return float(torch.tensor(x, dtype=dtype))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """New gradient tensors: unchanged where the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``.  The choice is made on the
    device (``torch.where``), not on the host."""
    total = sum(torch.sum(g * g).to(torch.float32) for g in grads)
    norm = torch.sqrt(total)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


def adam_init(params: Tensors) -> OptState:
    return {
        "count": 0,
        "mu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
    }


@torch.no_grad()
def adam_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    count = state["count"] = state["count"] + 1
    bc1 = _bias_correction(b1, count)
    bc2 = _bias_correction(b2, count)
    groups: Dict[torch.dtype, List[str]] = {}
    for k in params:
        groups.setdefault(grads[k].dtype, []).append(k)
    for dtype, names in groups.items():
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mus = [state["mu"][k] for k in names]
        nus = [state["nu"][k] for k in names]
        # mu = (1 - b1) * g + b1 * mu in float32, (1 - b1) in g's dtype
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(
            [g.float() for g in gs], _scalar(1 - b1, dtype)))
        # nu = (1 - b2) * g**2 + b2 * nu, every operation in g's dtype
        torch._foreach_mul_(nus, _scalar(b2, dtype))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, _scalar(1 - b2, dtype))
        torch._foreach_add_(nus, g2)
        del g2
        # u = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps): the root in nu's
        # dtype, the sum and the quotient in float32
        denom = torch._foreach_div(nus, _scalar(bc2, dtype))
        torch._foreach_sqrt_(denom)
        denom = [d.float() for d in denom]
        torch._foreach_add_(denom, _scalar(eps, dtype))
        us = torch._foreach_div(mus, bc1)
        torch._foreach_div_(us, denom)
        torch._foreach_mul_(us, -lr)
        # (p + u).to(p.dtype): a bfloat16 parameter adds in float32, rounds once
        torch._foreach_add_(ps, us)


def sgd_init(params: Tensors) -> OptState:
    return {}


@torch.no_grad()
def sgd_step(params: Tensors, grads: Tensors, state: OptState,
             lr: float) -> None:
    names = list(params)
    torch._foreach_add_([params[k] for k in names],
                        torch._foreach_mul([grads[k] for k in names], -lr))


def adagrad_init(params: Tensors,
                 initial_accumulator_value: float = 0.1) -> OptState:
    return {"sum_of_squares": {
        k: torch.full_like(p, initial_accumulator_value)
        for k, p in params.items()}}


@torch.no_grad()
def adagrad_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
                 eps: float = 1e-7) -> None:
    names = list(params)
    ps = [params[k] for k in names]
    gs = [grads[k] for k in names]
    acc = [state["sum_of_squares"][k] for k in names]
    torch._foreach_add_(acc, torch._foreach_mul(gs, gs))  # g*g + t
    us = []
    for t, g in zip(acc, gs):
        inv = torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t))
        us.append(inv.mul_(g).mul_(-lr))
    torch._foreach_add_(ps, us)


class Optimizer:
    """What ``create_optimizer`` returns: the step's class and its
    hyper-parameters, an ``init`` that builds the state for a set of named
    parameters, and an ``apply`` that steps them in place from their
    gradients."""

    def __init__(self, name: str, lr: float, clip: Optional[float] = None,
                 initial_accumulator_value: float = 0.1):
        if name not in ("adam", "sgd", "adagrad"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.lr = float(lr)
        self.clip = None if not clip else float(clip)
        self.initial_accumulator_value = float(initial_accumulator_value)

    def init(self, params: Tensors) -> OptState:
        if self.name == "adam":
            return adam_init(params)
        if self.name == "adagrad":
            return adagrad_init(params, self.initial_accumulator_value)
        return sgd_init(params)

    def apply(self, params: Tensors, grads: Tensors, state: OptState) -> None:
        if self.clip is not None:
            names = list(grads)
            clipped = clip_by_global_norm([grads[k] for k in names], self.clip)
            grads = dict(zip(names, clipped))
        step = {"adam": adam_step, "sgd": sgd_step,
                "adagrad": adagrad_step}[self.name]
        step(params, grads, state, self.lr)
