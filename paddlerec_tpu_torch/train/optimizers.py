"""Optimizer steps, written by hand to match the optax transformations the
JAX package builds in ``ModelDef.create_optimizer``
(``paddlerec_tpu/models/base.py:329-449``).

Each step is a plain function over lists of tensors under
``torch.no_grad()``; it updates the state in place (the JAX package returns
new trees; here the state is mutated to save memory), returns the updates,
and never synchronises with the host.  ``Optimizer.apply`` adds them to the
parameters.  The order of operations follows optax 0.2.6, so that a
bfloat16 table steps as it does there:

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
* **AdamW** is ``optax.adamw(lr, weight_decay)``: the same moments (the first
  in the parameter's dtype), ``weight_decay * p`` added to the Adam
  direction before the learning rate.
* **SGD** is ``optax.sgd(lr)``; **Adagrad** is ``optax.adagrad(lr,
  initial_accumulator_value)`` with ``eps=1e-7`` inside the root;
  **RMSProp** is ``optax.rmsprop(lr)``: ``decay=0.9``, ``eps=1e-8`` inside
  the root, no momentum.
* **Lazy Adam** (``optimizer.lazy_mode``) is ``lazy_adam`` of
  ``paddlerec_tpu/train/optimizers.py`` on the embedding tables (every leaf
  with ``embedding`` in a component of its name) and ``optax.adam(lr)`` on
  the rest: rows of a leaf of rank >= 2 whose gradient is all zero keep
  their moments and take no step; one count serves both.
* **GRDA** is ``grda`` of ``paddlerec_tpu/train/optimizers.py`` (generalized
  regularized dual averaging, the gate optimizer of AutoFIS's search stage):
  ``a += [t = 0]·p − lr·g``, ``ℓ1 += c·lr^(0.5+μ)·((t+1)^μ − t^μ)``,
  ``p = sign(a)·max(|a| − ℓ1, 0)``, so weights reach zero exactly.  The
  accumulator starts uniform(−0.1, 0.1), a permanent per-weight offset.  The
  JAX package draws it from ``jax.random.PRNGKey(20211015)``; the port draws
  its own from a ``torch.Generator`` seeded with the same constant, so a run
  is reproducible, but the two packages' accumulators differ unless one is
  carried across (``convert.grda_state_from_optax``).
* ``MultiOptimizer`` is ``optax.multi_transform``: one optimizer per named
  group of leaves, each with its own state under the group's label.
* ``clip_by_global_norm`` is ``optax.clip_by_global_norm``, applied to the
  gradients before the step.  ``embedding_l2`` is
  ``optax.add_decayed_weights(-embedding_l2 * lr)`` on the embedding tables
  only, applied to the updates after the step.
* A learning-rate ``schedule`` (a function of the step count, as optax
  takes one in place of the rate) is read at the count before the update
  (``optax.scale_by_schedule``), which the state keeps as
  ``schedule_count``.  ``exponential_decay`` is
  ``optax.exponential_decay(lr, transition_steps, decay_rate)``, in float32
  as optax computes it; a2c's optimizer needs it.
* With ``optimizer.runtime_inject`` (``optax.inject_hyperparams``) the
  learning rate and ``embedding_l2`` live in the state under
  ``hyperparams`` and are read at every step, so
  ``Trainer.set_hyperparams`` retunes them between steps; the decay is then
  always part of the step (zero by default).  The JAX package needs this to
  avoid a recompile; eager PyTorch has nothing to recompile.

AdamW (whose first moment is stored in the parameter's dtype), RMSProp and
lazy Adam step a bfloat16 leaf as XLA steps it too: every operation in
bfloat16, rounded one by one, the Python scalars rounded to bfloat16 first.
Where XLA widens to float32 (lazy Adam's update, whose bias corrections are
float32 arrays), the moments enter the update unrounded, which changes
nothing there: a row's new moment is either its old one or its stepped one.

The state is a dict of plain values: ``count`` (a Python int, the step's
int32 counter) and one ``{name: tensor}`` dict per moment, keyed like the
module's ``state_dict``, so ``convert`` maps optax's moment trees onto it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

Tensors = Mapping[str, torch.Tensor]
OptState = Dict[str, Any]
Updates = Dict[str, torch.Tensor]


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


def adam_init(params: Tensors,
              mu_dtype: Optional[torch.dtype] = torch.float32) -> OptState:
    """``mu_dtype=None``: the first moment in each parameter's dtype."""
    return {
        "count": 0,
        "mu": {k: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
               for k, p in params.items()},
        "nu": {k: torch.zeros_like(p) for k, p in params.items()},
    }


@torch.no_grad()
def adam_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0) -> Updates:
    """Adam on the named parameters, from the count ``state`` already holds
    (``Optimizer.apply`` increments it)."""
    count = state["count"]
    bc1 = _bias_correction(b1, count)
    bc2 = _bias_correction(b2, count)
    groups: Dict[tuple, List[str]] = {}
    for k in params:
        groups.setdefault((grads[k].dtype, state["mu"][k].dtype), []).append(k)
    updates: Updates = {}
    for (dtype, mu_dtype), names in groups.items():
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mus = [state["mu"][k] for k in names]
        nus = [state["nu"][k] for k in names]
        if mu_dtype != torch.float32:
            updates.update(zip(names, _adam_in_dtype(
                ps, gs, mus, nus, dtype, bc1, bc2, lr, b1, b2, eps, weight_decay)))
            continue
        # mu = (1 - b1) * g + b1 * mu in float32, (1 - b1) in g's dtype
        # (in place where mu is stored in float32, else rounded once into it)
        new_mus = [m if m.dtype == torch.float32 else m.float() for m in mus]
        torch._foreach_mul_(new_mus, b1)
        torch._foreach_add_(new_mus, torch._foreach_mul(
            [g.float() for g in gs], _scalar(1 - b1, dtype)))
        for m, new in zip(mus, new_mus):
            if m is not new:
                m.copy_(new)
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
        us = torch._foreach_div(new_mus, bc1)
        torch._foreach_div_(us, denom)
        if weight_decay:
            torch._foreach_add_(us, torch._foreach_mul(
                [p.float() for p in ps], weight_decay))
        torch._foreach_mul_(us, -lr)
        updates.update(zip(names, us))
    return updates


def _adam_in_dtype(ps, gs, mus, nus, dtype: torch.dtype, bc1: float, bc2: float,
                   lr: float, b1: float, b2: float, eps: float,
                   weight_decay: float) -> List[torch.Tensor]:
    """Adam with both moments stored in the gradient's dtype (AdamW's, and
    Adam's without ``mu_dtype``): every operation in that dtype, the scalars
    rounded to it first, as the jitted optax step does, in its order:
    ``mu = b1·mu + (1-b1)·g``, ``u = -lr·((mu / bc1) / (sqrt(nu / bc2) + eps)
    + weight_decay·p)``."""
    s = functools.partial(_scalar, dtype=dtype)
    torch._foreach_mul_(mus, s(b1))
    torch._foreach_add_(mus, torch._foreach_mul(gs, s(1 - b1)))
    torch._foreach_mul_(nus, s(b2))
    g2 = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(g2, s(1 - b2))
    torch._foreach_add_(nus, g2)
    del g2
    denom = torch._foreach_div(nus, s(bc2))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, s(eps))
    us = torch._foreach_div(mus, s(bc1))
    torch._foreach_div_(us, denom)
    if weight_decay:
        torch._foreach_add_(us, torch._foreach_mul(list(ps), s(weight_decay)))
    torch._foreach_mul_(us, s(-lr))
    return us


@torch.no_grad()
def lazy_adam_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> Updates:
    """``lazy_adam``: Adam that only updates rows touched this step.  Row
    granularity is the leading axis of each leaf of rank >= 2; lower ranks
    mask by element.  Uses the count ``state`` already holds.  The moments
    step in the gradient's dtype, each operation rounded, in the reference's
    order (``(1-b2)·g·g`` is ``((1-b2)·g)·g``); the update is float32, from
    float32 bias corrections: ``((-lr·k)·(mu / bc1)) / (sqrt(nu / bc2) + eps)``
    with ``-lr`` in the gradient's dtype."""
    count = state["count"]
    bc1 = _bias_correction(b1, count)
    bc2 = _bias_correction(b2, count)
    updates: Updates = {}
    for k in params:
        g = grads[k]
        s = functools.partial(_scalar, dtype=g.dtype)
        if g.dim() >= 2:
            touched = torch.any(g != 0, dim=tuple(range(1, g.dim())), keepdim=True)
        else:
            touched = g != 0
        m, v = state["mu"][k], state["nu"][k]
        m.copy_(torch.where(touched, m * s(b1) + g * s(1 - b1), m))
        v.copy_(torch.where(touched, v * s(b2) + (g * s(1 - b2)) * g, v))
        u = (s(-lr) * (m.float() / bc1)) / (torch.sqrt(v.float() / bc2) + eps)
        updates[k] = torch.where(touched, u, torch.zeros_like(u))
    return updates


def sgd_init(params: Tensors) -> OptState:
    return {}


@torch.no_grad()
def sgd_step(params: Tensors, grads: Tensors, state: OptState,
             lr: float) -> Updates:
    names = list(params)
    return dict(zip(names, torch._foreach_mul([grads[k] for k in names], -lr)))


def adagrad_init(params: Tensors,
                 initial_accumulator_value: float = 0.1) -> OptState:
    return {"sum_of_squares": {
        k: torch.full_like(p, initial_accumulator_value)
        for k, p in params.items()}}


@torch.no_grad()
def adagrad_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
                 eps: float = 1e-7) -> Updates:
    names = list(params)
    gs = [grads[k] for k in names]
    acc = [state["sum_of_squares"][k] for k in names]
    torch._foreach_add_(acc, torch._foreach_mul(gs, gs))  # g*g + t
    updates = {}
    for k, t, g in zip(names, acc, gs):
        inv = torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t))
        updates[k] = inv.mul_(g).mul_(-lr)
    return updates


def rmsprop_init(params: Tensors) -> OptState:
    return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def rmsprop_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
                 decay: float = 0.9, eps: float = 1e-8) -> Updates:
    """``optax.rmsprop(lr)`` in the gradient's dtype, each operation rounded
    and the scalars rounded to that dtype first, as the jitted optax step
    does: ``nu = (1-decay)·g² + decay·nu``, ``u = -lr·(rsqrt(nu + eps)·g)``."""
    updates = {}
    for k in params:
        g, nu = grads[k], state["nu"][k]
        s = functools.partial(_scalar, dtype=g.dtype)
        nu.copy_((g * g) * s(1 - decay) + nu * s(decay))
        updates[k] = (torch.rsqrt(nu + s(eps)) * g) * s(-lr)
    return updates


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float):
    """``optax.exponential_decay(init_value, transition_steps, decay_rate)``
    (no staircase, no delay, no end value): count → ``init_value ·
    decay_rate^(count / transition_steps)`` in float32, ``init_value`` at
    count 0; a constant for ``transition_steps <= 0`` or ``decay_rate == 0``."""
    def schedule(count: int) -> float:
        if transition_steps <= 0 or decay_rate == 0 or count <= 0:
            return float(np.float32(init_value))
        p = np.float32(count) / np.float32(transition_steps)
        return float(np.float32(init_value) * np.power(np.float32(decay_rate), p))

    return schedule


GRDA_ACCUMULATOR_SEED = 20211015


def grda_init(params: Tensors) -> OptState:
    """The accumulator is drawn on the host, whatever the parameters' device,
    so that a run on the card starts where the same run on the CPU does."""
    gen = torch.Generator().manual_seed(GRDA_ACCUMULATOR_SEED)
    acc = {k: torch.rand(p.shape, generator=gen).mul_(0.2).sub_(0.1)
           .to(device=p.device, dtype=p.dtype) for k, p in params.items()}
    return {"accumulator": acc, "l1_accumulation": 0.0, "count": 0}


@torch.no_grad()
def grda_step(params: Tensors, grads: Tensors, state: OptState, lr: float,
              c: float = 0.0, mu: float = 0.7) -> Updates:
    """GRDA on the named parameters; returns ``new_p − p``, so that adding
    it lands on ``new_p`` (and on zero exactly where ``new_p`` is zero).  The
    threshold is accumulated in float32 on the host, as the JAX package
    accumulates it in a float32 scalar."""
    t, mu32 = np.float32(state["count"]), np.float32(mu)
    scale = np.float32(c * lr ** (0.5 + mu))
    l1 = float(np.float32(state["l1_accumulation"])
               + (scale * (t + np.float32(1.0)) ** mu32 - scale * t ** mu32))
    updates = {}
    for k, p in params.items():
        a = state["accumulator"][k]
        if state["count"] == 0:
            a.add_(p)
        a.sub_(lr * grads[k])
        updates[k] = torch.sign(a) * torch.clamp(a.abs() - l1, min=0.0) - p
    state["l1_accumulation"] = l1
    state["count"] += 1
    return updates


def is_table_name(name: str) -> bool:
    """A ``state_dict`` name of an embedding table: the leaves
    ``embedding_l2`` decays (``is_embedding_path`` of the JAX package)."""
    return any(part in ("embedding", "sparse_w") for part in name.split("."))


class Optimizer:
    """What ``create_optimizer`` returns: the step's class and its
    hyper-parameters, an ``init`` that builds the state for a set of named
    parameters, and an ``apply`` that steps them in place from their
    gradients."""

    def __init__(self, name: str, lr: float, clip: Optional[float] = None,
                 initial_accumulator_value: float = 0.1, lazy: bool = False,
                 weight_decay: float = 1e-4, embedding_l2: float = 0.0,
                 runtime_inject: bool = False,
                 mu_dtype: Optional[torch.dtype] = torch.float32,
                 grda_c: float = 0.0, grda_mu: float = 0.7,
                 schedule: Optional[Callable[[int], float]] = None):
        if name not in ("adam", "sgd", "adagrad", "rmsprop", "adamw", "grda"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.lr = float(lr)
        self.clip = None if not clip else float(clip)
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.lazy = bool(lazy) and name == "adam"
        self.weight_decay = float(weight_decay) if name == "adamw" else 0.0
        self.embedding_l2 = float(embedding_l2)
        self.runtime_inject = bool(runtime_inject)
        # plain Adam's first moment: float32 (``optax.adam(lr,
        # mu_dtype=float32)``, what ``ModelDef.create_optimizer`` builds) or,
        # with None, the parameter's dtype (``optax.adam(lr)``)
        self.mu_dtype = mu_dtype
        self.grda_c, self.grda_mu = float(grda_c), float(grda_mu)
        # the learning rate as a function of the step count, or None (lr)
        self.schedule = schedule

    def init(self, params: Tensors) -> OptState:
        if self.name in ("adam", "adamw"):
            plain = self.name == "adam" and not self.lazy
            state = adam_init(params, self.mu_dtype if plain else None)
        elif self.name == "grda":
            state = grda_init(params)
        elif self.name == "adagrad":
            state = adagrad_init(params, self.initial_accumulator_value)
        elif self.name == "rmsprop":
            state = rmsprop_init(params)
        else:
            state = sgd_init(params)
        if self.schedule is not None:
            state["schedule_count"] = 0
        if self.runtime_inject:
            state["hyperparams"] = {"learning_rate": self.lr,
                                    "embedding_l2": self.embedding_l2}
        return state

    def _step(self, params: Tensors, grads: Tensors, state: OptState,
              lr: float) -> Updates:
        if self.name in ("adam", "adamw"):
            state["count"] += 1
            if not self.lazy:
                return adam_step(params, grads, state, lr,
                                 weight_decay=self.weight_decay)
            tables = {k: p for k, p in params.items()
                      if any("embedding" in part for part in k.split("."))}
            dense = {k: p for k, p in params.items() if k not in tables}
            updates = adam_step(dense, grads, state, lr)
            updates.update(lazy_adam_step(tables, grads, state, lr))
            return updates
        if self.name == "grda":
            return grda_step(params, grads, state, lr, self.grda_c, self.grda_mu)
        step = {"sgd": sgd_step, "adagrad": adagrad_step,
                "rmsprop": rmsprop_step}[self.name]
        return step(params, grads, state, lr)

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state: OptState) -> None:
        hyper = state.get("hyperparams", {})
        lr = float(hyper.get("learning_rate", self.lr))
        el2 = float(hyper.get("embedding_l2", self.embedding_l2))
        step_lr = lr
        if self.schedule is not None:
            # embedding_l2 keeps the configured rate, as in the JAX package
            step_lr = self.schedule(state["schedule_count"])
            state["schedule_count"] += 1
        if self.clip is not None:
            names = list(grads)
            clipped = clip_by_global_norm([grads[k] for k in names], self.clip)
            grads = dict(zip(names, clipped))
        updates = self._step(params, grads, state, step_lr)
        if el2:
            for k, p in params.items():
                if is_table_name(k):
                    updates[k] = updates[k] + (-el2 * lr) * p
        names = list(params)
        # (p + u).to(p.dtype): a bfloat16 parameter adds in float32, rounds once
        torch._foreach_add_([params[k] for k in names],
                            [updates[k] for k in names])


class MultiOptimizer:
    """``optax.multi_transform``: ``groups`` maps a label to the
    ``Optimizer`` of that group, ``label`` a parameter's ``state_dict`` name
    to its label.  The state is ``{label: that optimizer's state}``, so it
    passes through ``TrainState`` and the checkpoint as any other."""

    def __init__(self, groups: Mapping[str, Optimizer], label):
        self.groups = dict(groups)
        self.label = label

    def _split(self, tensors: Tensors) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in self.groups}
        for k, v in tensors.items():
            out[self.label(k)][k] = v
        return out

    def init(self, params: Tensors) -> OptState:
        split = self._split(params)
        return {g: opt.init(split[g]) for g, opt in self.groups.items()}

    def apply(self, params: Tensors, grads: Tensors, state: OptState) -> None:
        split = self._split(params)
        for g, opt in self.groups.items():
            opt.apply(split[g], {k: grads[k] for k in split[g]}, state[g])
