"""A2C: advantage actor-critic on CartPole.

Counterpart of ``paddlerec_tpu/models/rl/a2c/model.py``, registered as
``rl.a2c``.  Parity target of the original: reference
models/rl/A2C/train.py:83-205 — a 2-layer actor (softmax policy) + critic
(value), n-step rollouts from a fleet of environments, discounted returns,
loss = actor + 0.5·critic − 0.001·entropy, and Adam under a 0.92 decay of
the learning rate every 2000 frames.

The environments are a vectorised CartPole in torch ops on the module's
device (``env_reset``/``env_step``, auto-reset on done); ``rollout_loss``
runs ``num_steps`` steps in a Python loop where the JAX package runs
``lax.scan``, then the discounted returns in reverse.  The JAX package
draws actions with ``jax.random.categorical`` and the reset states with
``jax.random.uniform``; the port draws both from a ``torch.Generator``, so
the two packages' runs differ, and both functions take the draws injected
(``actions``, ``fresh``) to reproduce a JAX rollout exactly.  The path is
dense torch only: no lookup, no K1 or K1b (the JAX a2c has no Pallas
kernel either).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import resolve_device
from paddlerec_tpu_torch.core.registry import register_model
from paddlerec_tpu_torch.models.base import ModelDef as BaseModelDef
from paddlerec_tpu_torch.ops.layers import flax_dense
from paddlerec_tpu_torch.train.optimizers import exponential_decay

# -- CartPole-v0 dynamics (classic control; constants per the gym spec) -----
GRAVITY = 9.8
CART_MASS = 1.0
POLE_MASS = 0.1
TOTAL_MASS = CART_MASS + POLE_MASS
POLE_HALF_LEN = 0.5
POLEMASS_LENGTH = POLE_MASS * POLE_HALF_LEN
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * np.pi / 360
X_LIMIT = 2.4
MAX_STEPS = 200


class EnvState(NamedTuple):
    obs: torch.Tensor  # (N, 4) float32
    steps: torch.Tensor  # (N,) int32
    generator: Optional[torch.Generator]  # the reset states' draws


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """uniform on [-0.05, 0.05), as ``jax.random.uniform(minval=-0.05,
    maxval=0.05)``."""
    return torch.rand(shape, generator=generator, device=device) * 0.1 - 0.05


def env_reset(n: int, generator: Optional[torch.Generator] = None,
              device=None) -> EnvState:
    device = generator.device if device is None and generator is not None else device
    return EnvState(_uniform((n, 4), generator, device),
                    torch.zeros((n,), dtype=torch.int32, device=device), generator)


def env_step(state: EnvState, action: torch.Tensor,
             fresh: Optional[torch.Tensor] = None):
    """One step of every environment; a finished one restarts from
    ``fresh`` (N, 4), or from a draw of ``state.generator``.  Returns
    (state, reward, done)."""
    x, x_dot, theta, theta_dot = state.obs.unbind(1)
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    temp = (force + POLEMASS_LENGTH * theta_dot**2 * sin_t) / TOTAL_MASS
    theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
        POLE_HALF_LEN * (4.0 / 3.0 - POLE_MASS * cos_t**2 / TOTAL_MASS)
    )
    x_acc = temp - POLEMASS_LENGTH * theta_acc * cos_t / TOTAL_MASS
    obs = torch.stack(
        [
            x + TAU * x_dot,
            x_dot + TAU * x_acc,
            theta + TAU * theta_dot,
            theta_dot + TAU * theta_acc,
        ],
        dim=1,
    )
    steps = state.steps + 1
    done = (
        (torch.abs(obs[:, 0]) > X_LIMIT)
        | (torch.abs(obs[:, 2]) > THETA_LIMIT)
        | (steps >= MAX_STEPS)
    )
    reward = torch.ones_like(obs[:, 0])
    # auto-reset finished envs (rpc_step resets on done, train.py:41-46)
    if fresh is None:
        fresh = _uniform(obs.shape, state.generator, obs.device)
    obs = torch.where(done[:, None], fresh, obs)
    steps = torch.where(done, torch.zeros_like(steps), steps)
    return EnvState(obs, steps, state.generator), reward, done


class ActorCritic(nn.Module):
    """obs (N, 4) → (logits (N, A), value (N,)), each head a ReLU layer of
    ``hidden`` and an output layer."""

    def __init__(self, num_actions: int = 2, hidden: int = 256, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.critic_fc = flax_dense(4, hidden, **kw)
        self.critic_out = flax_dense(hidden, 1, **kw)
        self.actor_fc = flax_dense(4, hidden, **kw)
        self.actor_out = flax_dense(hidden, num_actions, **kw)

    def forward(self, x):
        value = self.critic_out(torch.relu(self.critic_fc(x)))[..., 0]
        logits = self.actor_out(torch.relu(self.actor_fc(x)))
        return logits, value


@register_model("rl.a2c")
class ModelDef(BaseModelDef):
    metrics = "none"
    metric_names = ()

    def __init__(self, config: Config):
        super().__init__(config)
        h = config.hyper
        self.num_steps = int(h("num_steps", 5))
        self.num_envs = int(h("num_envs", 16))
        self.gamma = float(h("gamma", 0.99))
        self.hidden = int(h("hidden_size", 256))

    def make_module(self, device=None, generator: Optional[torch.Generator] = None):
        return ActorCritic(2, self.hidden, device=device, generator=generator)

    def _base_optimizer(self):
        lr = float(self.config.hyper("optimizer.learning_rate", 1e-3))
        # 0.92 decay every 2000 frames (train.py:196-198); optax.adam's first
        # moment in the parameters' dtype
        return {"name": "adam", "lr": lr, "mu_dtype": None,
                "schedule": exponential_decay(lr, 2000 // self.num_steps, 0.92)}

    def model_inputs(self, batch):
        return (batch["obs"],)

    def example_batch(self, batch_size: int):
        rng = np.random.RandomState(0)
        return {"obs": rng.randn(batch_size, 4).astype(np.float32)}

    # -- the rollout and its loss ------------------------------------------
    def rollout_loss(self, module, env_state: EnvState,
                     generator: Optional[torch.Generator] = None,
                     actions: Optional[Sequence[torch.Tensor]] = None,
                     fresh: Optional[Sequence[torch.Tensor]] = None):
        """Collect ``num_steps`` transitions under the current policy and
        return (loss, (new_env_state, mean_reward)).  Actions are drawn from
        the policy with ``generator``, or taken from ``actions`` (one (N,)
        tensor a step); finished environments restart from ``fresh`` (one
        (N, 4) tensor a step) or from draws of the state's generator."""
        log_probs, values, rewards, masks, entropies = [], [], [], [], []
        for t in range(self.num_steps):
            logits, value = module(env_state.obs)
            logp = torch.log_softmax(logits, -1)
            if actions is not None:
                action = actions[t]
            else:
                action = torch.multinomial(torch.softmax(logits.detach(), -1), 1,
                                           generator=generator)[:, 0]
            log_probs.append(torch.gather(logp, 1, action[:, None].long())[:, 0])
            entropies.append(-(torch.softmax(logits, -1) * logp).sum(-1).mean())
            env_state, reward, done = env_step(
                env_state, action, None if fresh is None else fresh[t])
            values.append(value)
            rewards.append(reward)
            masks.append(1.0 - done.to(reward.dtype))
        _, next_value = module(env_state.obs)
        returns = [None] * self.num_steps
        r_next = next_value
        for t in reversed(range(self.num_steps)):
            r_next = rewards[t] + self.gamma * r_next * masks[t]
            returns[t] = r_next
        advantage = torch.stack(returns) - torch.stack(values)
        actor_loss = -(torch.stack(log_probs) * advantage.detach()).mean()
        critic_loss = (advantage**2).mean()
        entropy = torch.stack(entropies).sum()
        loss = actor_loss + 0.5 * critic_loss - 0.001 * entropy
        return loss, (env_state, torch.stack(rewards).mean())

    def train_forward(self, module, batch):
        # generic contract (for the smoke harness): value regression to 0
        logits, value = module(batch["obs"])
        return (value**2).mean(), {"logits": logits}

    def train(self, total_frames: int = 20000, seed: int = 0, log_every: int = 2000,
              device=None) -> Tuple[nn.Module, List[float]]:
        """Self-contained A2C training loop (the train.py analog) on
        ``device`` (the card by default): returns (module, the greedy
        returns evaluated every ``log_every`` frames)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        module = self.make_module(device=device, generator=generator)
        tx = self.create_optimizer()
        params = {k: p for k, p in module.named_parameters()}
        opt_state = tx.init(params)
        env_state = env_reset(self.num_envs, generator)
        frames, history = 0, []
        while frames < total_frames:
            module.zero_grad(set_to_none=True)
            loss, (env_state, _) = self.rollout_loss(module, env_state, generator)
            loss.backward()
            tx.apply(params, {k: p.grad for k, p in params.items()}, opt_state)
            frames += self.num_steps * self.num_envs
            if frames % log_every < self.num_steps * self.num_envs:
                history.append(self.evaluate_policy(module, generator))
        return module, history

    @torch.no_grad()
    def evaluate_policy(self, module, generator: Optional[torch.Generator] = None,
                        episodes: int = 4) -> float:
        """Mean greedy-episode return (test_env, train.py:117-134) over
        ``episodes`` environments started from draws of ``generator``."""
        device = next(module.parameters()).device
        env = env_reset(episodes, generator, device)
        total = torch.zeros((episodes,), device=device)
        alive = torch.ones((episodes,), dtype=torch.bool, device=device)
        for _ in range(MAX_STEPS):
            logits, _ = module(env.obs)
            env, reward, done = env_step(env, logits.argmax(-1))
            total = total + reward * alive
            alive = alive & ~done
        return float(total.mean())
