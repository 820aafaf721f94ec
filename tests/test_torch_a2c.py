"""rl.a2c in the port against the JAX package: the vectorised CartPole step,
the rollout's loss and every gradient fed the JAX rollout's own draws (its
actions from ``jax.random.categorical`` and its reset states from
``jax.random.uniform``, which no torch generator reproduces), the learning-rate
schedule and Adam under it against ``optax``, the parameter names, and the
training loop's learning at the JAX test's setting.

Tolerances: observations 1e-6 (float32 dynamics; ``cos``/``sin`` may differ
in the last bit), rewards, ``done`` flags and step counts exact (the test's
states keep clear of the limits); the loss and every gradient 1e-5; the
schedule and ten Adam steps 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.models.rl.a2c import model as jax_a2c
from paddlerec_tpu_torch.convert import from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.models.rl.a2c import model as port_a2c
from paddlerec_tpu_torch.train.optimizers import exponential_decay

torch.set_num_threads(1)

ENVS = 6
SMALL = {"hyper_parameters.num_envs": ENVS, "hyper_parameters.hidden_size": 16,
         "hyper_parameters.num_steps": 5, "hyper_parameters.gamma": 0.99,
         "hyper_parameters.optimizer.learning_rate": 1e-3}


def _defs(flat=SMALL):
    return (jax_model_class("rl.a2c")(JaxConfig(flat)),
            port_model_class("rl.a2c")(Config(flat)))


def _start_state(seed):
    """A JAX env state: fresh observations, two envs one or a few steps
    from ``MAX_STEPS``, one about to cross the angle limit and one the
    cart's, each well past its edge."""
    env = jax_a2c.env_reset(jax.random.PRNGKey(seed), ENVS)
    obs = np.array(env.obs)
    obs[2] = [0.1, 0.2, 0.19, 1.5]  # θ + τ·θ̇ = 0.22 > 0.2094
    obs[4] = [2.38, 1.5, 0.0, 0.0]  # x + τ·ẋ = 2.41 > 2.4
    steps = np.array([0, 197, 50, 199, 3, 10], np.int32)
    return jax_a2c.EnvState(jnp.asarray(obs), jnp.asarray(steps), env.key)


def _port_state(env):
    return port_a2c.EnvState(torch.from_numpy(np.array(env.obs)),
                             torch.from_numpy(np.array(env.steps)), None)


def _jax_fresh(env):
    """The reset states JAX's ``env_step`` draws from ``env.key``."""
    _, sub = jax.random.split(env.key)
    return jax.random.uniform(sub, env.obs.shape, minval=-0.05, maxval=0.05)


def test_env_step_matches_jax():
    env = _start_state(0)
    port_env = _port_state(env)
    rng = np.random.RandomState(1)
    dones = 0
    for t in range(8):
        action = rng.randint(0, 2, ENVS).astype(np.int32)
        fresh = _jax_fresh(env)
        env, reward, done = jax_a2c.env_step(env, jnp.asarray(action))
        port_env, p_reward, p_done = port_a2c.env_step(
            port_env, torch.from_numpy(action), torch.from_numpy(np.array(fresh)))
        np.testing.assert_allclose(port_env.obs.numpy(), np.array(env.obs), rtol=0,
                                   atol=1e-6, err_msg=f"step {t}")
        np.testing.assert_array_equal(p_done.numpy(), np.array(done))
        np.testing.assert_array_equal(p_reward.numpy(), np.array(reward))
        np.testing.assert_array_equal(port_env.steps.numpy(), np.array(env.steps))
        dones += int(np.array(done).sum())
    # the angle, the cart and MAX_STEPS each ended an episode
    assert dones >= 4


def test_env_reset_draws_in_range_and_restarts_from_the_generator():
    g = torch.Generator().manual_seed(3)
    env = port_a2c.env_reset(1000, g)
    assert env.obs.shape == (1000, 4) and env.obs.dtype == torch.float32
    assert float(env.obs.min()) >= -0.05 and float(env.obs.max()) < 0.05
    assert env.steps.dtype == torch.int32 and not env.steps.any()
    env = env._replace(steps=torch.full((1000,), 199, dtype=torch.int32))
    new, _, done = port_a2c.env_step(env, torch.ones(1000, dtype=torch.int64))
    assert bool(done.all()) and not new.steps.any()
    assert float(new.obs.abs().max()) < 0.05


def _jax_draws(jax_def, params, env, key):
    """The actions and reset states JAX's ``rollout_loss`` draws from
    ``key``, replayed step by step."""
    keys = jax.random.split(key, jax_def.num_steps)
    actions, fresh = [], []
    for k in keys:
        logits, _ = jax_def.module.apply({"params": params}, env.obs)
        action = jax.random.categorical(k, logits)
        actions.append(torch.from_numpy(np.array(action)).long())
        fresh.append(torch.from_numpy(np.array(_jax_fresh(env))))
        env, _, _ = jax_a2c.env_step(env, action)
    return actions, fresh


@pytest.mark.parametrize("seed", [0, 1])
def test_rollout_loss_and_gradients_match_jax_on_its_draws(seed):
    jax_def, port_def = _defs()
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(seed)))
    env, key = _start_state(seed), jax.random.PRNGKey(100 + seed)
    (want, (want_env, want_r)), grads = jax.jit(jax.value_and_grad(
        jax_def.rollout_loss, has_aux=True))(params, env, key)
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    actions, fresh = _jax_draws(jax_def, params, env, key)
    loss, (new_env, mean_r) = port_def.rollout_loss(module, _port_state(env),
                                                    actions=actions, fresh=fresh)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=0, atol=1e-5)
    assert float(mean_r) == pytest.approx(float(want_r), abs=1e-7)
    np.testing.assert_allclose(new_env.obs.numpy(), np.array(want_env.obs), atol=1e-6)
    np.testing.assert_array_equal(new_env.steps.numpy(), np.array(want_env.steps))
    # episodes ended (their steps restarted): the masks cut the returns
    assert (new_env.steps.numpy() < np.array(env.steps) + port_def.num_steps).sum() >= 3
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        assert float(p.grad.abs().max()) > 0, k


def test_rollout_draws_from_the_generator():
    _, port_def = _defs()
    module = port_def.make_module(device="cpu", generator=torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        loss, (env, _) = port_def.rollout_loss(module, port_a2c.env_reset(ENVS, g), g)
        runs.append((float(loss.detach()), env.obs))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert np.isfinite(runs[0][0])


def test_names_and_round_trip_match_flax():
    jax_def, port_def = _defs()
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(0)))
    module = port_def.make_module(device="cpu")
    assert sorted(module.state_dict()) == sorted(from_jax_params(params))
    back = to_jax_params(from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(params) == {"critic_fc", "critic_out", "actor_fc", "actor_out"}


def test_exponential_decay_matches_optax_in_float32():
    for lr, steps, rate in ((1e-3, 400, 0.92), (3e-2, 50, 0.5), (1e-3, 0, 0.92)):
        ours = exponential_decay(lr, steps, rate)
        theirs = optax.exponential_decay(lr, transition_steps=steps, decay_rate=rate)
        counts = np.arange(0, 5000, 7)
        want = np.array([float(theirs(jnp.int32(c))) for c in counts[:40]]
                        + [float(v) for v in jax.vmap(theirs)(jnp.asarray(counts[40:],
                                                                          jnp.int32))])
        got = np.array([ours(int(c)) for c in counts])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got[0] == np.float32(lr)


def test_ten_adam_steps_under_the_schedule_match_optax():
    """The ModelDef's optimizer against ``optax.adam(exponential_decay)`` of
    the JAX ModelDef, at ``num_steps`` 1,000 (a transition every 2 steps, so
    ten steps decay the rate 0.92^4.5) and at the default 5."""
    for num_steps in (1000, 5):
        flat = dict(SMALL, **{"hyper_parameters.num_steps": num_steps})
        jax_def, port_def = _defs(flat)
        params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(0)))
        tx = jax_def.create_optimizer()
        opt_state = tx.init(params)
        port_params = {k: v.clone() for k, v in from_jax_params(params).items()}
        port_tx = port_def.create_optimizer()
        port_state = port_tx.init(port_params)
        rng = np.random.RandomState(2)
        for _ in range(10):
            g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
            updates, opt_state = tx.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            port_tx.apply(port_params, from_jax_params(g), port_state)
        want = from_jax_params(jax.tree.map(np.asarray, params))
        for k, v in port_params.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"num_steps {num_steps}: {k}")
        assert port_state["schedule_count"] == port_state["count"] == 10


def test_train_forward_is_the_value_regression():
    jax_def, port_def = _defs()
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(0)))
    batch = port_def.example_batch(8)
    want, _ = jax_def.train_forward(params, jax.tree.map(jnp.asarray, batch))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    loss, aux = port_def.train_forward(module, {"obs": torch.from_numpy(batch["obs"])})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=0, atol=1e-6)
    assert aux["logits"].shape == (8, 2)


def test_cartpole_improves_at_the_jax_tests_setting():
    """8 envs, hidden 64, 12,000 frames, evaluated every 4,000, as the JAX
    package's own test (``tests/test_tree_graph_rl.py``).  At this budget the
    outcome turns on the draws in both packages (the JAX loop ends above 50
    at seeds 0-2 and below at 3-5), and the port's generator is not JAX's:
    the majority of seeds 0-5 must end above 50, and the seeds' mean last
    return above their mean first one."""
    flat = {"hyper_parameters.num_envs": 8, "hyper_parameters.hidden_size": 64,
            "hyper_parameters.optimizer.learning_rate": 1e-3}
    md = port_model_class("rl.a2c")(Config(flat))
    histories = [md.train(total_frames=12000, seed=s, log_every=4000, device="cpu")[1]
                 for s in range(6)]
    assert all(len(h) == 3 and np.all(np.isfinite(h)) for h in histories)
    last = [h[-1] for h in histories]
    assert sum(x > 50 for x in last) >= 3, histories
    assert np.mean(last) > np.mean([h[0] for h in histories]), histories
