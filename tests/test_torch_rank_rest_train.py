"""Ten trainer steps of naml, bert4rec and sign in the port against the JAX
trainer, from the same parameters on the same numpy-seeded batches: the
loss and every float32 leaf within 1e-5, Adam's first moment within 1e-6,
bert4rec's accuracy counts exact, the AUC buckets equal but for a prediction
on a bucket's edge.  sign's port draws, at each step, what JAX's step draws
from ``fold_in(PRNGKey(runner.seed), step)``; left to its own generator, two
runs of the port are bitwise equal and a third from another seed is not."""

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_rank_rest_common import feed_noise, flat_config, jax_noise, make_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 10


def _pair(model):
    flat = flat_config(model)
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


def _jax_step_noise(port, seed):
    """What the JAX trainer's sign draws at the port's current step."""
    base = jax.random.PRNGKey(seed)
    return lambda shape: jax_noise(jax.random.fold_in(base, port.state.step), shape)


# Biases whose true gradient is exactly zero, since a softmax does not see a
# shift: the projection bias of every additive attention (a constant added to
# every score of a group) and the key bias of an attention block (q·b is the
# same for every key).  What arrives is rounding noise, which Adam turns into
# steps of up to lr in each package differently: left out by name, as in
# tests/test_torch_seq_train.py.
def _zero_gradient(model, key):
    if model == "rank.naml":
        return key.endswith("attention.proj.bias")
    if model == "rank.bert4rec":
        return key.endswith(".k.bias")
    return False


@pytest.mark.parametrize("model", ["rank.naml", "rank.bert4rec", "rank.sign"])
def test_ten_steps_match_the_jax_trainer(model):
    ref, port = _pair(model)
    if model == "rank.sign":
        feed_noise(port.model_def, _jax_step_noise(port, 0))
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for i in range(STEPS):
        batch = make_batch(model, 100 + i)
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(port_losses)) and port.state.step == STEPS
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        if not _zero_gradient(model, k):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    for k, mu in port.state.opt_state["mu"].items():
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    if model == "rank.bert4rec":
        for k in ("correct", "total"):
            assert float(port_ms["acc"][k]) == float(ref_ms["acc"][k]), k
        assert port.model_def.compute_metric_bundle(port_ms) == \
            ref.model_def.compute_metric_bundle(jax.device_get(ref_ms))
        return
    # the buckets are equal but for a prediction on a bucket's edge
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms["auc"][k].numpy() - np.asarray(ref_ms["auc"][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k


def _own_noise_run(seed):
    port = port_trainer_mod.Trainer(Config(flat_config("rank.sign", **{"runner.seed": seed})),
                                    device="cpu")
    port.init_state(seed=0)
    ms, losses = port._init_metric_state(), []
    for i in range(4):
        ms, loss = port.train_step(to_tensors(make_batch("rank.sign", 100 + i), CPU), ms)
        losses.append(float(loss))
    return losses, port.state.module.state_dict()


def test_sign_draws_from_the_seed_and_step():
    """The port's own noise: reseeded from ``runner.seed`` and the step, so a
    rerun is bitwise equal; another seed draws other gates; evaluation
    passes no generator, so its forward is deterministic."""
    (a, pa), (b, pb), (c, _) = _own_noise_run(0), _own_noise_run(0), _own_noise_run(5)
    assert a == b and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert a != c and np.all(np.isfinite(a))
    port = port_trainer_mod.Trainer(Config(flat_config("rank.sign")), device="cpu")
    port.init_state(seed=0)
    batch = to_tensors(make_batch("rank.sign", 3), CPU)
    outs = [port.infer_step(batch, port._init_metric_state())[1]["predictions"]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_step_seeds_differ_on_the_cpu_generator():
    """The CPU generator keeps the low 32 bits of a seed, so ``(seed << 32) +
    step`` unmixed would give every ``runner.seed`` the same noise there;
    ``step_seed`` mixes them: every (seed, step) pair below draws its own."""
    draws = set()
    for seed in (0, 1, 5, 2023):
        for step in (0, 1, 2):
            g = torch.Generator().manual_seed(port_trainer_mod.step_seed(seed, step))
            draws.add(tuple(torch.rand(4, generator=g).tolist()))
    assert len(draws) == 12
    assert port_trainer_mod.step_seed(3, 4) == port_trainer_mod.step_seed(3, 4) < (1 << 63)
