"""Trainer steps of the multitask family in the port against the JAX trainer,
from the same parameters on the same numpy-seeded batches: ten steps of
mmoe, esmm, aitm, dselect_k and metaheac, three of maml (its meta-step is
the slowest on the CPU in both packages).  The loss and every float32 leaf
within 1e-5, Adam's first moment within 1e-6, accuracy counts exact, the
AUC buckets equal but for a prediction on a bucket's edge."""

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
from tests.test_torch_multitask_common import flat_config, make_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _pair(flat):
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


# maml's convolution biases feed a batch normalisation, which subtracts them
# again: their true gradient is 0, what arrives is rounding noise, which Adam
# turns into steps of up to lr in each package differently.  Left out by name,
# as in tests/test_torch_rank_rest_train.py.
def _zero_gradient(model, key):
    return model == "multitask.maml" and key.startswith("conv_") and key.endswith(".bias")


@pytest.mark.parametrize("model,steps", [
    ("multitask.mmoe", 10), ("multitask.esmm", 10), ("multitask.aitm", 10),
    ("multitask.dselect_k", 10), ("multitask.metaheac", 10), ("multitask.maml", 3)])
def test_steps_match_the_jax_trainer(model, steps):
    ref, port = _pair(flat_config(model))
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for i in range(steps):
        batch = make_batch(model, 100 + i)
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(port_losses)) and port.state.step == steps
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        if not _zero_gradient(model, k):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == steps
    for k, mu in port.state.opt_state["mu"].items():
        want_mu = adam["mu"][k].numpy()
        # maml's gradients are held to their leaf's scale
        # (tests/test_torch_multitask_models_b.py), and so is their moment
        scale = 1 + float(np.abs(want_mu).max()) if model == "multitask.maml" else 1
        if not _zero_gradient(model, k):
            np.testing.assert_allclose(mu.numpy(), want_mu, rtol=0, atol=1e-6 * scale,
                                       err_msg=k)
    ref_ms = jax.device_get(ref_ms)
    if port.model_def.metrics == "acc":
        for name in port.model_def.metric_names:
            for k in ("correct", "total"):
                assert float(port_ms[name][k]) == float(ref_ms[name][k]), (name, k)
        return
    # the buckets are equal but for a prediction on a bucket's edge
    for name in port.model_def.metric_names:
        for k in ("stat_pos", "stat_neg"):
            moved = port_ms[name][k].numpy() - np.asarray(ref_ms[name][k])
            assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, (name, k)
