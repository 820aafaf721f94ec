"""Ten trainer steps of din, dien and dmr in the port against the JAX
trainer, from the same parameters on the same numpy-seeded batches: the loss,
every float32 leaf, Adam's first moment and the AUC buckets, at the
tolerances of DeepFM's 20 steps (``PERF.md`` section 2)."""

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
from tests.test_torch_seq_common import flat_config, make_batch

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


# The last bias of an attention MLP whose scores go through a softmax has a
# true gradient of exactly zero (a softmax does not see a shift); what arrives
# is rounding noise (Adam's nu ~1e-23), which Adam turns into steps of up to
# lr, differently in the two packages: left out by name, as AutoFIS's biases
# before its batch standardization are (tests/test_torch_zoo_train.py).
ZERO_GRADIENT = {"rank.din": ("attention.att_mlp.fc_2.bias",),
                 "rank.dien": ("attention.fc_2.bias",),
                 "rank.dmr": ("dm_att_3.bias",)}
# Leaves: DeepFM's 1e-5.  dmr: 1e-4, measured 5.0e-5 in f2.weight: one entry's
# first gradient is 3e-9, rounding noise of a near-cancellation (-2.8e-9 here,
# -3.7e-9 in JAX), under Adam's eps of 1e-8, so the first step lr·g/(|g|+eps)
# moves it 2.2e-4 here and 2.7e-4 there; the gradients agree from then on
# (mu within 1e-6 everywhere).
LEAF_ATOL = {"rank.din": 1e-5, "rank.dien": 1e-5, "rank.dmr": 1e-4}


@pytest.mark.parametrize("model", ["rank.din", "rank.dien", "rank.dmr"])
def test_ten_steps_match_the_jax_trainer(model):
    ref, port = _pair(model)
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
        if k not in ZERO_GRADIENT[model]:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=LEAF_ATOL[model], err_msg=k)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    for k, mu in port.state.opt_state["mu"].items():
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the buckets are equal but for a prediction on a bucket's edge
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms["auc"][k].numpy() - np.asarray(ref_ms["auc"][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k
    # the tables moved: their gradients reached Adam
    tables = [k for k in got if k.endswith("_emb.embedding") or k == "item_b.embedding"]
    assert tables and all(
        float(port.state.opt_state["nu"][k].max()) > 0 for k in tables)
