"""Ten trainer steps of textcnn, tagspace, kim, ncf and word2vec in the port
against the JAX trainer, from the same parameters on the same numpy-seeded
batches: the loss and every float32 leaf within 1e-5, Adam's first moment
within 1e-6, the AUC buckets (``auc`` or ``pnr``) equal but for a prediction
on a bucket's edge."""

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
from tests.test_torch_match_common import flat_config, make_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 10
TRAINED = ("contentunderstanding.textcnn", "contentunderstanding.tagspace", "match.kim",
           "recall.ncf", "recall.word2vec")


def _pair(model):
    flat = flat_config(model)
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


# kim's biases before a softmax have a true gradient of exactly zero, since a
# softmax does not see a shift: ``attn_fc2`` (the word scores), ``match_fc2``
# (the news scores) and the entity encoder's ``fc2``.  What arrives is
# rounding noise, which Adam turns into steps of up to lr in each package
# differently: left out by name, as in tests/test_torch_rank_rest_train.py.
ZERO_GRADIENT = ("pair_model.attn_fc2.bias", "pair_model.match_fc2.bias",
                 "pair_model.pair_graph.entity_encoder.fc2.bias")
# ``match_fc1``'s bias is nearly such a bias: it reaches the news-level
# softmax over the clicked news only through the differences between them,
# and its gradient is 1e-10 to 1e-6, of which float32 rounding is up to 17%
# (tests/test_torch_match_models.py holds it exactly in float64).  Adam
# scales that noise to a share of lr: after ten steps 1.4e-5 of lr 1e-3 apart
# (measured).  Held within a tenth of one step.
NEAR_ZERO_GRADIENT = {"pair_model.match_fc1.bias": 1e-4}


@pytest.mark.parametrize("model", TRAINED)
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
    assert len(set(port_losses)) > 1
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        if k not in ZERO_GRADIENT:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=NEAR_ZERO_GRADIENT.get(k, 1e-5), err_msg=k)
    adam = convert.adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    for k, mu in port.state.opt_state["mu"].items():
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the buckets are equal but for a prediction on a bucket's edge
    name = port.model_def.metric_names[0]
    assert list(port_ms) == list(ref_ms) == [name]
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms[name][k].numpy() - np.asarray(ref_ms[name][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k
    # both log the state as "auc: ...", whatever the metric's name
    logged = [port.model_def.metric_log_str(port_ms),
              ref.model_def.metric_log_str(jax.device_get(ref_ms))]
    assert all(s.startswith("auc: ") and s.endswith(", ") for s in logged)
    assert abs(float(logged[0][5:-2]) - float(logged[1][5:-2])) < 1e-3
