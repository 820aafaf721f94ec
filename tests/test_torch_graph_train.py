"""Trainer steps of recall's tisas, mind, deepwalk and ensfm and of
graph.lightgcn and graph.transformer_conv in the port against the JAX
trainer, from the same parameters on the same numpy-seeded batches, ten
steps: the loss and every float32 leaf (``close``: 1e-5, scaled where the
reference is above 1), the optimizer's state (Adam's first moment within
1e-6; ensfm's Adagrad accumulators, started at 1e-8, within 1e-5), the AUC
buckets equal but for a prediction on a bucket's edge.  mhcn takes three
steps fed the JAX trainer's permutations (``fold_in(PRNGKey(runner.seed),
step)``, then its own ``fold_in`` and ``split``)."""

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
from tests.test_torch_graph_common import HYPER, close, flat_config, jax_perms, make_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 10
TRAINED = ("recall.tisas", "recall.mind", "recall.deepwalk", "graph.lightgcn",
           "graph.transformer_conv", "recall.ensfm")
# biases whose true gradient is exactly zero, since a softmax does not see
# a shift: the key projection's bias of tisas's attention (a constant q·b_k
# in every score of a row) and of TransformerConv's.  What arrives is
# rounding noise, which Adam turns into steps of up to lr in each package
# differently: left out by name, as in tests/test_torch_match_train.py.
ZERO_GRADIENT = ("att_0.k.bias", "att_1.k.bias", "conv_0.k.bias", "conv_1.k.bias")


def _pair(model, **extra):
    flat = flat_config(model, **extra)
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    if model == "recall.mhcn":
        # the JAX ModelDef builds its demo graph lazily; built first inside
        # the trainer's jitted init, its arrays would leak that trace
        ref.model_def._graph()
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


def _run(model, steps, **extra):
    ref, port = _pair(model, **extra)
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for i in range(steps):
        batch = make_batch(model, 100 + i)
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    close(port_losses, ref_losses, err_msg="losses")
    assert np.all(np.isfinite(port_losses)) and port.state.step == steps
    assert len(set(port_losses)) > 1
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        if k not in ZERO_GRADIENT:
            close(got[k].numpy(), v.numpy(), err_msg=k)
    return ref, port, ref_ms, port_ms


@pytest.mark.parametrize("model", TRAINED)
def test_ten_steps_match_the_jax_trainer(model):
    ref, port, ref_ms, port_ms = _run(model, STEPS)
    opt = jax.device_get(ref.state.opt_state)
    if model == "recall.ensfm":
        rss = convert._find_state(opt, ("sum_of_squares",))
        want = convert.from_jax_params(rss.sum_of_squares)
        got = port.state.opt_state["sum_of_squares"]
        assert sorted(got) == sorted(want)
        for k, acc in got.items():
            close(acc.numpy(), want[k].numpy(), err_msg=k)
        assert ref_ms == {} and port_ms == {}  # no streaming metric
        return
    adam = convert.adam_state_from_optax(opt)
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    assert sorted(adam["mu"]) == sorted(port.state.opt_state["mu"])
    if model == "recall.mind":
        # the routing logits' gradient is exactly 0: zero moments, and Adam
        # leaves the leaf as it was in both packages
        k = "routing.routing_logits"
        assert not adam["mu"][k].any() and not port.state.opt_state["mu"][k].any()
        assert torch.equal(port.state.module.state_dict()[k],
                           convert.from_jax_params(jax.device_get(ref.state.params))[k])
    for k, mu in port.state.opt_state["mu"].items():
        if k not in ZERO_GRADIENT:
            np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    name = port.model_def.metric_names[0]
    assert list(port_ms) == list(ref_ms) == [name]
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms[name][k].numpy() - np.asarray(ref_ms[name][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k


def test_mind_adamw_decays_the_routing_logits_as_optax():
    """AdamW decays every leaf, the routing logits whose gradient is 0
    included (``optax.adamw`` has no mask): both packages move them alike."""
    key, adamw = "routing.routing_logits", {"hyper_parameters.optimizer.class": "adamw",
                                            "hyper_parameters.optimizer.weight_decay": 0.5}
    start = _pair("recall.mind", **adamw)[1].state.module.state_dict()[key].clone()
    ref, port, _, _ = _run("recall.mind", 3, **adamw)
    got = port.state.module.state_dict()[key]
    want = convert.from_jax_params(jax.device_get(ref.state.params))[key]
    close(got.numpy(), want.numpy(), err_msg=key)
    assert float((got - start).abs().max()) > 1e-4


def test_mhcn_three_steps_with_the_jax_permutations():
    model = "recall.mhcn"
    h = HYPER[model]
    base = jax.random.PRNGKey(0)  # runner.seed

    def perms(generator):
        return jax_perms(jax.random.fold_in(base, port.state.step), h["num_users"],
                         h["num_factors"])

    ref, port = _pair(model)
    port.model_def.draw_perms = perms
    step = ref._build_train_step()
    losses = []
    for i in range(3):
        batch = make_batch(model, 100 + i)
        ref.state, _, want = step(ref.state, jax.device_put(batch), {})
        _, loss = port.train_step(to_tensors(batch, CPU), {})
        close(float(loss), float(want), err_msg=f"step {i}")
        losses.append(float(loss))
    assert len(set(losses)) == 3
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    for k, v in port.state.module.state_dict().items():
        close(v.numpy(), want[k].numpy(), err_msg=k)
    # the generator's own draws: a step's permutations follow runner.seed
    del port.model_def.draw_perms
    g1 = torch.Generator().manual_seed(port_trainer_mod.step_seed(0, 3))
    g2 = torch.Generator().manual_seed(port_trainer_mod.step_seed(0, 3))
    for a, b in zip(port.model_def.draw_perms(g1), port.model_def.draw_perms(g2)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert sorted(a[1].tolist()) == list(range(h["num_factors"]))
