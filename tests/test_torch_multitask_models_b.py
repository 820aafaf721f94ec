"""dselect_k, maml and metaheac in the port against the JAX ``ModelDef`` of
the same name, as in ``test_torch_multitask_models_a.py``; for maml and
metaheac the gradient is the meta-gradient through the inner loop, against
``jax.grad`` of the JAX ``train_forward``.  Also the optimizer override of
maml and metaheac (Adam at their meta learning rate, whatever
``optimizer.class`` says), against the JAX ``create_optimizer``'s step."""

import jax
import numpy as np
import optax
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from tests.test_torch_multitask_common import (
    CPU, _jax_grad, build, check_forward_and_loss, check_gradients, check_names_and_seed,
    flat_config, make_batch,
)

torch.set_num_threads(1)

MODELS = ("multitask.dselect_k", "multitask.maml", "multitask.metaheac")


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(model):
    check_forward_and_loss(model)


# maml's meta-gradient runs through two inner SGD steps at lr 0.1 of a net
# that normalises by the statistics of two images, and every leaf's error
# follows the leaf's largest gradient, not the element's: against a float64
# run, the port's float32 result is off by up to 6e-6 times that scale (1.9e-5
# on conv_3's, which reaches 3.3) and JAX's by up to 2e-6 times it.  So maml is
# held within 1e-5·(1 + the leaf's scale); the float64 run below holds the
# port's formula within 1e-5 of JAX's float32 result outright.
@pytest.mark.parametrize("model,scaled", [("multitask.dselect_k", False),
                                          ("multitask.maml", True),
                                          ("multitask.metaheac", False)])
def test_gradients_match_jax(model, scaled):
    check_gradients(model, scaled=scaled)


def test_maml_meta_gradient_in_float64_matches_jax():
    """The port's maml in float64 against JAX's float32 meta-gradient, atol
    1e-5: JAX's own float32 rounding is within that of the exact value."""
    _, _, params, port_def, _ = build("multitask.maml")
    batch = make_batch("multitask.maml", 2)
    want = from_jax_params(jax.tree.map(
        np.asarray, _jax_grad("multitask.maml")(params, jax.tree.map(jax.numpy.asarray, batch))))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    module = module.double()
    b = {k: v.double() if v.is_floating_point() else v
         for k, v in to_tensors(batch, CPU).items()}
    loss, _ = port_def.train_forward(module, b)
    loss.backward()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].double().numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seed(model):
    check_names_and_seed(model)


@pytest.mark.parametrize("model,key", [("multitask.maml", "meta_optimizer.learning_rate"),
                                       ("multitask.metaheac",
                                        "optimizer.global_learning_rate")])
def test_optimizer_override_matches_jax(model, key):
    """With ``optimizer.class: SGD`` at lr 0.5 in the config, both packages
    step with Adam at the model's own learning rate: two steps of each on the
    same gradients give the same parameters."""
    flat = flat_config(model, **{"hyper_parameters.optimizer.class": "SGD",
                                 "hyper_parameters.optimizer.learning_rate": 0.5,
                                 f"hyper_parameters.{key}": 0.003})
    tx = jax_model_class(model)(JaxConfig(flat)).create_optimizer()
    port_tx = port_model_class(model)(Config(flat)).create_optimizer()
    assert (port_tx.name, port_tx.lr) == ("adam", 0.003)
    rng = np.random.RandomState(0)
    params = {"a": {"kernel": rng.randn(3, 4).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32)}
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
             for _ in range(2)]
    state, p = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    named = {k: v.clone() for k, v in from_jax_params(params).items()}
    opt_state = port_tx.init(named)
    for g in grads:
        port_tx.apply(named, from_jax_params(g), opt_state)
    for k, v in from_jax_params(jax.tree.map(np.asarray, p)).items():
        np.testing.assert_allclose(named[k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_other_models_keep_the_config_optimizer():
    port_tx = port_model_class("multitask.mmoe")(Config(flat_config(
        "multitask.mmoe", **{"hyper_parameters.optimizer.class": "SGD",
                             "hyper_parameters.optimizer.learning_rate": 0.5}))
    ).create_optimizer()
    assert (port_tx.name, port_tx.lr) == ("sgd", 0.5)


def test_inference_needs_gradients_only_for_the_meta_models():
    """maml and metaheac adapt in inference: the entry points enable
    gradients for them and keep every other model's inference mode."""
    for model in ("multitask.maml", "multitask.metaheac", "multitask.mmoe",
                  "multitask.esmm"):
        md = port_model_class(model)(Config(flat_config(model)))
        with md.infer_context(torch.inference_mode):
            assert torch.is_grad_enabled() == (model in ("multitask.maml",
                                                         "multitask.metaheac"))
            assert torch.is_inference_mode_enabled() != torch.is_grad_enabled()
