"""fastformer, sign and bert4rec in the port against the JAX ``ModelDef`` of
the same name, as ``test_torch_rank_rest_models_a.py`` holds the other three:
sign's gates take the noise that JAX's ``train_forward`` draws from its key,
bert4rec's outputs are its accuracy flags (exact)."""

import pytest
import torch

from tests.test_torch_rank_rest_models_a import (
    check_forward_and_loss, check_gradients, check_names_and_seed,
)

torch.set_num_threads(1)

MODELS = ("rank.fastformer", "rank.sign", "rank.bert4rec")


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(model):
    check_forward_and_loss(model)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model):
    check_gradients(model)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seeded_init(model):
    check_names_and_seed(model)
