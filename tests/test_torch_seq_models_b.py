"""dsin, dmr and dpin in the port against the JAX ``ModelDef`` of the same
name: the checks of ``test_torch_seq_models_a.py`` (predictions and loss
within 1e-5, every leaf's gradient within 1e-5 of ``jax.grad``, names and the
round trip bitwise).  dsin's batch holds an empty session list, sessions past
``sess_length`` and a live session with no event; dmr's an empty history;
dpin's loss is the unmasked mean over (B, K)."""

import pytest
import torch

from tests.test_torch_seq_models_a import (
    check_forward_and_loss, check_gradients, check_names_and_seed,
)

torch.set_num_threads(1)

MODELS = ("rank.dsin", "rank.dmr", "rank.dpin")


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(model):
    check_forward_and_loss(model)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model):
    check_gradients(model)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seeded_init(model):
    check_names_and_seed(model)
