"""share_bottom, mmoe, ple (one level and two), esmm, aitm and escm2 (IPW
and DR) in the port against the JAX ``ModelDef`` of the same name, from the
JAX package's initial parameters and one numpy-seeded batch (a masked row,
empty Ali-CCP fields, ids beyond the vocabulary): outputs, loss and aux
within 1e-5, every leaf's gradient against ``jax.grad`` of
``train_forward`` within 1e-5 (float32 sums in another order), and
``to_jax_params(from_jax_params(p))`` bitwise (the ``DenseGeneral`` kernels
of mmoe and ple included)."""

import pytest
import torch

from tests.test_torch_multitask_common import (
    ALI_CCP, CENSUS, check_forward_and_loss, check_gradients, check_names_and_seed,
)

torch.set_num_threads(1)

MODELS = CENSUS + ALI_CCP


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(model):
    check_forward_and_loss(model)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model):
    check_gradients(model)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seed(model):
    check_names_and_seed(model)
