"""deeprec, iprec and naml in the port against the JAX ``ModelDef`` of the
same name, from the JAX package's initial parameters and one numpy-seeded
batch (padding and empty masks among its rows): outputs and loss within
1e-5, every leaf's gradient against ``jax.grad`` of ``train_forward`` within
1e-5 (float32 sums in another order), the same leaf names, and
``to_jax_params(from_jax_params(p))`` bitwise (naml's conv kernel
included)."""

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class
from tests.test_torch_rank_rest_common import (
    build, flat_config, forward_and_loss, gradients, names_round_trip,
)

torch.set_num_threads(1)

MODELS = ("rank.deeprec", "rank.iprec", "rank.naml")


def check_forward_and_loss(model):
    out, want, loss, want_loss, aux, ref_aux = forward_and_loss(model)
    assert np.ptp(out) > 1e-4
    if model == "rank.bert4rec":  # the correct flags of the masked positions
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k], v, rtol=0, atol=1e-5, err_msg=k)


def check_gradients(model):
    got, want = gradients(model)
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0, atol=1e-5, err_msg=k)
    # every table and layer is on the path: most leaves take a gradient
    moved = [k for k, g in got.items() if float(g.abs().max()) > 0]
    assert len(moved) >= 0.9 * len(got), sorted(set(got) - set(moved))


def check_names_and_seed(model):
    flat, back = names_round_trip(model)
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        assert v.dtype == back[k].dtype and v.shape == back[k].shape, k
        assert v.tobytes() == back[k].tobytes(), k
    want = build(model)[4].state_dict()
    port_def = get_model_class(model)(Config(flat_config(model)))
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(3))
    again = port_def.make_module(generator=torch.Generator().manual_seed(3))
    other = port_def.make_module(generator=torch.Generator().manual_seed(4))
    assert sorted(fresh.state_dict()) == sorted(want)
    differs = False
    for (k, a), b, c in zip(fresh.state_dict().items(), again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        assert a.shape == want[k].shape and a.dtype == want[k].dtype, k
        differs = differs or not torch.equal(a, c)
    assert differs


@pytest.mark.parametrize("model", MODELS)
def test_forward_and_loss_match_jax(model):
    check_forward_and_loss(model)


@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(model):
    check_gradients(model)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seeded_init(model):
    check_names_and_seed(model)
