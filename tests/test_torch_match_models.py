"""The match, content-understanding and recall models of the port against
the JAX ``ModelDef`` of the same name, from the JAX package's initial
parameters and one numpy-seeded batch (a padded row, empty token masks and
masked tokens among its rows): outputs and loss within 1e-5, every leaf's
gradient against ``jax.grad`` of ``train_forward`` within 1e-5 (float32 sums
in another order), the same leaf names, ``to_jax_params(from_jax_params(p))``
bitwise (the 1-D and 2-D conv kernels included), and a seeded init; ncf in
each of its three modes."""

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class
from tests.test_torch_match_common import (
    MODELS, build, flat_config, forward_and_loss, gradients, make_batch, names_round_trip,
)

torch.set_num_threads(1)

# ncf's other modes ride as extra cases of the same checks
CASES = [(m, None) for m in MODELS] + [("recall.ncf", "NCF_GMF"), ("recall.ncf", "NCF_MLP")]


def _extra(mode):
    return {} if mode is None else {"hyper_parameters.mode": mode}


@pytest.mark.parametrize("model,mode", CASES)
def test_forward_and_loss_match_jax(model, mode):
    out, want, loss, want_loss, aux, ref_aux = forward_and_loss(model, **_extra(mode))
    assert np.ptp(out) > 1e-4 and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k], v, rtol=0, atol=1e-5, err_msg=k)


# kim's float32 gradients follow the scale of its entity vectors.  With
# standard normals (ten times a KG vector's spread) they reach 32, summed
# through two graph co-attentions, and against a float64 run JAX's float32
# result is off by up to 1.6e-4 and the port's by up to 4.1e-4 (gcat's wv),
# the two apart by up to 1.0e-4 (entity_encoder's fc2, scale 9.1).  So the
# float32 checks use entries of about ±0.1 (``KG_SCALE``), where both are
# within 1e-5 of each other, and the float64 test below holds standard normals
# against JAX's own float64 run.
@pytest.mark.parametrize("model,mode", CASES)
def test_gradients_match_jax(model, mode):
    got, want = gradients(model, **_extra(mode))
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0, atol=1e-5, err_msg=k)
    # every table and layer is on the path: most leaves take a gradient
    moved = [k for k, g in got.items() if float(g.abs().max()) > 0]
    assert len(moved) >= 0.9 * len(got), sorted(set(got) - set(moved))


def test_kim_gradients_in_float64_match_jax():
    """kim's loss and every gradient, both packages in float64 from the same
    parameters and a batch of standard-normal entity vectors: atol 1e-5
    (float64 sums in another order)."""
    jax_def, _, params, port_def, module = build("match.kim")
    batch = make_batch("match.kim", 2, kg_scale=1.0)
    wide = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.float64), params)
        loss_fn = jax.jit(jax.value_and_grad(lambda p, b: jax_def.train_forward(p, b)[0]))
        want_loss, grads = loss_fn(p64, jax.tree.map(jax.numpy.asarray, wide))
        want = from_jax_params(jax.tree.map(np.asarray, grads))
        want_loss = float(want_loss)
    module = module.double()
    loss, _ = port_def.train_forward(module, {k: torch.from_numpy(v) for k, v in wide.items()})
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) < 1e-10
    assert max(float(g.abs().max()) for g in want.values()) > 10  # the hard regime
    for k, p in module.named_parameters():
        assert want[k].dtype == torch.float64, k
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("model", MODELS)
def test_names_round_trip_and_seeded_init(model):
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


def test_word2vec_init_as_the_reference():
    """The input table uniform on [0, 1/dim), read shifted by -0.5/dim; the
    output table and bias zero, so the first logits are 0."""
    port_def = get_model_class("recall.word2vec")(Config(flat_config("recall.word2vec")))
    module = port_def.make_module(generator=torch.Generator().manual_seed(0))
    dim = port_def.embedding_dim
    table = module.in_emb.embedding.detach()
    assert 0 <= float(table.min()) and float(table.max()) < 1.0 / dim
    assert float(table.max()) > 0.9 / dim
    assert not module.out_emb.embedding.any() and not module.out_bias.embedding.any()
    assert module.out_bias.embedding.shape == (port_def.vocab_size, 1)


def test_ncf_rejects_an_unknown_mode():
    port_def = get_model_class("recall.ncf")(Config(flat_config(
        "recall.ncf", **{"hyper_parameters.mode": "NCF_BOTH"})))
    with pytest.raises(ValueError, match="unknown ncf mode"):
        port_def.make_module()
