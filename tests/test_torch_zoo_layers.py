"""The rank zoo's shared layers and the unpacked table of the port against
the JAX package: output and the gradient of every parameter and of the input
against ``jax.grad``, float32, atol 1e-5 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops import embedding as jax_embedding
from paddlerec_tpu.ops import layers as jax_layers
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.ops import embedding as port_embedding
from paddlerec_tpu_torch.ops import layers as port_layers

torch.set_num_threads(1)

ATOL = 1e-5
B, D = 12, 20


def _compare(flax_module, port_module, inputs, seed=0, scalarize=None, int_inputs=()):
    """Init the flax module, copy its parameters into the port's, compare the
    outputs and, through the sum of the output times fixed random weights, the
    gradients of the parameters and of every float input."""
    jin = [None if x is None else jnp.asarray(x) for x in inputs]
    params = flax_module.init(jax.random.PRNGKey(seed), *jin)["params"]
    params = jax.tree.map(np.asarray, params)
    want_state = from_jax_params(params)
    assert sorted(want_state) == sorted(port_module.state_dict())
    port_module.load_state_dict(want_state)
    scalarize = scalarize or (lambda out: out)
    ref = scalarize(flax_module.apply({"params": params}, *jin))
    weights = np.random.RandomState(99).randn(*ref.shape).astype(np.float32)

    floats = [i for i, x in enumerate(inputs)
              if x is not None and i not in int_inputs]

    def ref_loss(p, *xs):
        full = list(jin)
        for i, x in zip(floats, xs):
            full[i] = x
        return jnp.sum(scalarize(flax_module.apply({"params": p}, *full)) * weights)

    grads = jax.grad(ref_loss, argnums=tuple(range(len(floats) + 1)))(
        params, *[jin[i] for i in floats])
    tin = [None if x is None else torch.from_numpy(np.asarray(x)) for x in inputs]
    for i in floats:
        tin[i].requires_grad_()
    out = scalarize(port_module(*tin))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    (out * torch.from_numpy(weights)).sum().backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads[0]))
    for k, p in port_module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0, atol=ATOL,
                                   err_msg=k)
    for i, g in zip(floats, grads[1:]):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(g), rtol=0,
                                   atol=ATOL, err_msg=f"input {i}")
    return params


def _x(seed=0, shape=(B, D)):
    return (0.5 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("share", [True, False])
def test_crossnet_matches_flax(share):
    flax_m = jax_layers.CrossNet(3, share_weights=share, return_l2=True)
    port = port_layers.CrossNet(D, 3, share_weights=share, return_l2=True)
    # output and penalty side by side, so one weighting covers both
    both = lambda out: (jnp if isinstance(out[0], jnp.ndarray) else torch).concatenate(
        [out[0].reshape(-1), out[1].reshape(1)])
    params = _compare(flax_m, port, [_x(1)], scalarize=both)
    assert sorted(params) == (["layer_b", "layer_w"] if share else
                              ["b_0", "b_1", "b_2", "w_0", "w_1", "w_2"])
    plain = port_layers.CrossNet(D, 3, share_weights=share)
    assert isinstance(plain(torch.from_numpy(_x(1))), torch.Tensor)


def test_crossnet_v2_matches_flax():
    _compare(jax_layers.CrossNetV2(2), port_layers.CrossNetV2(D, 2), [_x(2)])


def test_crossnet_mix_matches_flax():
    params = _compare(jax_layers.CrossNetMix(2, low_rank=5, num_experts=3),
                      port_layers.CrossNetMix(D, 2, low_rank=5, num_experts=3), [_x(3)])
    assert params["U_1"].shape == (3, D, 5) and params["C_0"].shape == (3, 5, 5)
    assert params["gate_0"].shape == (3, D) and params["b_1"].shape == (D,)
    port = port_layers.CrossNetMix(400, 1, generator=torch.Generator().manual_seed(0))
    assert abs(float(port.U_0.detach().std()) - 1 / 20) < 2e-3  # normal(1/√d)
    assert float(port.b_0.detach().abs().max()) == 0.0


@pytest.mark.parametrize("split_half", [True, False])
def test_cin_matches_flax(split_half):
    emb = _x(4, (B, 7, 5))
    params = _compare(jax_layers.CIN([8, 6, 4], split_half=split_half),
                      port_layers.CIN(7, [8, 6, 4], split_half=split_half), [emb])
    assert params["cin_w_1"].shape == (6, 4 if split_half else 8, 7)
    out = port_layers.CIN(7, [8, 6, 4], split_half=split_half)(torch.from_numpy(emb))
    assert out.shape == (B, 4 + 3 + 4 if split_half else 18)


def test_cin_split_half_refuses_an_odd_size():
    with pytest.raises(ValueError, match="split_half requires even"):
        port_layers.CIN(7, [5, 4], split_half=True)
    with pytest.raises(ValueError, match="split_half requires even"):
        jax_layers.CIN([5, 4]).init(jax.random.PRNGKey(0), jnp.zeros((2, 7, 3)))
    port_layers.CIN(7, [4, 5], split_half=True)  # the last layer may be odd
    port_layers.CIN(7, [5, 4], split_half=False)


@pytest.mark.parametrize("dense_dim", [0, 6])
def test_fm_first_order_matches_flax(dense_dim):
    rng = np.random.RandomState(5)
    vocab = 333
    ids = rng.randint(0, 3 * vocab, (B, 9)).astype(np.int64)
    dense = rng.rand(B, dense_dim).astype(np.float32) if dense_dim else None
    port = port_layers.FMFirstOrder(vocab, dense_dim)
    params = _compare(jax_layers.FMFirstOrder(vocab), port, [ids, dense], int_inputs=(0,))
    assert params["sparse_w"].shape == ((vocab + 15) // 16, 128)
    assert ("dense_w" in params) == bool(dense_dim)
    assert abs(float(port.sparse_w.detach().std()) - 1e-4) < 2e-5


@pytest.mark.parametrize("reduce_dim", [True, False])
def test_fm_interaction_matches_flax(reduce_dim):
    emb = (0.1 * np.random.RandomState(6).randn(B, 11, 9)).astype(np.float32)
    flax_m = jax_layers.FMInteraction(reduce_dim=reduce_dim)
    ref = np.asarray(flax_m.apply({}, jnp.asarray(emb)))
    grad = jax.grad(lambda e: jnp.sum(flax_m.apply({}, e) ** 2))(jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_()
    out = port_layers.FMInteraction(reduce_dim=reduce_dim)(x)
    assert out.shape == ((B,) if reduce_dim else (B, 9))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=ATOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=0, atol=ATOL)


# -- SlotEmbedding(packed=False) ------------------------------------------------

VOCAB, WIDTH = 97, 21


def _unpacked_pair(combiner="sum", hash_ids=True):
    flax_m = jax_embedding.SlotEmbedding(VOCAB, WIDTH, combiner=combiner,
                                         hash_ids=hash_ids, packed=False)
    port = port_embedding.SlotEmbedding(VOCAB, WIDTH, combiner=combiner,
                                        hash_ids=hash_ids, packed=False)
    return flax_m, port


def test_unpacked_lookup_is_bitwise_and_its_gradient_matches_jax_grad():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 5 * VOCAB, (B, 6)).astype(np.int64)
    flax_m, port = _unpacked_pair()
    params = jax.tree.map(np.asarray, flax_m.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    assert params["embedding"].shape == (VOCAB, WIDTH)
    port.load_state_dict(from_jax_params(params))
    ref = np.asarray(flax_m.apply({"params": params}, jnp.asarray(ids)))
    out = port(torch.from_numpy(ids))
    assert out.shape == (B, 6, WIDTH) and out.detach().numpy().tobytes() == ref.tobytes()
    weights = rng.randn(B, 6, WIDTH).astype(np.float32)
    grad = jax.grad(lambda p: jnp.sum(flax_m.apply({"params": p}, jnp.asarray(ids)) * weights))(params)
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(port.embedding.grad.numpy(), np.asarray(grad["embedding"]),
                               rtol=0, atol=1e-6)
    assert abs(float(port_embedding.SlotEmbedding(
        5000, 40, packed=False, init_stddev=0.03,
        generator=torch.Generator().manual_seed(1)).embedding.detach().std()) - 0.03) < 1e-3


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [True, False])
def test_unpacked_pooled_lookup_matches_jax(combiner, masked):
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 5 * VOCAB, (B, 4, 3)).astype(np.int64)
    mask = (rng.rand(B, 4, 3) < 0.6).astype(np.float32) if masked else None
    flax_m, port = _unpacked_pair(combiner)
    args = [jnp.asarray(ids)] + ([jnp.asarray(mask)] if masked else [])
    params = jax.tree.map(np.asarray, flax_m.init(jax.random.PRNGKey(0), *args)["params"])
    port.load_state_dict(from_jax_params(params))
    ref = np.asarray(flax_m.apply({"params": params}, *args))
    out = port(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-6)
    grad = jax.grad(lambda p: jnp.sum(flax_m.apply({"params": p}, *args) ** 2))(params)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(port.embedding.grad.numpy(), np.asarray(grad["embedding"]),
                               rtol=0, atol=1e-6)


def test_unpacked_lookup_clips_ids_out_of_range_and_ignores_external_update():
    flax_m, port = _unpacked_pair(hash_ids=False)
    ids = np.array([[0, VOCAB - 1, VOCAB, VOCAB + 50, -3]], np.int64)
    params = jax.tree.map(np.asarray, flax_m.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    port.load_state_dict(from_jax_params(params))
    ref = np.asarray(flax_m.apply({"params": params}, jnp.asarray(ids)))
    out = port(torch.from_numpy(ids)).detach().numpy()
    assert out.tobytes() == ref.tobytes()
    assert (out[0, 2] == params["embedding"][-1]).all()
    assert (out[0, 4] == params["embedding"][0]).all()
    # as in the JAX package, only the packed branch reads external_update
    ext = port_embedding.SlotEmbedding(VOCAB, WIDTH, packed=False, external_update=True,
                                       delta_capacity=8)
    assert not ext.external_update and ext.embedding.requires_grad
    ext(torch.from_numpy(ids % VOCAB)).sum().backward()
    assert ext.embedding.grad is not None and ext.take_delta_grad() is None
