"""The layers of the match and content-understanding models against flax:
kim's ``SelfAttention`` (both head branches), ``AttentivePooling``,
``GraphCoAttNet`` and ``PairGraph`` from the same parameters; the ``SAME``
convs at odd and even widths (flax pads an even kernel one more after) and
match_pyramid's (2, 10) kernel; the masked max with its -1e9 fill and its
split of a tie's gradient; and ``Embed.pool``, flax's take, multiply and sum
of a bag of words, ids out of range included.  Outputs and gradients within
1e-5 (float32 sums in another order); NaN where flax has NaN."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.models.match.kim import model as jax_kim
from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
from paddlerec_tpu_torch.models.match.kim import model as port_kim
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.layers import SameConv1d, SameConv2d, masked_max

torch.set_num_threads(1)


def _port(module, params):
    """``module`` holding the flax ``params``; the names must match."""
    state = from_jax_params(jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(module.state_dict())
    module.load_state_dict(state)
    return module


def _check(flax_module, port_module, *inputs, seed=0, atol=1e-5):
    """Forward and the gradient of every parameter and float input of a
    random read-out, flax against the port."""
    jin = [jnp.asarray(x) for x in inputs]
    params = flax_module.init(jax.random.PRNGKey(seed), *jin)["params"]
    _port(port_module, params)
    out = jax.jit(flax_module.apply)({"params": params}, *jin)
    weights = np.random.RandomState(seed + 1).randn(*out.shape).astype(np.float32)

    def readout(p, *xs):
        return jnp.sum(jnp.asarray(weights) * flax_module.apply({"params": p}, *xs))

    floats = [i for i, x in enumerate(inputs) if x.dtype == np.float32]
    grads = jax.jit(jax.grad(readout, argnums=(0, *[i + 1 for i in floats])))(params, *jin)
    tin = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in floats:
        tin[i].requires_grad_()
    got = port_module(*tin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=atol)
    (torch.from_numpy(weights) * got).sum().backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads[0]))
    for k, p in port_module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    for i, g in zip(floats, grads[1:]):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(g), rtol=0, atol=atol)
    return got.detach().numpy()


@pytest.mark.parametrize("hidden", [8, 20])
def test_self_attention_both_head_branches(hidden):
    """kim's word attention: 4 heads unless the width divides by 20."""
    heads = 20 if hidden % 20 == 0 else 4
    x = np.random.RandomState(hidden).randn(3, 5, 6).astype(np.float32)
    port = port_kim.SelfAttention(6, heads, hidden // heads)
    _check(jax_kim.SelfAttention(heads, hidden // heads), port, x, x, x)
    assert port.heads == heads and port.wq.weight.shape == (hidden, 6)


def test_attentive_pooling_and_graph_co_attention():
    rng = np.random.RandomState(3)
    _check(jax_kim.AttentivePooling(), port_kim.AttentivePooling(100),
           rng.randn(4, 3, 100).astype(np.float32))
    _check(jax_kim.GraphCoAttNet(), port_kim.GraphCoAttNet(),
           (rng.randn(4, 6, 100) * 0.3).astype(np.float32))


def test_pair_graph():
    """E = 3: (B, 2·(9 + 3), 100) → (B, 200)."""
    x = (np.random.RandomState(4).randn(5, 24, 100) * 0.3).astype(np.float32)
    out = _check(jax_kim.PairGraph(3), port_kim.PairGraph(3), x)
    assert out.shape == (5, 200)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
def test_same_conv1d_at_odd_and_even_widths(width):
    x = np.random.RandomState(width).randn(3, 7, 4).astype(np.float32)
    _check(fnn.Conv(5, kernel_size=(width,), padding="SAME"), SameConv1d(4, 5, width), x)
    conv = SameConv1d(4, 5, width)
    assert conv.pads == ((width - 1) // 2, width // 2)


@pytest.mark.parametrize("kernel", [(2, 10), (3, 3)])
def test_same_conv2d(kernel):
    """match_pyramid's (2, 10) kernel pads (0, 1) rows and (4, 5) columns;
    NHWC in and out, as flax's."""
    x = np.random.RandomState(7).randn(2, 5, 13, 1).astype(np.float32)
    out = _check(fnn.Conv(3, kernel_size=kernel, padding="SAME"),
                 SameConv2d(1, 3, kernel), x)
    assert out.shape == (2, 5, 13, 3)
    flat = flatten_tree(to_jax_params(SameConv2d(1, 3, kernel).state_dict()))
    assert flat["kernel"].shape == kernel + (1, 3)


def test_masked_max_fill_and_tied_gradient():
    """An all-masked row gets -1e9 features, not NaN; a tie splits its
    gradient evenly, as jnp.max's."""
    x = np.random.RandomState(0).randn(3, 4, 2).astype(np.float32)
    x[1, 0, 0] = x[1, 2, 0] = 5.0  # a tie in row 1, channel 0
    mask = np.ones((3, 4), np.float32)
    mask[0] = 0.0
    mask[2, 1:] = 0.0

    def ref(x):
        return jnp.where(jnp.asarray(mask)[..., None] > 0, x, -1e9).max(axis=1)

    w = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    want = ref(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * ref(v)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = masked_max(t, torch.from_numpy(mask))
    (torch.from_numpy(w) * got).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert float(got[0].max().detach()) == -1e9 and torch.isfinite(got).all()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want_g))
    assert float(t.grad[1, 0, 0]) == float(t.grad[1, 2, 0]) == w[1, 0] / 2


def test_embed_pool_is_flax_take_multiply_sum():
    """ids (B, S, T) with a mask, ids out of range both ways among them: the
    same sums, NaN where flax's take reads NaN (NaN · 0 too), and the same
    table gradient from the rows that are in range."""
    rng = np.random.RandomState(0)
    rows, dim = 20, 6
    table = rng.randn(rows, dim).astype(np.float32)
    ids = rng.randint(0, rows, (4, 2, 5)).astype(np.int32)
    mask = (rng.rand(4, 2, 5) < 0.6).astype(np.float32)
    ids[0, 0, 1], ids[1, 1, 2], ids[2, 0, 0] = rows + 3, -1, -rows - 4
    mask[0, 0, 1] = 0.0  # NaN · 0 is NaN on both sides

    def ref(t):
        return (jnp.take(t, jnp.asarray(ids), axis=0) * jnp.asarray(mask)[..., None]).sum(2)

    want = np.asarray(ref(jnp.asarray(table)))
    emb = Embed(rows, dim)
    emb.embedding.data = torch.from_numpy(table.copy())
    got = emb.pool(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (4, 2, dim)
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), np.isnan(want))
    assert np.isnan(want[0, 0]).all() and np.isnan(want[2, 0]).all()
    np.testing.assert_allclose(np.nan_to_num(got.detach().numpy()), np.nan_to_num(want),
                               rtol=0, atol=1e-6)
    # the gradient, from the bags without NaN
    keep = ~np.isnan(want).any(-1)
    w = rng.randn(4, 2, dim).astype(np.float32) * keep[..., None]
    want_g = jax.grad(lambda t: jnp.sum(jnp.where(jnp.asarray(keep)[..., None],
                                                  jnp.asarray(w) * ref(t), 0.0)))(
        jnp.asarray(table))
    out = torch.where(torch.from_numpy(keep)[..., None], torch.from_numpy(w) * got,
                      torch.zeros(()))
    out.sum().backward()
    np.testing.assert_allclose(emb.embedding.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)
