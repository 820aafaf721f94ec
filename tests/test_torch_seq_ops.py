"""The port's sequence layers (``ops/sequence.py``), ``TargetAttention`` and
``LayerNorm`` against the JAX modules: the flax parameters carried across
with ``from_jax_params``, the same numpy-seeded inputs (a batch row whose
mask is all zero among them), outputs and the gradient of every parameter
and every float input against ``jax.grad``, atol 1e-5."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops import layers as jax_layers
from paddlerec_tpu.ops import sequence as jax_seq
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.ops import layers, sequence

torch.set_num_threads(1)

B, T, D, H = 5, 7, 6, 8


def _mask(rng, rows=B, t=T):
    """Lengths in [0, t]: row 0 empty, row 1 full, the rest random."""
    lens = rng.randint(0, t + 1, rows)
    lens[0], lens[1] = 0, t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _check(flax_mod, port_mod, inputs, float_args, seed=0, atol=1e-5):
    """Outputs and gradients (every parameter, the inputs at ``float_args``)
    of ``sum_i <out_i, w_i>`` for numpy-seeded weights ``w_i``."""
    rng = np.random.RandomState(seed + 100)
    jin = [jnp.asarray(x) for x in inputs]
    params = jax.jit(flax_mod.init)(jax.random.PRNGKey(seed), *jin)["params"]

    def outputs(p, *xs):
        out = flax_mod.apply({"params": p}, *xs)
        return out if isinstance(out, tuple) else (out,)

    shapes = [o.shape for o in jax.eval_shape(outputs, params, *jin)]
    weights = [rng.randn(*s).astype(np.float32) for s in shapes]

    def loss(p, floats):
        xs = list(jin)
        for i, x in zip(float_args, floats):
            xs[i] = x
        return sum(jnp.sum(o * w) for o, w in zip(outputs(p, *xs), weights))

    want_out = outputs(params, *jin)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, [jin[i] for i in float_args])

    port_mod.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    tin = [torch.from_numpy(np.asarray(x)) for x in inputs]
    for i in float_args:
        tin[i].requires_grad_()
    got = port_mod(*tin)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want_out)
    for g, w in zip(got, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=atol)
    sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, weights)).backward()
    want_grads = from_jax_params(jax.tree.map(np.asarray, gp))
    named = dict(port_mod.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    for i, g in zip(float_args, gx):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(g), rtol=0, atol=atol)
    return got


def test_gru_matches_jax():
    rng = np.random.RandomState(0)
    x, m = rng.randn(B, T, D).astype(np.float32), _mask(rng)
    outs, final = _check(jax_seq.GRU(H), sequence.GRU(D, H), [x, m], [0])
    # an empty history keeps the zero state
    assert not final[0].any() and not outs[0].any()


def test_augru_matches_jax():
    rng = np.random.RandomState(1)
    x, m = rng.randn(B, T, H).astype(np.float32), _mask(rng)
    att = rng.rand(B, T).astype(np.float32)
    _check(jax_seq.AUGRU(H), sequence.AUGRU(H, H), [x, att, m], [0, 1])


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse):
    rng = np.random.RandomState(2)
    x, m = rng.randn(B, T, D).astype(np.float32), _mask(rng)
    _check(jax_seq.LSTM(H, reverse=reverse), sequence.LSTM(D, H, reverse=reverse),
           [x, m], [0])


def test_bilstm_matches_jax():
    rng = np.random.RandomState(3)
    x, m = rng.randn(B, 5, 8).astype(np.float32), _mask(rng, t=5)
    _check(jax_seq.BiLSTM(8, num_layers=2), sequence.BiLSTM(8, 8, num_layers=2), [x, m], [0])


@pytest.mark.parametrize("heads,head_dim,ffn,act", [
    (2, 4, 10, "relu"), (2, 4, 10, "gelu"),
    (8, 1, 16, "relu"),  # dsin's shape: 8 heads of width 1 over d = 8
])
def test_transformer_block_matches_jax(heads, head_dim, ffn, act):
    rng = np.random.RandomState(4)
    x, m = rng.randn(B, T, 8).astype(np.float32), _mask(rng)
    out = _check(jax_seq.TransformerBlock(heads, head_dim, ffn, act),
                 sequence.TransformerBlock(8, heads, head_dim, ffn, act), [x, m], [0])[0]
    # a row with no valid key attends uniformly (finite -1e9 fill), not NaN
    assert bool(torch.isfinite(out).all())


def test_sinusoidal_table_is_bitwise():
    for t, d in ((10, 8), (7, 5), (1, 1)):
        want = np.asarray(jax_seq.sinusoidal_position_encoding(t, d))
        got = sequence.sinusoidal_position_encoding(t, d)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert sequence.sinusoidal_position_encoding(10, 8) is sequence.sinusoidal_position_encoding(10, 8)


@pytest.mark.parametrize("use_softmax,scale", [(True, True), (True, False), (False, False)])
def test_target_attention_matches_jax(use_softmax, scale):
    rng = np.random.RandomState(5)
    hist, m = rng.randn(B, T, D).astype(np.float32), _mask(rng)
    target = rng.randn(B, D).astype(np.float32)
    out = _check(
        jax_layers.TargetAttention(hidden_sizes=(12, 6), use_softmax=use_softmax,
                                   scale_scores=scale),
        layers.TargetAttention(D, (12, 6), use_softmax=use_softmax, scale_scores=scale),
        [hist, target, m], [0, 1])[0]
    if use_softmax:  # the empty row: the plain mean of its (padded) history
        np.testing.assert_allclose(out[0].detach().numpy(), hist[0].mean(0), atol=1e-6)


def test_layer_norm_matches_flax():
    """flax's epsilon (1e-6).  flax takes the variance as E[x²] - E[x]², the
    port's ``F.layer_norm`` in two passes: on rows with some spread the two
    agree within 1e-5.  A constant row is left out: there both normalise
    rounding noise of the mean by 1/sqrt(eps) = 1000 (measured 2.8e-4 apart in
    the scale's gradient), and no model feeds its norms one."""
    rng = np.random.RandomState(6)
    x = (rng.randn(B, 3, 11) * 3 + 1).astype(np.float32)
    norm = layers.LayerNorm(11)
    assert norm.eps == 1e-6
    _check(fnn.LayerNorm(), norm, [x], [0])
