"""``Embed`` (the port's flax ``nn.Embed``) and K1's fill mode against the JAX
package: lookups bitwise in range, ids out of range as ``jnp.take`` treats
them (a negative id wrapped once, the rest NaN rows that take no gradient),
the gradient with repeated ids against ``jax.grad`` (atol 1e-6), several id
tensors in one lookup, ``attend``, and the initialisation."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.ops.embedding import Embed
from paddlerec_tpu_torch.ops.gather_pool import (
    gather_pool, gather_pool_bwd_plain, gather_pool_plain,
)

torch.set_num_threads(1)

V, E = 50, 6


def _pair(seed=0, vocab=V, features=E):
    ref = fnn.Embed(vocab, features)
    params = ref.init(jax.random.PRNGKey(seed), jnp.zeros((1,), jnp.int32))["params"]
    port = Embed(vocab, features)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return ref, params, port


@pytest.mark.parametrize("shape,dtype", [((7,), np.int32), ((4, 5), np.int64),
                                         ((2, 3, 4), np.int64)])
def test_lookup_in_range_is_bitwise(shape, dtype):
    ref, params, port = _pair()
    ids = np.random.RandomState(0).randint(0, V, shape).astype(dtype)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(ids)))
    got = port(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == shape + (E,)
    assert got.detach().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_ids_out_of_range_follow_jnp_take(dtype):
    """-1 reads the last row and trains it; V, -V-1 and beyond read NaN and
    give no gradient; -V reads row 0."""
    ref, params, port = _pair()
    ids = np.array([-1, V, -V - 1, -V, V + 7, 3, 3, -1], dtype)
    if dtype == np.int64:
        ids = np.concatenate([ids, np.array([2 ** 40, -(2 ** 40)], dtype)])
    rng = np.random.RandomState(1)
    weight = rng.randn(len(ids), E).astype(np.float32)
    # JAX (64-bit off) holds int32 ids: the values beyond int32 are left out
    # of its side; the port clamps them before its cast
    fits = np.abs(ids) < 2 ** 31
    jids = jnp.asarray(ids[fits].astype(np.int32))
    want = np.asarray(ref.apply({"params": params}, jids))

    def loss(p):
        out = ref.apply({"params": p}, jids)
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * weight[fits])

    want_grad = np.asarray(jax.grad(loss)(params)["embedding"])
    got = port(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy()[fits], want)  # NaN where JAX's
    assert bool(torch.isnan(got[~torch.from_numpy(fits)]).all())
    assert torch.equal(got[0], port.embedding[V - 1]) and torch.equal(got[3], port.embedding[0])
    torch.nan_to_num(got * torch.from_numpy(weight), nan=0.0).sum().backward()
    np.testing.assert_allclose(port.embedding.grad.numpy(), want_grad, rtol=0, atol=1e-6)
    assert port.embedding.grad[V - 1].any() and not port.embedding.grad[1].any()


def test_gradient_with_repeated_ids_matches_jax():
    ref, params, port = _pair(seed=2, vocab=20)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 20, (16, 9)).astype(np.int32)  # every row many times
    weight = rng.randn(16, 9, E).astype(np.float32)
    grad = jax.grad(lambda p: jnp.sum(ref.apply({"params": p}, jnp.asarray(ids)) * weight))
    want = np.asarray(grad(params)["embedding"])
    (port(torch.from_numpy(ids)) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(port.embedding.grad.numpy(), want, rtol=0, atol=1e-6)


def test_several_id_tensors_in_one_lookup():
    _, _, port = _pair()
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randint(0, V, (4, 5)).astype(np.int64))
    b = torch.from_numpy(rng.randint(-1, V + 1, (4,)).astype(np.int64))
    wa, wb = torch.randn(4, 5, E), torch.randn(4, E)
    got_a, got_b = port(a, b)
    np.testing.assert_array_equal(got_a.detach().numpy(), port(a).detach().numpy())
    np.testing.assert_array_equal(got_b.detach().numpy(), port(b).detach().numpy())
    (torch.nan_to_num(got_a * wa).sum() + torch.nan_to_num(got_b * wb).sum()).backward()
    merged = port.embedding.grad.clone()
    port.embedding.grad = None
    (torch.nan_to_num(port(a) * wa).sum() + torch.nan_to_num(port(b) * wb).sum()).backward()
    np.testing.assert_allclose(merged.numpy(), port.embedding.grad.numpy(), rtol=0, atol=1e-6)


def test_attend_matches_flax():
    ref, params, port = _pair()
    x = np.random.RandomState(4).randn(3, E).astype(np.float32)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(x), method=ref.attend))
    got = port.attend(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)


def test_init_matches_flax_default():
    """flax's default: variance_scaling(1, fan_in, normal) over (V, E), a
    normal of std 1/sqrt(E), not truncated; ``zeros=True`` for din's item
    bias."""
    vocab, features = 4000, 64
    params = jax.jit(fnn.Embed(vocab, features).init)(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]
    want = np.asarray(params["embedding"])
    got = Embed(vocab, features, generator=torch.Generator().manual_seed(0)).embedding
    got = got.detach().numpy()
    assert abs(got.std() / want.std() - 1) < 0.05 and abs(want.std() * 8 - 1) < 0.05
    assert abs(got.mean()) < 0.01 and abs(want.mean()) < 0.01
    # a truncated normal has nothing beyond 2 std; a normal 4.6% of its values
    beyond = [float(np.mean(np.abs(w) > 2 / 8)) for w in (got, want)]
    assert all(0.04 < b < 0.052 for b in beyond), beyond
    assert not Embed(30, 1, zeros=True).embedding.any()


def test_fill_mode_of_the_pooled_lookup_and_its_gradient():
    """K1's plain version in fill mode, L = 3 with a mask, against jnp.take
    (fill) and the gradient of that sum; the backward's plain version wraps
    negative ids as the forward reads them."""
    rng = np.random.RandomState(5)
    table = rng.randn(30, 4).astype(np.float32)
    ids = rng.randint(-32, 33, (40, 3)).astype(np.int32)
    mask = (rng.rand(40, 3) < 0.7).astype(np.float32)
    weight = rng.randn(40, 4).astype(np.float32)

    def ref(t):
        rows = jnp.take(t, jnp.asarray(ids), axis=0)  # (40, 3, 4), NaN where outside
        return jnp.sum(rows * mask[..., None], axis=1)

    want = np.asarray(ref(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    got = gather_pool(t, torch.from_numpy(ids), torch.from_numpy(mask), mode="fill")
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    live = np.isfinite(want).all(axis=1)
    assert 0 < live.sum() < len(live)
    keep = torch.from_numpy(live)[:, None]
    (torch.where(keep, got, 0.0) * torch.from_numpy(weight)).sum().backward()
    grad = jax.grad(lambda x: jnp.sum(jnp.where(live[:, None], ref(x), 0.0) * weight))
    want_grad = np.asarray(grad(jnp.asarray(table)))
    np.testing.assert_allclose(t.grad.numpy(), want_grad, rtol=0, atol=1e-6)
    # the backward's plain version on its own: out-of-range ids dropped,
    # negative ones wrapped, rows whose output is NaN given no gradient
    g = torch.from_numpy(weight) * keep
    direct = gather_pool_bwd_plain(g, torch.from_numpy(ids), torch.from_numpy(mask), 30,
                                   mode="fill")
    np.testing.assert_allclose(direct.numpy(), want_grad, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        gather_pool_plain(t, torch.from_numpy(ids), mode="wrap")
