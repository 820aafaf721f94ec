"""The graph family's convs against flax (``paddlerec_tpu/models/graph/
layers.py``): GIN, GraphSAGE mean, bag of words and max, GAT, LightGCN and
TransformerConv at E = 8 over fan-out 3 under two leading axes, from the
same parameters: output and the gradient of every parameter and input of a
random read-out within 1e-5 (float32 sums in another order), with a node
whose mask is all zero (SAGE-max's zero row, GAT's uniform weights) and a
node whose sampled neighbours repeat one vector (SAGE-max's tied maxima,
whose gradient both share evenly).  Then ``take_rows`` against JAX's
``jnp.take(mode="clip")`` and ``x[ids]`` with ids out of range, forward and
gradient, and ``Embed``'s uniform on a range."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.models.graph import layers as jax_layers
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.models.graph import layers as port_layers
from paddlerec_tpu_torch.ops.embedding import Embed, take_rows

torch.set_num_threads(1)

E, K = 8, 3


def _inputs(seed):
    rng = np.random.RandomState(seed)
    self_feat = rng.randn(4, 2, E).astype(np.float32)
    neigh = rng.randn(4, 2, K, E).astype(np.float32)
    mask = (rng.rand(4, 2, K) < 0.7).astype(np.float32)
    mask[0, 0] = 0.0  # no neighbour at all
    mask[1, 1] = 1.0
    neigh[1, 1] = neigh[1, 1, 0]  # three equal neighbours: tied maxima
    return self_feat, neigh, mask


@pytest.mark.parametrize("conv", sorted(jax_layers.CONV_REGISTRY))
def test_conv_matches_flax(conv):
    self_feat, neigh, mask = _inputs(3)
    flax_conv = jax_layers.CONV_REGISTRY[conv](E)
    jin = [jnp.asarray(x) for x in (self_feat, neigh, mask)]
    params = jax.jit(flax_conv.init)(jax.random.PRNGKey(1), *jin).get("params", {})
    port = port_layers.CONV_REGISTRY[conv](E, E)
    state = from_jax_params(jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state)
    out = jax.jit(flax_conv.apply)({"params": params}, *jin)
    weights = np.random.RandomState(4).randn(*out.shape).astype(np.float32)

    def readout(p, s, n):
        return jnp.sum(jnp.asarray(weights) * flax_conv.apply({"params": p}, s, n, jin[2]))

    grads = jax.jit(jax.grad(readout, argnums=(0, 1, 2)))(params, jin[0], jin[1])
    ts, tn = (torch.from_numpy(x).requires_grad_() for x in (self_feat, neigh))
    got = port(ts, tn, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    assert np.ptp(np.asarray(out)) > 0.1
    (torch.from_numpy(weights) * got).sum().backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads[0]))
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    for t, g in ((ts, grads[1]), (tn, grads[2])):
        if t.grad is None:  # LightGCN does not read the node itself
            assert not np.asarray(g).any()
        else:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-5)
    # no neighbour: the masked slots take no gradient, but where attention's
    # uniform weights read every slot (GAT, TransformerConv)
    if conv not in ("gat", "transformer_conv"):
        assert not tn.grad[0, 0].any()
    if conv == "graphsage_max":
        # the tied maxima share the gradient evenly, as JAX's max does
        g = tn.grad[1, 1]
        assert torch.allclose(g[0], g[1]) and torch.allclose(g[1], g[2]) and g.abs().sum() > 0


def test_sage_max_zero_row_and_gat_uniform_weights():
    self_feat, neigh, mask = (torch.from_numpy(x) for x in _inputs(5))
    sage = port_layers.GraphSAGEMaxConv(E, E, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        sage.lin.weight.copy_(torch.cat([torch.zeros(E, E), torch.eye(E)], 1))  # the neighbours
        sage.lin.bias.zero_()
        assert not sage(self_feat, neigh, mask)[0, 0].any()
    gat = port_layers.GATConv(E, E, generator=torch.Generator().manual_seed(0))
    h = gat.w_n(neigh[0, 0])
    with torch.no_grad():
        out = gat(self_feat, neigh, mask)[0, 0]
        want = torch.relu(gat.lin(torch.cat([self_feat[0, 0], h.mean(0)])))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_take_rows_is_jax_clip_take_and_indexing():
    """``wrap=False``: ``jnp.take(x, ids, axis=0, mode="clip")`` (clipped in
    the gradient too); ``wrap=True``: ``x[ids]`` (a negative id wrapped, then
    clipped; an id still out of range gives no gradient)."""
    x = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    ids = np.array([[-1, 7], [2, 5], [-9, 0]])
    w = np.random.RandomState(1).randn(3, 2, 3).astype(np.float32)
    cases = ((False, lambda a: jnp.take(a, jnp.asarray(ids), axis=0, mode="clip")),
             (True, lambda a: a[jnp.asarray(ids)]))
    for wrap, ref in cases:
        out, vjp = jax.vjp(ref, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        got = take_rows(tx, torch.from_numpy(ids), wrap=wrap)
        assert torch.equal(got.detach(), torch.from_numpy(np.asarray(out))), wrap
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]))


def test_embed_uniform_on_a_range():
    emb = Embed(5000, 4, uniform=(-1.0, 1.0), generator=torch.Generator().manual_seed(0))
    t = emb.embedding.detach()
    assert -1.0 <= float(t.min()) < -0.99 and 0.99 < float(t.max()) < 1.0
    assert abs(float(t.mean())) < 0.02
    half = Embed(5000, 4, uniform=0.5, generator=torch.Generator().manual_seed(0))
    assert 0.0 <= float(half.embedding.min()) and float(half.embedding.max()) < 0.5
