"""The multitask family's layers against flax, and the second order of the
lookup against JAX.

* ``DenseGeneral``, ``CGCLayer`` (a middle level and a last one),
  ``DSelectKGate`` (with ``smooth_step``), ``ConvExperts`` and
  ``TransductiveBN`` from the flax modules' initial parameters: the output,
  every parameter's gradient and every input's gradient of a random linear
  read-out, atol 1e-5 (float32 sums in another order).
* ``gather_pool``'s second order on the CPU (the plain version, which
  autograd differentiates twice) against ``jax.grad`` of ``jax.grad``: an
  inner gradient step on the table as metaheac takes it, then the gradient
  of a loss on the stepped table, with ids that repeat, a mask, and ids out
  of range in both modes; atol 1e-6.
* The same second order through the autograd functions that run K1 and K1b
  on the card, their launches replaced by the plain versions (the kernels
  build only on the card): equal to the plain path, every launch of both
  orders counted.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.models.multitask.dselect_k import model as jax_dselect
from paddlerec_tpu.models.multitask.maml import model as jax_maml
from paddlerec_tpu.models.multitask.ple import model as jax_ple
from paddlerec_tpu.ops.pallas_embedding import gather_pool_reference
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.models.multitask.dselect_k import model as port_dselect
from paddlerec_tpu_torch.models.multitask.maml import model as port_maml
from paddlerec_tpu_torch.models.multitask.ple import model as port_ple
from paddlerec_tpu_torch.ops import gather_pool as gp
from paddlerec_tpu_torch.ops.layers import DenseGeneral

torch.set_num_threads(1)


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def check_layer(flax_mod, port_mod, inputs, to_port=lambda xs: xs, from_port=lambda o: o,
                atol=1e-5):
    """Initialise ``flax_mod`` on ``inputs`` (numpy), load its parameters into
    ``port_mod`` and compare the outputs and the gradients of ``Σ c·out``
    (``c`` random, one per output) with respect to every parameter and every
    input.  ``to_port`` maps the torch inputs to the port module's
    arguments, ``from_port`` its output to the flax layout."""
    rng = np.random.RandomState(5)
    params = flax_mod.init(jax.random.PRNGKey(1), *inputs)["params"]
    outs = _as_list(flax_mod.apply({"params": params}, *inputs))
    coefs = [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]

    def read_out(p, *xs):
        got = _as_list(flax_mod.apply({"params": p}, *xs))
        return sum(jnp.sum(o * c) for o, c in zip(got, coefs))

    g_params, *g_inputs = jax.grad(read_out, argnums=tuple(range(len(inputs) + 1)))(
        params, *inputs)
    port_mod.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    xs = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    got = _as_list(from_port(port_mod(*to_port(xs))))
    assert len(got) == len(outs)
    for o, ref in zip(got, outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, coefs)).backward()
    want = from_jax_params(jax.tree.map(np.asarray, g_params))
    named = dict(port_mod.named_parameters())
    assert sorted(named) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    for x, g in zip(xs, g_inputs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=0, atol=atol)
        assert float(np.abs(np.asarray(g)).max()) > 0


def test_dense_general_matches_flax():
    x = np.random.RandomState(0).randn(6, 11).astype(np.float32)
    check_layer(fnn.DenseGeneral((3, 5)), DenseGeneral(11, (3, 5)), [x])


@pytest.mark.parametrize("is_last", [False, True])
def test_cgc_layer_matches_flax(is_last):
    rng = np.random.RandomState(1)
    xs = [rng.randn(6, 9).astype(np.float32) for _ in range(3)]  # two tasks, shared
    check_layer(jax_ple.CGCLayer(2, 2, 1, 4, is_last),
                port_ple.CGCLayer(9, 2, 2, 1, 4, is_last),
                [xs], to_port=lambda t: t)


@pytest.mark.parametrize("expert_num", [3, 4])
def test_dselect_k_gate_matches_flax(expert_num):
    experts = np.random.RandomState(2).randn(5, expert_num, 7).astype(np.float32)
    check_layer(jax_dselect.DSelectKGate(expert_num, 2),
                port_dselect.DSelectKGate(expert_num, 2), [experts])


def test_smooth_step_matches_jax_on_both_ramps():
    x = np.linspace(-0.8, 0.8, 33).astype(np.float32)  # the ends past ±γ/2 = ±0.5
    want = np.asarray(jax_dselect.smooth_step(jnp.asarray(x)))
    got = port_dselect.smooth_step(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == 0.0 and got[-1] == 1.0
    dwant = np.asarray(jax.grad(lambda v: jax_dselect.smooth_step(v).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    port_dselect.smooth_step(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), dwant, rtol=0, atol=1e-6)


def test_conv_experts_match_flax():
    """The grouped conv and the per-expert (h, w, c) flatten: a (c, h, w)
    flatten would give other outputs here."""
    images = np.random.RandomState(3).rand(3, 36, 36, 1).astype(np.float32)
    check_layer(jax_dselect.ConvExperts(2, 6), port_dselect.ConvExperts(2, 6), [images])


def test_conv_experts_init_counts_the_expert_axis():
    """flax's lecun_normal on (E, in, out) takes fan_in = E·in: the port draws
    fc1_w with the same spread (a truncated normal of variance 1/(E·in))."""
    e = 4
    w = port_dselect.ConvExperts(e, 8, generator=torch.Generator().manual_seed(0)).fc1_w
    flax_w = jax_dselect.ConvExperts(e, 8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 36, 36, 1)))["params"]["fc1_w"]
    want = 1.0 / np.sqrt(e * 720)
    w = w.detach()
    assert abs(float(w.std()) - want) < 0.02 * want
    assert abs(float(np.std(np.asarray(flax_w))) - want) < 0.02 * want
    assert float(w.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-7


def test_transductive_bn_matches_flax():
    """Batch statistics with the population variance, eps 1e-5; the port's
    input is NCHW."""
    x = np.random.RandomState(4).randn(4, 5, 5, 3).astype(np.float32) * 2 + 1
    check_layer(jax_maml.TransductiveBN(), port_maml.TransductiveBN(3), [x],
                to_port=lambda xs: [xs[0].permute(0, 3, 1, 2)],
                from_port=lambda o: o.permute(0, 2, 3, 1))


# -- the second order of the lookup -------------------------------------------
ROWS, DIM, LR = 40, 6, 0.3


def _jax_lookup(table, ids, mask, mode, out_of_range):
    """The JAX side of ``gather_pool``: ``gather_pool_reference`` (take,
    mode="clip") where every id is in range; ``jnp.take``'s fill mode (what
    flax's ``nn.Embed`` reads with) for ``mode="fill"``; for ``mode="clip"``
    with ids out of range, the clipped rows with their gradient stopped, as
    the JAX ``SlotEmbedding``'s backward drops them (``mode="drop"``)."""
    if mode == "fill":
        return (jnp.take(table, ids, axis=0) * mask[..., None]).sum(1)
    if not out_of_range:
        return gather_pool_reference(table, ids, mask)
    inside = ((ids >= 0) & (ids < table.shape[0]))[..., None]
    rows = jnp.take(table, ids, axis=0, mode="clip")
    return (jnp.where(inside, rows, jax.lax.stop_gradient(rows)) * mask[..., None]).sum(1)


def _meta_case(mode, out_of_range, seed):
    """A table, support and query ids and masks, and the read-out weights.
    Fill mode looks up one id a row (as ``Embed``): a NaN row would poison
    its pooled neighbours."""
    rng = np.random.RandomState(seed)
    pool = 1 if mode == "fill" else 3
    lo, hi = (-ROWS - 3, ROWS + 3) if out_of_range else (0, ROWS // 4)
    case = {"table": rng.randn(ROWS, DIM).astype(np.float32)}
    for part, n in (("spt", 30), ("qry", 20)):
        case[f"{part}_ids"] = rng.randint(lo, hi, (n, pool)).astype(np.int32)
        case[f"{part}_mask"] = (rng.rand(n, pool) * (rng.rand(n, pool) < 0.8)).astype(
            np.float32)
        case[f"{part}_w"] = rng.randn(n, DIM).astype(np.float32)
    if out_of_range:  # the query reads in-range ids, so its loss is finite
        case["qry_ids"] = np.abs(case["qry_ids"]) % (ROWS // 2)
    return case


def _jax_meta_grad(case, mode, out_of_range):
    c = {k: jnp.asarray(v) for k, v in case.items()}

    def inner(t):
        out = _jax_lookup(t, c["spt_ids"], c["spt_mask"], mode, out_of_range)
        return jnp.sum(c["spt_w"] * jnp.tanh(out))

    def outer(t):
        fast = t - LR * jax.grad(inner)(t)
        out = _jax_lookup(fast, c["qry_ids"], c["qry_mask"], mode, out_of_range)
        return jnp.sum(c["qry_w"] * jnp.sin(out))

    return np.asarray(jax.grad(outer)(c["table"]))


def _port_meta_grad(case, mode, lookup=gp.gather_pool):
    c = {k: torch.from_numpy(v) for k, v in case.items()}
    table = c["table"].clone().requires_grad_()
    out = lookup(table, c["spt_ids"], c["spt_mask"], mode=mode)
    (g,) = torch.autograd.grad(torch.sum(c["spt_w"] * torch.tanh(out)), table,
                               create_graph=True)
    out = lookup(table - LR * g, c["qry_ids"], c["qry_mask"], mode=mode)
    torch.sum(c["qry_w"] * torch.sin(out)).backward()
    return table.grad.numpy()


@pytest.mark.parametrize("mode,out_of_range", [("clip", False), ("clip", True),
                                               ("fill", False), ("fill", True)])
def test_second_order_matches_jax(mode, out_of_range):
    case = _meta_case(mode, out_of_range, seed=7)
    want = _jax_meta_grad(case, mode, out_of_range)
    got = _port_meta_grad(case, mode)
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 1e-3
    # float32 sums of a few dozen terms per row, in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _fake_k1(table, ids, mask, out_dtype, mode):
    gp.gather_pool.launches += 1
    return gp.gather_pool_plain(table, ids, mask, out_dtype, mode)


def _fake_k1b(g, ids, mask, rows, dtype, mode):
    gp.gather_pool_bwd.launches += 1
    return gp.gather_pool_bwd_plain(g, ids, mask, rows, dtype, mode)


def _routed(table, ids, mask=None, out_dtype=None, mode="clip"):
    """``gather_pool``'s CUDA route for a CPU tensor."""
    ids, mask = gp._check_ids_mask(ids, mask, table.device)
    return gp._GatherPoolCuda.apply(table, ids, mask, gp._out_dtype(table, out_dtype), mode)


@pytest.fixture
def routed(monkeypatch):
    """The autograd functions of the card with the plain versions in place of
    the two launches, and the launch counts from 0."""
    monkeypatch.setattr(gp, "_gather_pool_cuda", _fake_k1)
    monkeypatch.setattr(gp, "_gather_pool_bwd_cuda", _fake_k1b)
    monkeypatch.setattr(gp.gather_pool, "launches", 0)
    monkeypatch.setattr(gp.gather_pool_bwd, "launches", 0)
    return _routed


@pytest.mark.parametrize("mode,out_of_range", [("clip", True), ("fill", True),
                                               ("fill", False)])
def test_second_order_through_the_card_functions(routed, mode, out_of_range):
    """Forward K1 twice (support, query), K1b once in the inner gradient; the
    outer gradient runs K1b for the query, K1 as K1b's backward, and K1b
    again back through the support lookup: three of each."""
    case = _meta_case(mode, out_of_range, seed=8)
    got = _port_meta_grad(case, mode, lookup=routed)
    assert (gp.gather_pool.launches, gp.gather_pool_bwd.launches) == (3, 3)
    np.testing.assert_allclose(got, _port_meta_grad(case, mode), rtol=0, atol=1e-6)


def test_k1b_backward_reads_zero_for_dropped_ids(routed):
    """K1b's backward gathers the incoming gradient where its ids were; an id
    K1b dropped gets exactly zero, whatever row its clip would read."""
    ids = torch.tensor([[0], [7], [-1], [3], [-9]], dtype=torch.int32)
    g = torch.randn(5, 4, requires_grad=True)
    for mode, zero_rows in (("clip", [1, 2, 4]), ("fill", [1, 4])):
        dtable = gp._GatherPoolBwdCuda.apply(g, ids, None, 5, torch.float32, mode)
        up = torch.full((5, 4), 7.0)
        (dg,) = torch.autograd.grad(dtable, g, up)
        for r in range(5):
            want = 0.0 if r in zero_rows else 7.0
            assert torch.all(dg[r] == want), (mode, r, dg[r])
    assert gp.gather_pool_bwd.launches == 2 and gp.gather_pool.launches == 2
