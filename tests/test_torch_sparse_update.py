"""The sparse row-wise update rules and the external lookup of the port
against the JAX package: the same tables, ids, gradients and noise, made from
a numpy seed, through ``paddlerec_tpu/ops/sparse_update.py`` (under
``jax.jit``, as the trainer runs it) and ``paddlerec_tpu_torch/ops/sparse_update.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops import embedding as jax_embedding
from paddlerec_tpu.ops import sparse_update as ref
from paddlerec_tpu_torch.convert import _to_numpy, _to_torch
from paddlerec_tpu_torch.ops import sparse_update as port
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding

torch.set_num_threads(1)

VOCAB, DIM, WIDTH, PACK = 1003, 10, 16, 8  # a fused E+1 = 10 table: 8 ids a row
ROWS = (VOCAB + PACK - 1) // PACK
N, STEPS, LR = 96, 5, 0.05


def _place(g, sub):
    """(N, w) gradients → the JAX package's (N, 128) delta rows."""
    out = np.zeros((g.shape[0], 128), np.float32)
    for n in range(g.shape[0]):
        out[n, sub[n] * WIDTH:(sub[n] + 1) * WIDTH] = g[n]
    return out


def _step_inputs(rng, step):
    """Raw ids beyond the vocab (hashed), duplicates, ids sharing a physical
    row, one row whose gradients cancel exactly and one with a zero gradient."""
    ids = rng.randint(0, 3 * VOCAB, N).astype(np.int64)
    ids[1] = ids[0]                      # a duplicate id
    ids[2] = (ids[0] % VOCAB) // PACK * PACK + (ids[0] % VOCAB + 1) % PACK  # same row, other lane
    ids[3], ids[4] = 8 * 57 + 2, 8 * 57 + 2 + VOCAB   # row 57: g and -g
    ids[5] = 8 * 91 + step % 8                        # row 91: zero gradient
    others = np.ones(N, bool)
    others[[3, 4, 5]] = False
    clash = others & np.isin((ids % VOCAB) // PACK, (57, 91))
    ids[clash] = 0
    g = (rng.randn(N, WIDTH) * (0.1 if step % 2 else 1e-3)).astype(np.float32)
    g[:, DIM:] = 0.0                     # pad lanes take no gradient
    g[4] = -g[3]
    g[5] = 0.0
    hashed = ids % VOCAB
    return ids, g, (hashed % PACK).astype(np.int32), (hashed // PACK).astype(np.int32)


def _table(rng, dtype):
    t = (rng.randn(ROWS, 128) * 0.05).astype(np.float32)
    return jnp.asarray(t, jnp.dtype(dtype))


def _states(rule, table):
    if rule.startswith("adagrad"):
        return ref.rowwise_adagrad_init(table), port.rowwise_adagrad_init
    return ref.rowwise_adam_init(table), port.rowwise_adam_init


@pytest.mark.parametrize("seed,n,rows", [(0, 64, 20), (1, 257, 1000), (2, 5, 3)])
def test_dedup_rows_and_host_dedup_match_jax(seed, n, rows):
    rng = np.random.RandomState(seed)
    phys = rng.randint(0, rows, n).astype(np.int32)
    want_u, want_s = ref.dedup_rows(jnp.asarray(phys), rows)
    got_u, got_s = port.dedup_rows(torch.from_numpy(phys), rows)
    assert got_u.dtype == torch.int32 and got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_u.numpy()[got_s.numpy()], phys)

    ids = rng.randint(0, 10 * rows, (n, 3)).astype(np.int64)
    want = ref.host_dedup(ids, rows * 4 - 1, 4)
    got = port.host_dedup(ids, rows * 4 - 1, 4)
    assert port.SENTINEL == ref.SENTINEL
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("vocab,rows,mp", [
    (1000001, 125001, 1), (100000001, 12500001, 1), (1003, 1003, 1), (1003, 63, 1),
    (1003, 128, 4), (1003, 127, 1),
])
def test_infer_pack_matches_jax(vocab, rows, mp):
    try:
        want = ref.infer_pack(vocab, rows, mp)
    except ValueError:
        with pytest.raises(ValueError, match="no pack factor"):
            port.infer_pack(vocab, rows, mp)
        assert (vocab, rows) == (1003, 127)
    else:
        assert port.infer_pack(vocab, rows, mp) == want


RULES = ["adagrad_compact", "adam_compact", "adagrad", "adam"]


def _run_rule(rule, dtype):
    """STEPS steps of one rule through both packages.  Returns the JAX
    (table, state) and the port's."""
    rng = np.random.RandomState(7)
    table = _table(rng, dtype)
    state, port_init = _states(rule, table)
    p_table = _to_torch(np.asarray(table)).clone()
    p_state = port_init(p_table)
    ref_fn = {"adagrad_compact": ref.apply_sparse_adagrad_compact,
              "adam_compact": ref.apply_sparse_adam_compact,
              "adagrad": ref.apply_sparse_adagrad,
              "adam": ref.apply_sparse_update}[rule]
    port_fn = {"adagrad_compact": port.apply_sparse_adagrad_compact,
               "adam_compact": port.apply_sparse_adam_compact,
               "adagrad": port.apply_sparse_adagrad,
               "adam": port.apply_sparse_update}[rule]
    jitted = jax.jit(lambda t, s, *a: ref_fn(t, s, *a, LR))
    for step in range(STEPS):
        ids, g, sub, phys = _step_inputs(rng, step)
        dg = jnp.asarray(_place(g, sub))
        tg, tsub = torch.from_numpy(g), torch.from_numpy(sub)
        if rule.endswith("compact"):
            uniq, slot = ref.host_dedup(ids, VOCAB, PACK)
            table, state = jitted(table, state, dg, jnp.asarray(uniq), jnp.asarray(slot))
            port_fn(p_table, p_state, tg, torch.from_numpy(uniq),
                    torch.from_numpy(slot), LR, sub=tsub,
                    num_uniq=None if step % 2 else int((uniq != port.SENTINEL).sum()))
        else:
            table, state = jitted(table, state, dg, jnp.asarray(phys))
            port_fn(p_table, p_state, tg, torch.from_numpy(phys), LR, sub=tsub)
    return table, state, p_table, p_state


# f32 table: the same float32 arithmetic up to the last bit (XLA fuses a*b + c,
# writes x / sqrt(y) as x * rsqrt(y) and folds scalars), on entries of size
# 0.05 that move up to lr = 0.05 a step.  bf16 table: that f32 result is
# rounded once on both sides, so entries agree bitwise except where a last
# f32 bit flips the rounding; those are counted and are one bf16 ulp off.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", RULES)
def test_update_rule_matches_jax(rule, dtype):
    table, state, p_table, p_state = _run_rule(rule, dtype)
    want = _to_torch(np.asarray(table))
    assert p_table.dtype == want.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(p_table.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    else:
        differ = p_table != want
        assert int(differ.sum()) <= 8, int(differ.sum())  # of 16,128 (measured: 0-2)
        ulp = 2.0 ** -7 * want.float().abs().clamp(min=2.0 ** -126)
        assert bool(((p_table.float() - want.float()).abs() <= ulp).all())
    for field in state._fields:
        got, ref_v = getattr(p_state, field), np.asarray(getattr(state, field))
        if field == "count":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref_v)
            assert got.max() >= 2  # a row was stepped more than once
        else:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref_v, rtol=1e-6, atol=1e-7)
    # rows no id touched: bit-identical to the start
    rng = np.random.RandomState(7)
    start = _to_torch(np.asarray(_table(rng, dtype)))
    touched = np.zeros(ROWS, bool)
    for step in range(STEPS):
        touched[_step_inputs(rng, step)[3]] = True
    assert touched.sum() < ROWS
    assert torch.equal(p_table[~touched], start[~touched])
    if "adam" in rule:
        # row 57's gradients cancel exactly and row 91's is zero: lazy Adam
        # takes no step there
        assert torch.equal(p_table[[57, 91]], start[[57, 91]])
        assert int(p_state.count[57]) == int(p_state.count[91]) == 0
        assert float(p_state.m[[57, 91]].abs().max()) == 0.0
    else:
        assert float(p_state.acc[57]) == 0.0 == float(p_state.acc[91])


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_compact_branch_equals_dense_scratch_branch(rule):
    """Port against port, as the reference's own test holds its two
    branches together (atol 1e-6)."""
    _, _, compact, c_state = _run_rule(rule + "_compact", "float32")
    _, _, scratch, s_state = _run_rule(rule, "float32")
    np.testing.assert_allclose(compact.numpy(), scratch.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(c_state, s_state):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_rowwise_adam_matches_jax():
    rng = np.random.RandomState(3)
    table = _table(rng, "float32")
    state = ref.rowwise_adam_init(table)
    p_table = _to_torch(np.asarray(table)).clone()
    p_state = port.rowwise_adam_init(p_table)
    jitted = jax.jit(lambda t, s, u, g: ref.rowwise_adam(t, s, u, g, LR))
    for _ in range(3):
        phys = rng.randint(0, ROWS, 40).astype(np.int32)
        uniq, _ = ref.dedup_rows(jnp.asarray(phys), ROWS)
        g = (rng.randn(40, 128) * 0.1).astype(np.float32)
        table, state = jitted(table, state, uniq, jnp.asarray(g))
        port.rowwise_adam(p_table, p_state, torch.from_numpy(np.array(uniq)),
                          torch.from_numpy(g), LR)
    np.testing.assert_allclose(p_table.numpy(), np.asarray(table), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p_state.m.numpy(), np.asarray(state.m), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p_state.v.numpy(), np.asarray(state.v), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(p_state.count.numpy(), np.asarray(state.count))


def test_stochastic_round_is_bitwise_given_the_noise():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * np.exp(rng.randn(4096) * 4)).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0e38]
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16, dtype=jnp.uint32))
    want = ref.stochastic_round_bf16(jnp.asarray(x), key)
    for as_dtype in (np.int64, np.int32):
        got = port.stochastic_round_bf16(torch.from_numpy(x),
                                         torch.from_numpy(noise.astype(as_dtype)))
        assert got.dtype == torch.bfloat16
        assert _to_numpy(got).tobytes() == np.asarray(want).tobytes()


def test_stochastic_rounding_accumulates_tiny_updates():
    """The reference's property test, on the port: round-to-nearest freezes
    the stored value; stochastic rounding keeps it right in expectation."""
    gen = torch.Generator().manual_seed(0)
    table = torch.zeros(1, dtype=torch.bfloat16)
    x = torch.full((4096,), 1.0)
    tiny = 1e-4  # far below bf16 resolution at 1.0 (~0.0078)
    assert float(((x + tiny).to(torch.bfloat16).float() - 1.0).abs().max()) == 0.0
    sr = port._cast_to_table(x + tiny, table, gen)
    assert sr.dtype == torch.bfloat16
    assert abs(float(sr.float().mean()) - (1.0 + tiny)) < 3e-5
    stored = torch.full((4096,), 1.0, dtype=torch.bfloat16)
    for _ in range(500):
        stored = port._cast_to_table(stored.float() + tiny, table, gen)
    assert abs(float(stored.float().mean()) - 1.0 - 500 * tiny) < 0.01
    # no generator, or a float32 table: round to nearest
    assert torch.equal(port._cast_to_table(x + tiny, table, None), x.to(torch.bfloat16))
    assert port._cast_to_table(x + tiny, x, gen).dtype == torch.float32


@pytest.mark.parametrize("rule", ["adagrad_compact", "adam"])
def test_untouched_lanes_come_back_bit_identical_under_stochastic_rounding(rule):
    """An exact bf16 value has zero low bits: whatever the noise, lanes
    whose gradient is zero keep their bits, in touched rows too."""
    rng = np.random.RandomState(5)
    table = _to_torch(np.asarray(_table(rng, "bfloat16"))).clone()
    start = table.clone()
    ids, g, sub, phys = _step_inputs(rng, 1)
    gen = torch.Generator().manual_seed(1)
    if rule == "adagrad_compact":
        uniq, slot = port.host_dedup(ids, VOCAB, PACK)
        port.apply_sparse_adagrad_compact(
            table, port.rowwise_adagrad_init(table), torch.from_numpy(g),
            torch.from_numpy(uniq), torch.from_numpy(slot), LR, rng=gen,
            sub=torch.from_numpy(sub))
    else:
        port.apply_sparse_update(
            table, port.rowwise_adam_init(table), torch.from_numpy(g),
            torch.from_numpy(phys), LR, rng=gen, sub=torch.from_numpy(sub))
    lanes = np.zeros((ROWS, 128), bool)
    for n in range(N):
        if np.any(g[n] != 0):
            lanes[phys[n], sub[n] * WIDTH:sub[n] * WIDTH + DIM] = True
    if rule == "adam":
        lanes[57] = False  # cancelled: no step at all
    lanes = torch.from_numpy(lanes)
    assert torch.equal(table[~lanes], start[~lanes])
    assert float((table[lanes].float() - start[lanes].float()).abs().mean()) > 0


def test_narrow_gradient_needs_sub():
    table = torch.zeros(ROWS, 128)
    with pytest.raises(ValueError, match="sub"):
        port.apply_sparse_adagrad(table, port.rowwise_adagrad_init(table),
                                  torch.zeros(4, 16), torch.zeros(4, dtype=torch.int32), LR)
    with pytest.raises(ValueError, match="delta_grad"):
        port.apply_sparse_adagrad(table, port.rowwise_adagrad_init(table),
                                  torch.zeros(4, 24), torch.zeros(4, dtype=torch.int32), LR)


# -- the external lookup and its captured gradient ---------------------------

def _lookup_pair(dtype, ids_shape):
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 3 * VOCAB, ids_shape).astype(np.int64)
    cap = int(np.prod(ids_shape)) + 5
    flax_mod = jax_embedding.SlotEmbedding(
        VOCAB, DIM, external_update=True, delta_capacity=cap,
        param_dtype=jnp.dtype(dtype), combiner="mean")
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    module = SlotEmbedding(VOCAB, DIM, combiner="mean", dtype=getattr(torch, dtype),
                           external_update=True, delta_capacity=cap)
    with torch.no_grad():
        module.embedding.copy_(_to_torch(np.asarray(params["embedding"])))
    return rng, ids, flax_mod, params, module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids_shape", [(8, 6), (4, 5, 3)])
def test_external_lookup_and_captured_gradient_match_jax(dtype, ids_shape):
    rng, ids, flax_mod, params, module = _lookup_pair(dtype, ids_shape)
    mask = None
    if len(ids_shape) == 3:
        mask = (rng.rand(*ids_shape) < 0.7).astype(np.float32)
    weight = rng.randn(*ids_shape[:2], DIM).astype(np.float32)

    def loss(p):
        out = flax_mod.apply({"params": p}, jnp.asarray(ids),
                             None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * weight), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = module(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    # float32 vectors from either table dtype, as take(table) + delta promotes
    assert out.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    if mask is None:
        assert out.detach().numpy().tobytes() == np.asarray(want).tobytes()
    else:  # pooled sums of <= 3 rows, in another order
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    (out * torch.from_numpy(weight)).sum().backward()
    assert module.embedding.grad is None and not module.embedding.requires_grad
    g = module.take_delta_grad()
    assert g.shape == (ids.size, WIDTH) and g.dtype == torch.float32
    assert module.take_delta_grad() is None  # the capture is handed out once
    assert float(g[:, DIM:].abs().max()) == 0.0  # pad lanes
    placed = _place(g.numpy(), (ids.reshape(-1) % VOCAB) % PACK)
    want_g = np.asarray(grads["embedding_delta"])
    np.testing.assert_allclose(placed, want_g[:ids.size], rtol=0, atol=1e-6)
    assert float(np.abs(want_g[ids.size:]).max()) == 0.0
    assert float(np.abs(np.asarray(grads["embedding"]).astype(np.float32)).max()) == 0.0


def test_external_lookup_without_a_recorded_gradient_captures_nothing():
    _, ids, _, _, module = _lookup_pair("bfloat16", (8, 6))
    with torch.no_grad():
        out = module(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and not out.requires_grad
    assert module.take_delta_grad() is None
    assert [k for k, _ in module.named_parameters()] == ["embedding"]  # no delta


def test_external_lookup_capacity_and_hash_errors_are_the_references():
    ids = torch.zeros(4, 6, dtype=torch.int64)
    cases = [
        (dict(external_update=True), "external_update requires an explicit delta_capacity"),
        (dict(external_update=True, delta_capacity=23),
         "batch has 24 lookup positions > delta_capacity 23; "
         "raise hyper_parameters.sparse_update_capacity"),
        (dict(external_update=True, delta_capacity=24, hash_ids=False),
         "external_update requires hash_ids=True"),
    ]
    for kwargs, message in cases:
        with pytest.raises(ValueError, match=message):
            SlotEmbedding(VOCAB, DIM, **kwargs)(ids)
        flax_mod = jax_embedding.SlotEmbedding(VOCAB, DIM, **kwargs)
        with pytest.raises(ValueError, match=message):
            flax_mod.init(jax.random.PRNGKey(0), jnp.zeros((4, 6), jnp.int32))
