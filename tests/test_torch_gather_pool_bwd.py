"""Gradient of the port's lookup against the JAX package's.

``gather_pool_bwd_plain`` (the plain version of kernel K1b) and autograd
through ``gather_pool`` on the CPU are held against ``jax.grad`` of the
Pallas kernel's oracle ``gather_pool_reference``, and autograd through the
port's ``packed_lookup`` against ``jax.grad`` of the JAX ``packed_lookup``.
The CUDA kernel is held against the plain version in
test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops import packed_embedding as jax_packed
from paddlerec_tpu.ops.pallas_embedding import gather_pool_reference
from paddlerec_tpu_torch.convert import _to_numpy, _to_torch
from paddlerec_tpu_torch.ops import packed_embedding as port_packed
from paddlerec_tpu_torch.ops.gather_pool import (
    gather_pool, gather_pool_bwd, gather_pool_bwd_plain,
)

torch.set_num_threads(1)


def _case(rng, rows, dim, n, pool, mask_kind):
    table = rng.randn(rows, dim).astype(np.float32)
    # a narrow id range makes duplicates certain, within a row and across rows
    ids = rng.randint(0, max(rows // 8, 2), (n, pool)).astype(np.int32)
    g = rng.randn(n, dim).astype(np.float32)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "zeros":
        mask = np.zeros((n, pool), np.float32)
    else:
        mask = (rng.rand(n, pool) < 0.7).astype(np.float32) * rng.rand(n, pool).astype(np.float32)
    return table, ids, g, mask


def _jax_grad(table, ids, g, mask):
    m = jnp.ones(ids.shape, jnp.float32) if mask is None else jnp.asarray(mask)

    def f(t):
        return jnp.sum(gather_pool_reference(t, jnp.asarray(ids), m) * jnp.asarray(g))

    return np.asarray(jax.grad(f)(jnp.asarray(table)))


@pytest.mark.parametrize("mask_kind", ["none", "weights", "zeros"])
@pytest.mark.parametrize("pool", [1, 3, 8])
def test_bwd_plain_and_autograd_match_jax_grad(pool, mask_kind):
    table, ids, g, mask = _case(np.random.RandomState(pool), 64, 16, 24, pool, mask_kind)
    ref = _jax_grad(table, ids, g, mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    plain = gather_pool_bwd_plain(torch.from_numpy(g), torch.from_numpy(ids), tmask, 64)
    assert plain.dtype == torch.float32 and plain.shape == (64, 16)
    # f32 sums of up to 24*8 terms per row, in another order
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(table).requires_grad_()
    out = gather_pool(t, torch.from_numpy(ids), tmask)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6, atol=1e-6)
    if mask_kind == "zeros":
        assert float(plain.abs().max()) == 0.0 and float(np.abs(ref).max()) == 0.0
    # the CPU path of the K1b wrapper is the plain version, and counts no launch
    before = gather_pool_bwd.launches
    again = gather_pool_bwd(torch.from_numpy(g), torch.from_numpy(ids), tmask, 64)
    assert torch.equal(again, plain) and gather_pool_bwd.launches == before


def test_out_of_range_ids_are_dropped_in_the_backward():
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    ids = torch.tensor([[0], [-1], [9], [10], [11], [10**6]], dtype=torch.int32)
    want = torch.zeros(10, 8)
    want[0], want[9] = g[0], g[2]
    assert torch.equal(gather_pool_bwd_plain(g, ids, None, 10), want)
    t = torch.zeros(10, 8, requires_grad=True)
    gather_pool(t, ids).backward(g)
    assert torch.equal(t.grad, want)


@pytest.mark.parametrize("vocab,dim", [(1001, 10), (500, 9), (64, 64), (30, 128)])
def test_packed_lookup_grad_matches_jax(vocab, dim):
    """Through the view, ids in [0, R·pack + 3]: ids >= R·pack are dropped by
    both backward passes (the forward values differ there, as documented);
    pad lanes get exactly zero."""
    rng = np.random.RandomState(dim)
    shape = jax_packed.packed_shape(vocab, dim)
    w = jax_packed.sub_width(dim)
    pack = 128 // w
    table = rng.randn(*shape).astype(np.float32)
    ids = rng.randint(0, shape[0] * pack + 4, (5, 26)).astype(np.int64)
    ids[0, :4] = shape[0] * pack + np.arange(4)
    g = rng.randn(5, 26, dim).astype(np.float32)

    def f(t):
        return jnp.sum(jax_packed.packed_lookup(t, jnp.asarray(ids), dim) * jnp.asarray(g))

    ref = np.asarray(jax.grad(f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = port_packed.packed_lookup(t, torch.from_numpy(ids), dim)
    out.backward(torch.from_numpy(g))
    assert t.grad.shape == shape
    # f32 sums of the few gradient rows that share an id
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-6)
    lanes = t.grad.view(-1, w)
    assert float(lanes[:, dim:].abs().max() if dim < w else 0.0) == 0.0
    assert float(np.abs(ref.reshape(-1, w)[:, dim:]).max() if dim < w else 0.0) == 0.0


def test_packed_lookup_negative_ids():
    """A negative id: the port reads the view's row 0 and drops the gradient;
    the JAX function reads physical row 0 (lane window ``id % pack``) and
    adds the gradient, wrapped, at the end of the table."""
    vocab, dim = 64, 9
    shape = jax_packed.packed_shape(vocab, dim)
    table = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ids = np.array([[-1, 3]], np.int64)
    t = torch.from_numpy(table).requires_grad_()
    out = port_packed.packed_lookup(t, torch.from_numpy(ids), dim)
    assert torch.equal(out[0, 0], t.detach().view(-1, 16)[0, :dim])
    out.sum().backward()
    want = torch.zeros(shape).view(-1, 16)
    want[3, :dim] = 1.0
    assert torch.equal(t.grad.view(-1, 16), want)
    ref = np.asarray(jax.grad(
        lambda x: jnp.sum(jax_packed.packed_lookup(x, jnp.asarray(ids), dim))
    )(jnp.asarray(table))).reshape(-1, 16)
    assert ref[-1, :dim].sum() == dim and ref[3, :dim].sum() == dim


def test_bf16_table_grad():
    """bf16 table: the plain K1b rounds each contribution to bf16, sums in
    f32 and rounds once; JAX's scatter-add (and PyTorch's ``index_select``
    backward, which the CPU path uses) add in bf16, rounding after every
    add.  With at most 4 gradient rows per id the two differ by a few bf16
    ulps of the running sum: rtol 2e-2, atol 2e-2 on sums of size ~2."""
    rng = np.random.RandomState(5)
    vocab, dim = 200, 9
    shape = jax_packed.packed_shape(vocab, dim)
    table = _to_torch(np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16)))
    ids = rng.randint(0, vocab, (4, 26)).astype(np.int64)
    g = _to_torch(np.asarray(jnp.asarray(rng.randn(4, 26, dim), jnp.bfloat16)))

    def f(t):
        out = jax_packed.packed_lookup(t, jnp.asarray(ids), dim)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(_to_numpy(g)).astype(jnp.float32))

    ref = jax.grad(f)(jnp.asarray(_to_numpy(table)))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    t = table.clone().requires_grad_()
    port_packed.packed_lookup(t, torch.from_numpy(ids), dim).backward(g)
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(t.grad.float().numpy(), ref, rtol=2e-2, atol=2e-2)
    flat = torch.from_numpy(ids.reshape(-1, 1).astype(np.int32))
    g16 = torch.nn.functional.pad(g.reshape(-1, dim), (0, 16 - dim))
    plain = gather_pool_bwd_plain(g16, flat, None, shape[0] * 8)
    assert plain.dtype == torch.bfloat16
    np.testing.assert_allclose(plain.float().numpy().reshape(shape), ref,
                               rtol=2e-2, atol=2e-2)
    # ids that occur once: no sum, so all three agree exactly
    once = np.unique(ids, return_counts=True)
    rows = once[0][once[1] == 1]
    assert len(rows) > 10
    np.testing.assert_array_equal(
        plain.float().numpy()[rows], ref.reshape(-1, 16)[rows])
    np.testing.assert_array_equal(
        t.grad.view(-1, 16).float().numpy()[rows], ref.reshape(-1, 16)[rows])


def test_bf16_contributions_round_before_the_sum():
    """f32 gradient into a bf16 table (the pooled float32 output of a bf16
    table): each g·mask is rounded to bf16, the sum runs in f32."""
    g = torch.tensor([[1.00390625, 3.0]], dtype=torch.float32)  # 1 + 2^-8
    ids = torch.tensor([[2, 2, 2]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 0.5]])
    out = gather_pool_bwd_plain(g, ids, mask, 4, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # 1.00390625 rounds to 1.0 (ties to even) and half of it to 0.5
    assert out[2].tolist() == [2.5, 7.5] and float(out[:2].abs().max()) == 0.0


# The patterns the kernel's paths take on the card, at a small size: every id
# equal; position ids 0..29 repeated; a 102-row word table at D = 30 with ~230
# adds a row; 351-lane rows at every residue of r·351 mod 4 (L = 3, weights);
# fill mode, where wrapped negative ids land on the rows of positive ones and
# ids still outside the table are dropped.  (rows, D, N, L, ids, mode)
PATTERNS = {
    "every id equal": (2, 64, 1600, 1, "zeros", "clip"),
    "periodic ids 0..29": (256, 24, 960, 1, "period 30", "clip"),
    "102 rows, D=30, ~230 adds a row": (102, 30, 23460, 1, "uniform", "clip"),
    "351 lanes at every residue mod 4": (64, 351, 16, 3, "residues", "clip"),
    "fill mode, wrapped ids on the same rows": (50, 8, 400, 1, "wrapped", "fill"),
}


def _pattern(name):
    rows, dim, n, pool, kind, mode = PATTERNS[name]
    rng = np.random.RandomState(sorted(PATTERNS).index(name))
    if kind == "zeros":
        ids = np.zeros((n, pool), np.int32)
    elif kind.startswith("period"):
        ids = (np.arange(n * pool) % int(kind.split()[1])).reshape(n, pool).astype(np.int32)
    elif kind == "residues":
        ids = (rng.randint(0, rows // 4, (n, pool)) * 4
               + np.arange(n * pool).reshape(n, pool) % 4).astype(np.int32)
    elif kind == "wrapped":
        # -rows..rows-1, so row r takes r and r - rows alike; a few beyond
        ids = rng.randint(-rows, rows, (n, pool)).astype(np.int32)
        ids[:4, 0] = [-rows - 1, rows, 3 * rows, -3 * rows]
    else:
        ids = rng.randint(0, rows, (n, pool)).astype(np.int32)
    g = rng.randn(n, dim).astype(np.float32)
    mask = None if pool == 1 else rng.rand(n, pool).astype(np.float32)
    return rows, ids, g, mask, mode


def _jax_scatter(rows, ids, g, mask, mode):
    """JAX's scatter-add of g·mask at the ids (wrapped once in fill mode),
    mode="drop", in float32."""
    flat = ids.reshape(-1).astype(np.int64)
    if mode == "fill":
        flat = np.where(flat < 0, flat + rows, flat)
    # .at[] would wrap a negative index once more: past the end, "drop" drops it
    flat = np.where((flat >= 0) & (flat < rows), flat, rows)
    contrib = np.repeat(g, ids.shape[1], axis=0)
    if mask is not None:
        contrib = contrib * mask.reshape(-1, 1)
    out = jnp.zeros((rows, g.shape[1]), jnp.float32).at[jnp.asarray(flat)].add(
        jnp.asarray(contrib), mode="drop")
    return np.asarray(out)


def _jax_grad_of_lookup(rows, ids, g, mask, mode):
    """``jax.grad`` of the lookup: ``gather_pool_reference`` (clip mode: every
    id of these patterns is in range), or ``jnp.take``'s default fill mode,
    which flax's ``nn.Embed`` reads with."""
    table = jnp.zeros((rows, g.shape[1]), jnp.float32)
    m = jnp.ones(ids.shape, jnp.float32) if mask is None else jnp.asarray(mask)
    if mode == "fill":
        def f(t):
            out = (jnp.take(t, jnp.asarray(ids), axis=0) * m[..., None]).sum(axis=1)
            return jnp.sum(jnp.nan_to_num(out) * jnp.asarray(g))
    else:
        def f(t):
            return jnp.sum(gather_pool_reference(t, jnp.asarray(ids), m) * jnp.asarray(g))
    return np.asarray(jax.grad(f)(table))


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_bwd_patterns_match_jax(name):
    """K1b's plain version and autograd through ``gather_pool`` against JAX's
    scatter-add and ``jax.grad`` of the lookup.  Tolerance: rtol 1e-5, atol
    1e-6 times the most adds a row takes (f32 sums of up to 1,600 terms of
    size ~1 in another order; the error grows with the terms)."""
    rows, ids, g, mask, mode = _pattern(name)
    flat = ids.reshape(-1).astype(np.int64)
    if mode == "fill":
        flat = np.where(flat < 0, flat + rows, flat)
    adds = int(np.bincount(flat[(flat >= 0) & (flat < rows)]).max())
    tol = dict(rtol=1e-5, atol=1e-6 * adds)
    scatter = _jax_scatter(rows, ids, g, mask, mode)
    grad = _jax_grad_of_lookup(rows, ids, g, mask, mode)
    np.testing.assert_allclose(grad, scatter, **tol)
    tmask = None if mask is None else torch.from_numpy(mask)
    plain = gather_pool_bwd_plain(torch.from_numpy(g), torch.from_numpy(ids), tmask, rows,
                                  mode=mode)
    assert plain.dtype == torch.float32 and plain.shape == (rows, g.shape[1])
    np.testing.assert_allclose(plain.numpy(), scatter, **tol)
    np.testing.assert_allclose(plain.numpy(), grad, **tol)
    t = torch.zeros(rows, g.shape[1], requires_grad=True)
    gather_pool(t, torch.from_numpy(ids), tmask, mode=mode).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), grad, **tol)


def _bf16_sum_bounds(ids, g, rows):
    """Per element of a (rows, D) dtable, how far a bfloat16 scatter that
    rounds after every add (JAX's) and a float32 sum rounded once (the
    plain version's, K1b's) can each lie from the exact sum of the same
    bfloat16 contributions c, added in the order of the ids.  With P_j the
    exact partial sums and u = 2^-8 (bfloat16's unit roundoff, widened by
    2^-15 for a sum rounded through float32), the first add is exact and
    JAX's error obeys e_j <= (e_{j-1} + u|P_j|) / (1 - u); the plain
    version's is at most u|P_k| + k·2^-23·Σ|c|.
    Returns (exact sums, JAX's bound, the plain version's bound)."""
    u = 2.0 ** -8 * (1 + 2.0 ** -15)
    c = g.astype(np.float64)
    exact, jax_bound, plain_bound = (np.zeros((rows, g.shape[1])) for _ in range(3))
    for r in range(rows):
        part = np.cumsum(c[ids == r], axis=0)
        e = np.zeros(g.shape[1])
        for p in part[1:]:
            e = (e + u * np.abs(p)) / (1 - u)
        exact[r], jax_bound[r] = part[-1], e
        plain_bound[r] = (u * np.abs(part[-1])
                          + len(part) * 2.0 ** -23 * np.abs(c[ids == r]).sum(0))
    return exact, jax_bound, plain_bound


def test_bwd_bf16_dtable_with_many_adds_a_row():
    """A bfloat16 packed table whose 160 logical rows each take 100+ adds,
    the plain version (which K1b equals on the card) held against
    ``jax.grad`` of the JAX ``packed_lookup``, element by element within
    the bound that bfloat16 rounding sets on each side (``_bf16_sum_bounds``).
    JAX's scatter-add runs in bfloat16 and rounds after every add; the
    plain version rounds each contribution (here already bfloat16), sums in
    float32 and rounds once, so it also stays within u|P_k| + the float32
    term of the exact sum.  ``ROADMAP.md`` logs the gap as a fault."""
    rng = np.random.RandomState(7)
    vocab, dim = 160, 16
    shape = jax_packed.packed_shape(vocab, dim)
    ids = rng.randint(0, vocab, 24000).astype(np.int64)
    assert np.bincount(ids, minlength=vocab).min() >= 100
    g = np.array(jnp.asarray(rng.randn(ids.size, dim), jnp.bfloat16).astype(jnp.float32))
    table = jnp.zeros(shape, jnp.bfloat16)

    def f(t):
        out = jax_packed.packed_lookup(t, jnp.asarray(ids), dim)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    ref = jax.grad(f)(table)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32)).reshape(vocab, dim)
    plain = gather_pool_bwd_plain(torch.from_numpy(g), torch.from_numpy(ids[:, None].astype(
        np.int32)), None, vocab, torch.bfloat16)
    assert plain.dtype == torch.bfloat16
    plain = plain.float().numpy()
    exact, jax_bound, plain_bound = _bf16_sum_bounds(ids, g, vocab)
    assert (np.abs(plain - exact) <= plain_bound).all()
    assert (np.abs(ref - exact) <= jax_bound).all()
    # measured: JAX 1.63 from the exact sums (up to 50.6), the plain version 0.12;
    # they differ by up to 1.75 at 2,207 of 2,560 elements, 13% of the bound
    gap = np.abs(plain - ref)
    assert (gap <= jax_bound + plain_bound).all()
