"""K1 gather-pool of the PyTorch port against the JAX package's kernel.

The plain version (the CPU path of ``gather_pool``) is held against the
Pallas kernel run in interpret mode and against its jnp oracle.  The CUDA
kernel is held against the plain version in test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops.pallas_embedding import gather_pool as jax_gather_pool
from paddlerec_tpu.ops.pallas_embedding import gather_pool_reference
from paddlerec_tpu_torch.ops.gather_pool import gather_pool

torch.set_num_threads(1)


def _inputs(rng, rows, dim, n, pool, keep=0.7):
    table = rng.randn(rows, dim).astype(np.float32)
    ids = rng.randint(0, rows, (n, pool)).astype(np.int32)
    mask = (rng.rand(n, pool) < keep).astype(np.float32)
    return table, ids, mask


@pytest.mark.parametrize("dim", [16, 128])
@pytest.mark.parametrize("pool", [1, 3, 8])
def test_plain_matches_pallas_interpret(pool, dim):
    table, ids, mask = _inputs(np.random.RandomState(pool * 1000 + dim), 500, dim, 24, pool)
    ref = np.asarray(jax_gather_pool(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(mask), interpret=True))
    out = gather_pool(torch.from_numpy(table), torch.from_numpy(ids),
                      torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (24, dim)
    # f32 sums of up to 8 terms, possibly in another order: 1e-6 relative,
    # and 1e-6 absolute where terms cancel to near 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", [2, 4, 5, 9, 17, 33])
def test_plain_matches_jax_across_block_boundaries(pool):
    """Pool lengths on either side of the card kernel's blocks of 8 ids:
    against the Pallas kernel in interpret mode up to 8, and its oracle
    above."""
    table, ids, mask = _inputs(np.random.RandomState(100 + pool), 500, 16, 24, pool)
    if pool <= 8:
        ref = jax_gather_pool(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask),
                              interpret=True)
    else:
        ref = gather_pool_reference(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask))
    out = gather_pool(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask))
    # f32 sums in another order: 1e-6 up to 8 terms, 1e-5 up to 33
    tol = 1e-6 if pool <= 8 else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_all_zero_mask_gives_zero():
    table = np.ones((100, 128), np.float32)
    ids = np.zeros((8, 4), np.int32)
    mask = np.zeros((8, 4), np.float32)
    ref = np.asarray(jax_gather_pool(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(mask), interpret=True))
    out = gather_pool(torch.from_numpy(table), torch.from_numpy(ids),
                      torch.from_numpy(mask))
    assert float(np.abs(ref).max()) == 0.0
    assert float(out.abs().max()) == 0.0


def test_shapes_the_tpu_kernel_refuses():
    """N = 13 (not a multiple of 8), L = 130 (> 128) and ids out of range,
    which clip to the first and last row as the oracle's mode="clip" does."""
    rng = np.random.RandomState(7)
    table, ids, mask = _inputs(rng, 300, 16, 13, 130)
    ids[0, :5] = [-3, -1, 300, 301, 10**6]
    ref = np.asarray(gather_pool_reference(jnp.asarray(table), jnp.asarray(ids),
                                           jnp.asarray(mask)))
    out = gather_pool(torch.from_numpy(table), torch.from_numpy(ids),
                      torch.from_numpy(mask))
    # 130-term f32 sums in another order than jnp's reduction
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    ones = gather_pool(torch.from_numpy(table), torch.from_numpy(ids), None)
    ref_ones = np.asarray(gather_pool_reference(
        jnp.asarray(table), jnp.asarray(ids), jnp.ones(ids.shape, jnp.float32)))
    np.testing.assert_allclose(ones.numpy(), ref_ones, rtol=1e-5, atol=1e-5)


def test_cpu_path_counts_no_launch():
    before = gather_pool.launches
    table, ids, mask = _inputs(np.random.RandomState(1), 50, 16, 4, 2)
    gather_pool(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask))
    assert gather_pool.launches == before and not gather_pool.launches_by_dim


def test_bf16_plain_sums_in_f32_and_rounds_once():
    rng = np.random.RandomState(3)
    table, ids, mask = _inputs(rng, 200, 16, 16, 8)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    out = gather_pool(t16, torch.from_numpy(ids), torch.from_numpy(mask))
    rows = t16.float()[torch.from_numpy(ids).long()]
    want = (rows * torch.from_numpy(mask)[..., None]).sum(1).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)
