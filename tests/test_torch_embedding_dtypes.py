"""``SlotEmbedding`` with a bfloat16 table and multi-hot ids: the port gives
the JAX module's dtype and value for ``sum`` and ``mean``, with and without
a mask.  In the JAX module bf16 rows times a float32 mask promote to float32
before the pooled sum; without a mask the sum, and ``mean``'s denominator,
stay bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.ops import embedding as jax_embedding
from paddlerec_tpu_torch.convert import _to_torch
from paddlerec_tpu_torch.ops.embedding import SlotEmbedding

torch.set_num_threads(1)

VOCAB, DIM = 1000, 9


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_bf16_multi_hot_matches_flax(combiner, masked):
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 10 * VOCAB, (4, 3, 5)).astype(np.int64)
    mask = (rng.rand(4, 3, 5) < 0.6).astype(np.float32) if masked else None
    if masked:
        mask[0, 0] = 0.0  # an empty bag
    flax_mod = jax_embedding.SlotEmbedding(VOCAB, DIM, combiner=combiner,
                                           param_dtype=jnp.bfloat16)
    args = (jnp.asarray(ids),) + ((jnp.asarray(mask),) if masked else ())
    params = flax_mod.init(jax.random.PRNGKey(0), *args)
    assert params["params"]["embedding"].dtype == jnp.bfloat16
    ref = flax_mod.apply(params, *args)
    port = SlotEmbedding(VOCAB, DIM, combiner=combiner, dtype=torch.bfloat16)
    with torch.no_grad():
        port.embedding.copy_(_to_torch(np.asarray(params["params"]["embedding"])))
        out = port(torch.from_numpy(ids), *((torch.from_numpy(mask),) if masked else ()))
    want_dtype = torch.float32 if masked else torch.bfloat16
    assert ref.dtype == (jnp.float32 if masked else jnp.bfloat16)
    assert out.dtype == want_dtype and out.shape == (4, 3, DIM)
    ref = np.asarray(ref.astype(jnp.float32))
    if masked:
        # both sum exact bf16 rows in f32; only the order of <= 5 terms differs
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    else:
        # both sum <= 5 bf16 rows in f32 and round once to bf16 (mean divides
        # in bf16 after that): at most one bf16 ulp where the f32 sums differ
        # in their last bits
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_bf16_gradient_flows_through_the_f32_output():
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, VOCAB, (2, 3, 4)))
    mask = torch.from_numpy((rng.rand(2, 3, 4) < 0.7).astype(np.float32))
    port = SlotEmbedding(VOCAB, DIM, dtype=torch.bfloat16)
    out = port(ids, mask)
    out.sum().backward()
    grad = port.embedding.grad
    assert out.dtype == torch.float32 and grad.dtype == torch.bfloat16
    lanes = grad.view(-1, 16).float()
    assert float(lanes[:, DIM:].abs().max()) == 0.0
    counts = torch.zeros(lanes.shape[0])
    counts.index_add_(0, ids.reshape(-1), mask.reshape(-1))
    assert torch.equal(lanes[:, 0], counts)
