"""``take_rows``, the gathers from activations of ensfm and mhcn, on the
card: K1 in clip mode forward and K1b into the activation's gradient,
against the same calls on the CPU (the plain versions), with ids out of range
on both sides.  Every test needs a CUDA device and skips without one; the
file imports nothing of JAX:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_graph_cuda.py
"""

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.ops.embedding import take_rows
from paddlerec_tpu_torch.ops.gather_pool import gather_pool, gather_pool_bwd

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("rows,dim,n", [(3953, 10, 2048), (64, 50, 64), (257, 50, 80000)])
def test_take_rows_on_the_card_matches_the_cpu(cuda, wrap, rows, dim, n):
    rng = np.random.RandomState(rows + n)
    x = rng.randn(rows, dim).astype(np.float32)
    ids = rng.randint(-rows - 3, rows + 3, (n // 2, 2))
    g = rng.randn(n // 2, 2, dim).astype(np.float32)
    got = {}
    for device in (cuda, torch.device("cpu")):
        tx = torch.from_numpy(x).to(device).requires_grad_()
        before = (gather_pool.launches, gather_pool_bwd.launches)
        out = take_rows(tx * 1.0, torch.from_numpy(ids).to(device), wrap=wrap)
        (out * torch.from_numpy(g).to(device)).sum().backward()
        launched = (gather_pool.launches - before[0], gather_pool_bwd.launches - before[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        got[device.type] = (out.detach().cpu(), tx.grad.cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    # atomics add in another order: the most adds a row sets the rounding
    adds = np.bincount(np.clip(ids.ravel(), 0, rows - 1)).max()
    torch.testing.assert_close(got["cuda"][1], got["cpu"][1], rtol=1e-5, atol=1e-6 * adds)
