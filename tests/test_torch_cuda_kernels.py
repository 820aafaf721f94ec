"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.ops.embedding import SlotEmbedding
from paddlerec_tpu_torch.ops.gather_pool import (
    gather_pool, gather_pool_bwd, gather_pool_bwd_plain, gather_pool_plain,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,pool", [(16, 1), (128, 8), (10, 3), (16, 200),
                                      # lr's 8-lane view; ffm's 351-lane unpacked rows
                                      (8, 1), (8, 3), (351, 1), (351, 3)])
def test_gather_pool_kernel_matches_plain(cuda, dtype, dim, pool):
    rng = np.random.RandomState(dim + pool)
    table = torch.from_numpy(rng.randn(1000, dim).astype(np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.randint(-2, 1002, (13313, pool)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.rand(13313, pool) < 0.7).astype(np.float32)).to(cuda)
    for m in (None, mask):
        before, wide = gather_pool.launches, gather_pool.launches_by_dim[dim]
        out = gather_pool(table, ids, m)
        torch.cuda.synchronize()
        assert gather_pool.launches == before + 1
        assert gather_pool.launches_by_dim[dim] == wide + 1
        ref = gather_pool_plain(table, ids, m)
        assert out.dtype == dtype and out.shape == (13313, dim)
        if pool == 1:
            assert torch.equal(out, ref)
        elif dtype == torch.float32:  # f32 sums in another order
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
        else:  # both sum in f32 and round once to bf16
            torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-5)


@pytest.mark.cuda
def test_gather_pool_refuses_bad_inputs(cuda):
    table = torch.zeros(10, 16, device=cuda)
    ids = torch.zeros(4, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather_pool(table, ids.long())
    with pytest.raises(ValueError):
        gather_pool(table, ids.cpu())
    with pytest.raises(TypeError):
        gather_pool(table.half(), ids)
    with pytest.raises(ValueError):
        gather_pool(table, ids, torch.ones(4, 2, device=cuda))
    with pytest.raises(TypeError):
        gather_pool(table, ids, out_dtype=torch.bfloat16)
    mask = torch.ones(4, 1, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient for the mask"):
        gather_pool(table.requires_grad_(), ids, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_slot_embedding_cuda_matches_cpu(cuda, combiner):
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 10**6, (8, 5, 4)))
    mask = torch.from_numpy((rng.rand(8, 5, 4) < 0.6).astype(np.float32))
    emb = SlotEmbedding(3000, 9, combiner=combiner,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = emb(ids, mask)
        got = emb.to(cuda)(ids.to(cuda), mask.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_gather_pool_f32_output_from_bf16_table(cuda):
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.randn(1000, 16).astype(np.float32)).to(cuda, torch.bfloat16)
    ids = torch.from_numpy(rng.randint(0, 1000, (4099, 5)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.rand(4099, 5) < 0.7).astype(np.float32)).to(cuda)
    out = gather_pool(table, ids, mask, torch.float32)
    ref = gather_pool_plain(table, ids, mask, torch.float32)
    assert out.dtype == torch.float32
    # exact bf16 rows summed in f32, <= 5 terms in another order
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


# the boundaries of K1's layout: blocks of 8 pool positions, 4 rows a lane
# at L = 1, groups of 1 to 32 lanes a row (D = 1 ... 400), both load paths
K1_POOLS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 33, 130)
K1_DIMS = (1, 4, 8, 30, 64, 351, 400)


def _k1_ids(rng, rows, n, pool):
    """Ids in range but a fifth: negative (-1, beyond -rows) and past the
    end, so that every mode's clip, wrap, NaN and zero rows are read."""
    ids = rng.randint(0, rows, (n, pool))
    far = rng.choice([-1, -rows - 3, rows, 3 * rows], (n, pool))
    return np.where(rng.rand(n, pool) < 0.2, far, ids).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["clip", "fill", "drop", "fill_drop"])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_gather_pool_kernel_boundaries(cuda, mode, dtype, out_dtype):
    rng = np.random.RandomState(11)
    rows, n = 300, 133  # n: no multiple of any group's rows a warp step
    for dim in K1_DIMS:
        flat = torch.from_numpy(rng.randn(rows * dim + 1).astype(np.float32)).to(cuda, dtype)
        # a table 16-byte aligned and one a single element off (scalar path)
        for table in (flat[:-1].view(rows, dim), flat[1:].view(rows, dim)):
            for pool in K1_POOLS:
                ids = torch.from_numpy(_k1_ids(rng, rows, n, pool)).to(cuda)
                mask = torch.from_numpy((rng.rand(n, pool) < 0.7).astype(np.float32)).to(cuda)
                for m in (None, mask):
                    out = gather_pool(table, ids, m, out_dtype, mode=mode)
                    ref = gather_pool_plain(table, ids, m, out_dtype, mode=mode)
                    where = f"D={dim} L={pool} mask={m is not None} at {table.data_ptr() % 16}"
                    assert out.dtype == out_dtype and out.shape == (n, dim), where
                    assert torch.equal(out.isnan(), ref.isnan()), where
                    out, ref = out.float().nan_to_num(), ref.float().nan_to_num()
                    if pool == 1:  # a gather: bitwise
                        assert torch.equal(out, ref), where
                    elif out_dtype == torch.bfloat16:  # one rounding of an f32 sum
                        torch.testing.assert_close(out, ref, rtol=1e-2, atol=1e-5, msg=where)
                    else:  # f32 sums of exact rows in another order
                        atol = 1e-6 if pool <= 8 else 1e-5 if pool <= 33 else 1e-4
                        torch.testing.assert_close(out, ref, rtol=1e-5, atol=atol, msg=where)


@pytest.mark.cuda
def test_gather_pool_kernel_past_2_31_elements(cuda):
    """N·D = 6.2 M x 351 = 2.18e9 > 2^31 elements (8.7 GB of output): the
    kernel's row offsets run past 32 bits.  Compared in chunks."""
    n, dim, rows = 6_200_000, 351, 1000
    if torch.cuda.get_device_properties(cuda).total_memory < 24 << 30:
        pytest.skip("needs 24 GB of device memory")
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(rows, dim, device=cuda, generator=g)
    ids = torch.randint(-2, rows + 2, (n, 1), device=cuda, generator=g, dtype=torch.int32)
    out = gather_pool(table, ids)
    assert out.shape == (n, dim)
    for a in range(0, n, 1 << 20):
        assert torch.equal(out[a:a + (1 << 20)], gather_pool_plain(table, ids[a:a + (1 << 20)]))


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype,dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("dim,pool", [(16, 1), (128, 8), (10, 3), (16, 200),
                                      (8, 1), (8, 3), (351, 1), (351, 3)])
def test_gather_pool_bwd_kernel_matches_plain(cuda, g_dtype, dtype, dim, pool):
    rng = np.random.RandomState(dim + pool)
    rows, n = 1000, 4099
    g = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).to(cuda, g_dtype)
    ids = torch.from_numpy(rng.randint(-2, rows + 2, (n, pool)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.rand(n, pool) < 0.7).astype(np.float32)).to(cuda)
    for m in (None, mask):
        before, wide = gather_pool_bwd.launches, gather_pool_bwd.launches_by_dim[dim]
        out = gather_pool_bwd(g, ids, m, rows, dtype)
        torch.cuda.synchronize()
        assert gather_pool_bwd.launches == before + 1
        assert gather_pool_bwd.launches_by_dim[dim] == wide + 1
        ref = gather_pool_bwd_plain(g, ids, m, rows, dtype)
        assert out.dtype == dtype and out.shape == (rows, dim)
        # every row takes n*pool/rows adds (4 to 800) of size ~1, by atomics
        # in an order of their own; a bf16 result rounds the f32 sum once
        rtol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=1e-5 * max(1.0, (n * pool / rows) ** 0.5) * 4)


@pytest.mark.cuda
def test_gather_pool_bwd_refuses_bf16_g_into_f32_table(cuda):
    g = torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros(8, 1, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="bfloat16 g into a float32"):
        gather_pool_bwd(g, ids, None, 10, torch.float32)


@pytest.mark.cuda
def test_gather_pool_bwd_unique_ids_are_bitwise(cuda):
    rng = np.random.RandomState(2)
    rows = 20000
    ids = torch.from_numpy(rng.permutation(rows)[:8192].astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.randn(8192, 16).astype(np.float32)).to(cuda)
    out = gather_pool_bwd(g, ids[:, None], None, rows)
    assert torch.equal(out, gather_pool_bwd_plain(g, ids[:, None], None, rows))
    zero = gather_pool_bwd(g, ids[:, None], torch.zeros(8192, 1, device=cuda), rows)
    assert float(zero.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels_matches_plain(cuda, dtype):
    """backward() through K1 launches K1b once and gives the gradient
    autograd derives through the plain version on the same device."""
    rng = np.random.RandomState(4)
    table = torch.from_numpy(rng.randn(500, 16).astype(np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.randint(-1, 501, (300, 4)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.rand(300, 4).astype(np.float32)).to(cuda)
    weight = torch.from_numpy(rng.randn(300, 16).astype(np.float32)).to(cuda)
    grads = []
    for fn in (gather_pool, gather_pool_plain):
        t = table.clone().requires_grad_()
        fwd, bwd = gather_pool.launches, gather_pool_bwd.launches
        (fn(t, ids, mask, torch.float32) * weight).sum().backward()
        launched = (gather_pool.launches - fwd, gather_pool_bwd.launches - bwd)
        assert launched == ((1, 1) if fn is gather_pool else (0, 0))
        assert t.grad.dtype == dtype
        grads.append(t.grad.float())
    # f32: <= 2.4 adds a row on average, in another order.  bf16: the plain
    # path's index_select backward adds in bf16, K1b in f32 rounded once
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(grads[0], grads[1], **tol)


@pytest.mark.cuda
def test_slot_embedding_trains_on_cuda_like_cpu(cuda):
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 10**6, (8, 5)))
    grads = []
    for device in (torch.device("cpu"), cuda):
        emb = SlotEmbedding(3000, 9, generator=torch.Generator().manual_seed(0)).to(device)
        (emb(ids.to(device)) ** 2).sum().backward()
        grads.append(emb.embedding.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpacked_slot_embedding_cuda_matches_cpu(cuda, dtype):
    """ffm's table: 351-lane rows that are no multiple of 16 bytes, read and
    trained through K1 and K1b on the table itself."""
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 10**6, (16, 26)))
    outs, grads = [], []
    for device in (torch.device("cpu"), cuda):
        emb = SlotEmbedding(2000, 351, packed=False, dtype=dtype,
                            generator=torch.Generator().manual_seed(0)).to(device)
        fwd, bwd = gather_pool.launches, gather_pool_bwd.launches
        out = emb(ids.to(device))
        (out.float() ** 2).sum().backward()
        assert (gather_pool.launches - fwd, gather_pool_bwd.launches - bwd) == (
            (1, 1) if device.type == "cuda" else (0, 0))
        outs.append(out.detach().cpu())
        grads.append(emb.embedding.grad.float().cpu())
    assert torch.equal(outs[0], outs[1])
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 else dict(rtol=2e-2, atol=1e-4)
    torch.testing.assert_close(grads[1], grads[0], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,pool", [(1, 1), (4, 1), (32, 1), (64, 1), (64, 3), (10, 3)])
def test_fill_mode_matches_plain(cuda, dtype, dim, pool):
    """K1 and K1b in fill mode (what ``Embed`` reads with): negative ids
    wrapped once, the rest outside [0, R) NaN rows in the forward and dropped
    in the backward, against the plain versions on the card."""
    rng = np.random.RandomState(dim * 10 + pool)
    rows, n = 1000, 4099
    table = torch.from_numpy(rng.randn(rows, dim).astype(np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.randint(-rows - 3, rows + 3, (n, pool)).astype(np.int32)).to(cuda)
    mask = torch.from_numpy((rng.rand(n, pool) < 0.7).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).to(cuda, dtype)
    for m in (None, mask):
        out = gather_pool(table, ids, m, mode="fill")
        ref = gather_pool_plain(table, ids, m, mode="fill")
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        if pool == 1:
            assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))
        else:
            torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-5,
                                       equal_nan=True)
        got = gather_pool_bwd(g, ids, m, rows, dtype, mode="fill")
        want = gather_pool_bwd_plain(g, ids, m, rows, dtype, mode="fill")
        rtol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-4)


@pytest.mark.cuda
def test_embed_trains_on_cuda_like_cpu(cuda):
    """``Embed`` on the card: one K1 launch for several id tensors, one K1b
    in the backward, out-of-range ids as on the CPU."""
    from paddlerec_tpu_torch.ops.embedding import Embed

    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randint(-1, 3001, (8, 20)).astype(np.int64))
    b = torch.from_numpy(rng.randint(0, 3000, (8,)).astype(np.int64))
    outs, grads = [], []
    for device in (torch.device("cpu"), cuda):
        emb = Embed(3000, 64, generator=torch.Generator().manual_seed(0)).to(device)
        fwd, bwd = gather_pool.launches, gather_pool_bwd.launches
        va, vb = emb(a.to(device), b.to(device))
        (torch.nan_to_num(va) ** 2).sum().add((vb ** 3).sum()).backward()
        assert (gather_pool.launches - fwd, gather_pool_bwd.launches - bwd) == (
            (1, 1) if device.type == "cuda" else (0, 0))
        outs.append(torch.cat([va.reshape(-1), vb.reshape(-1)]).detach().cpu())
        grads.append(emb.embedding.grad.cpu())
    assert torch.equal(torch.isnan(outs[0]), torch.isnan(outs[1]))
    assert torch.equal(torch.nan_to_num(outs[0]), torch.nan_to_num(outs[1]))
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rank.din", "rank.dien", "rank.bst", "rank.dsin",
                                   "rank.dmr", "rank.dpin"])
def test_sequence_model_on_cuda_matches_cpu(cuda, model):
    """A small config of each sequence model, its forward and one train step
    on the card against the CPU from the same parameters: atol 1e-5."""
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer

    small = {
        "rank.din": {"max_seq_len": 8},
        "rank.dien": {"max_seq_len": 8, "gru_hidden": 16},
        "rank.bst": {"max_seq_len": 8},
        "rank.dsin": {"user_size": 1000, "adgroup_size": 1000, "campaign_size": 1000,
                      "customer_size": 1000, "brand_size": 1000},
        "rank.dmr": {"user_size": 1000, "adgroup_id_size": 1000, "campaign_id_size": 1000,
                     "customer_size": 1000, "brand_size": 1000, "history_length": 8},
        "rank.dpin": {"num_blocks": 2, "max_item": 1000, "max_context": 1000},
    }[model]
    cfg = Config({"runner.model": model, "runner.seed": 0,
                  **{f"hyper_parameters.{k}": v for k, v in small.items()}})
    trainers = {d: Trainer(cfg, device=d) for d in ("cpu", "cuda")}
    trainers["cpu"].init_state(seed=0)
    trainers["cuda"].init_state(seed=0)
    trainers["cuda"].state.module.load_state_dict(trainers["cpu"].state.module.state_dict())
    batch = trainers["cpu"].model_def.example_batch(32)
    preds, losses = {}, {}
    for name, tr in trainers.items():
        b = to_tensors(batch, tr.device)
        with torch.no_grad():
            preds[name] = tr.model_def.infer_forward(tr.state.module, b)["predictions"].cpu()
        ms = tr._init_metric_state()
        _, loss = tr.train_step(b, ms)
        _, loss = tr.train_step(b, ms)
        losses[name] = float(loss)
    torch.testing.assert_close(preds["cuda"], preds["cpu"], rtol=0, atol=1e-5)
    assert abs(losses["cuda"] - losses["cpu"]) < 1e-5


def _meta_grad(fn, table, spt_ids, spt_mask, qry_ids, qry_mask, w_s, w_q, mode):
    """The gradient of a query read-out at ``table - ∇(support read-out)``,
    through ``fn``: the second order of the lookup, as metaheac takes it."""
    t = table.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(w_s * torch.tanh(fn(t, spt_ids, spt_mask, mode=mode))),
                               t, create_graph=True)
    torch.sum(w_q * torch.sin(fn(t - g, qry_ids, qry_mask, mode=mode))).backward()
    return t.grad


@pytest.mark.cuda
@pytest.mark.parametrize("mode,pool", [("clip", 3), ("fill", 1)])
def test_second_order_through_the_kernels_matches_plain(cuda, mode, pool):
    """autograd.grad of autograd.grad through K1 and K1b (three launches of
    each: two lookups, the inner K1b, the query's K1b, K1 as K1b's backward,
    K1b back through the support lookup) against the plain version, ids out
    of range both ways among the support's."""
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.randn(700, 8).astype(np.float32)).to(cuda)
    spt_ids = torch.from_numpy(rng.randint(-900, 900, (400, pool)).astype(np.int32)).to(cuda)
    qry_ids = torch.from_numpy(rng.randint(0, 700, (300, pool)).astype(np.int32)).to(cuda)
    masks = [None if pool == 1 else torch.from_numpy(rng.rand(n, pool).astype(np.float32)).to(
        cuda) for n in (400, 300)]
    w_s, w_q = (torch.from_numpy(rng.randn(n, 8).astype(np.float32)).to(cuda)
                for n in (400, 300))
    fwd, bwd = gather_pool.launches, gather_pool_bwd.launches
    got = _meta_grad(gather_pool, table, spt_ids, masks[0], qry_ids, masks[1], w_s, w_q, mode)
    assert (gather_pool.launches - fwd, gather_pool_bwd.launches - bwd) == (3, 3)
    want = _meta_grad(gather_pool_plain, table, spt_ids, masks[0], qry_ids, masks[1], w_s, w_q,
                      mode)
    assert torch.isfinite(got).all()
    # atomics add in another order, and the second order sums those sums again
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# K1b's paths, each reached by one pattern (rows, D, N, L, ids, mode): the
# sorted one (a table of at most 4,096 rows taking 256 adds a row, or D·N·L
# of 2^20), the scatter's three layouts (16-byte, a peeled 351-lane row, one
# element a thread), the fill's two grids, and a dtable in bfloat16 on each
K1B_PATHS = {
    "sorted, every id equal": (2, 64, 1600, 1, "zeros", "clip"),
    "sorted, periodic ids 0..29, D=400": (256, 400, 4800, 1, "period 30", "clip"),
    "sorted, 102 rows, D=30, L=3": (102, 30, 12000, 3, "uniform", "clip"),
    "sorted, unique ids": (4096, 256, 4096, 1, "unique", "clip"),
    "one element a thread, 102 rows, D=30, ~230 adds a row": (102, 30, 23460, 1, "uniform",
                                                              "clip"),
    "peeled, 351 lanes at every residue mod 4": (5000, 351, 4096, 1, "residues", "clip"),
    "16-byte, fill mode, wrapped ids": (50000, 8, 4096, 1, "wrapped", "fill"),
    "one element a thread, D=1, fill mode": (63001, 1, 32, 1, "wrapped", "fill"),
    "full fill grid": (2200000, 4, 1000, 1, "uniform", "clip"),
    # the match, content-understanding and recall models' tables
    "match_pyramid words, 200-byte rows, fill": (193368, 50, 16640, 1, "wrapped", "fill"),
    "tagspace text, D=10, fill": (75378, 10, 1024, 1, "wrapped", "fill"),
    "tagspace tags, 4 rows under 128 ids": (4, 10, 128, 1, "uniform", "fill"),
    "kim words, 1,891 x 300 under 52,800 ids": (1891, 300, 52800, 1, "uniform", "fill"),
    "multiview bags, L=8": (89777, 128, 64, 8, "wrapped", "fill"),
    "word2vec out_bias, D=1, N=192": (1000, 1, 192, 1, "uniform", "fill"),
    "word2vec out_emb, D=300, N=192": (1000, 300, 192, 1, "uniform", "fill"),
}


def _k1b_path_ids(rng, rows, n, pool, kind):
    if kind == "zeros":
        return np.zeros((n, pool), np.int32)
    if kind.startswith("period"):
        return (np.arange(n * pool) % int(kind.split()[1])).reshape(n, pool).astype(np.int32)
    if kind == "unique":
        return rng.permutation(rows)[:n * pool].reshape(n, pool).astype(np.int32)
    if kind == "residues":
        return (rng.randint(0, rows // 4, (n, pool)) * 4
                + np.arange(n * pool).reshape(n, pool) % 4).astype(np.int32)
    if kind == "wrapped":  # -rows..rows-1, and a few beyond: dropped
        ids = rng.randint(-rows, rows, (n, pool)).astype(np.int32)
        ids[:4, 0] = [-rows - 1, rows, 3 * rows, -3 * rows]
        return ids
    return rng.randint(0, rows, (n, pool)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype,dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("name", sorted(K1B_PATHS))
def test_gather_pool_bwd_kernel_paths(cuda, name, g_dtype, dtype):
    """Each path of K1b against the plain version, with a mask and without:
    rtol 1e-5 (1e-2 into bfloat16: one rounding of the f32 sum) and atol 1e-6
    times the most adds a row takes (atomics add in another order); bitwise
    where every row takes at most one add."""
    rows, dim, n, pool, kind, mode = K1B_PATHS[name]
    rng = np.random.RandomState(sorted(K1B_PATHS).index(name))
    ids = _k1b_path_ids(rng, rows, n, pool, kind)
    flat = ids.reshape(-1).astype(np.int64)
    if mode == "fill":
        flat = np.where(flat < 0, flat + rows, flat)
    adds = int(np.bincount(flat[(flat >= 0) & (flat < rows)]).max())
    g = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).to(cuda, g_dtype)
    ids = torch.from_numpy(ids).to(cuda)
    mask = torch.from_numpy(rng.rand(n, pool).astype(np.float32)).to(cuda)
    for m in (None, mask):
        before = gather_pool_bwd.launches
        out = gather_pool_bwd(g, ids, m, rows, dtype, mode=mode)
        torch.cuda.synchronize()
        assert gather_pool_bwd.launches == before + 1
        ref = gather_pool_bwd_plain(g, ids, m, rows, dtype, mode=mode)
        assert out.dtype == dtype and out.shape == (rows, dim)
        if adds == 1:
            assert torch.equal(out, ref), name
        else:
            rtol = 1e-5 if dtype == torch.float32 else 1e-2
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6 * adds,
                                       msg=name)


@pytest.mark.cuda
def test_gather_pool_bwd_bf16_dtable_with_many_adds_a_row(cuda):
    """A bfloat16 dtable with 100+ adds a row through the sorted path and the
    scatter alike: each contribution rounded to bfloat16, summed in float32
    and rounded once, as the plain version (rtol 1e-2: one rounding)."""
    rng = np.random.RandomState(7)
    # 300 adds a row into 20 rows: the sorted path; 120 into 5,000: the
    # scatter into the scratch
    for rows, per_row in ((20, 300), (5000, 120)):
        ids = rng.randint(0, rows, (per_row * rows, 1)).astype(np.int32)
        g = torch.from_numpy(rng.randn(ids.shape[0], 16).astype(np.float32)).to(cuda)
        ids = torch.from_numpy(ids).to(cuda)
        out = gather_pool_bwd(g, ids, None, rows, torch.bfloat16)
        ref = gather_pool_bwd_plain(g, ids, None, rows, torch.bfloat16)
        adds = int(torch.bincount(ids.reshape(-1).long()).max())
        assert out.dtype == torch.bfloat16 and adds >= 100
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-6 * adds)
