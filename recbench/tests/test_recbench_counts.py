"""The frozen operation and byte counts against hand counts."""

import pytest

from recbench import harness, kernels, reference
from recbench.peaks import F32_FLOPS, HBM_BYTES_PER_S


def _model(name):
    config = harness.load_json(harness.HERE, "configs", name + ".json")
    return harness.model_module(config), config["hyper_parameters"]


def test_dlrm_flops_by_hand():
    model, hp = _model("dlrm_mlperf")
    bottom = 13 * 512 + 512 * 256 + 256 * 128          # 170,496
    pairs = 27 * 26 // 2                                 # 351, i < j
    top = 479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 2
    forward = 2 * (bottom + pairs * 128 + top)
    assert forward == 4820736
    assert model.flops(hp) == {"forward": forward, "train": 3 * forward - 2 * 13 * 512}


def test_deepfm_flops_by_hand():
    model, hp = _model("deepfm_1e8")
    tower = 247 * 512 + 512 * 256 + 256 * 128 + 128 * 32 + 32 * 1
    forward = 2 * (tower + 13) + 3 * 26 * 9 + 2 * 9 + 26
    assert forward == 589636
    assert model.flops(hp) == {"forward": forward, "train": 3 * forward - 2 * 13 * 513}


def test_table_layouts():
    for name, rows, width, pack in (("dlrm_mlperf", 40000000, 128, 1),
                                    ("deepfm_1e8", 12500001, 16, 8)):
        model, hp = _model(name)
        assert reference.layout(hp["sparse_feature_number"], model.logical_dim(hp)) == (
            rows, width, pack)


@pytest.mark.parametrize("touched,row_bytes,ids,out_row_bytes,lanes", [
    (800000, 512, 65536 * 26, 512, 128),      # DLRM's f32 rows, f32 out
    (1500000, 32, 131072 * 26, 64, 16),       # DeepFM's bf16 16-lane view, f32 out
])
def test_k1_bound_by_hand(touched, row_bytes, ids, out_row_bytes, lanes):
    nbytes = touched * row_bytes + ids * 4 + ids * out_row_bytes
    assert kernels.k1_bound_s(touched, row_bytes, ids, out_row_bytes, lanes) == max(
        nbytes / HBM_BYTES_PER_S, ids * lanes / F32_FLOPS)
    assert nbytes / HBM_BYTES_PER_S > ids * lanes / F32_FLOPS  # bytes bound these


def test_k1b_bound_by_hand():
    # DeepFM's compact rules: (U·8, 16) f32 buffer, (N, 16) f32 gradient rows
    u, n = 1200000, 131072 * 26
    nbytes = u * 128 * 4 + n * 16 * 4 + n * 4
    assert kernels.k1b_bound_s(u * 512, n, 64, 16) == nbytes / HBM_BYTES_PER_S


def test_kernel_names():
    assert kernels.is_k1("void gather_one_kernel<float, 4>(float const*, int const*)")
    assert kernels.is_k1("gather_pool_kernel<__nv_bfloat16>")
    assert not kernels.is_k1("void scatter_add_kernel<float, 0, 1>(...)")
    assert kernels.is_k1b("void scatter_add_kernel<float, 0, 1>(...)")
    assert kernels.is_k1b("fill_zero_kernel(float*, long)")
    assert not kernels.is_k1b("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8")


def test_batch_bounds_count_distinct_rows():
    import torch

    # ids 0, 1, 9 and 17 twice: 4 distinct logical rows; with pack 8 the
    # physical rows 0, 1 and 2
    sparse = torch.tensor([[0, 1], [9, 17], [17, 17 + 100]], dtype=torch.int32)
    k1, k1b = kernels.batch_bounds(sparse, 100, 2, 16, 8)
    assert k1 == kernels.k1_bound_s(4, 32, 6, 64, 16)
    assert k1b == kernels.k1b_bound_s(3 * 512, 6, 64, 16)
