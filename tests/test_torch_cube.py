"""The port's cube KV store (``paddlerec_tpu_torch/native/cube.py``, its own
builds of ``native/cube_kv.cpp`` and ``native/cube_server.cpp``), the table
export (``tools/export_cube.py``) and the params-only checkpoint, against
the JAX package's: shard files byte for byte, both packages' clients on the
same shards and servers, the wire's golden bytes, and the width inference
of the export on the cases of ``tests/test_export_cube.py``."""

import os
import socket

import numpy as np
import pytest
import torch

from paddlerec_tpu.native import cube as jax_cube
from paddlerec_tpu.ops.packed_embedding import pack_table
from paddlerec_tpu.tools.export_cube import collect_embedding_tables as jax_collect
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.native import cube
from paddlerec_tpu_torch.tools import export_cube
from paddlerec_tpu_torch.train import checkpoint as ckpt
from paddlerec_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "cube_wire")


def _table(seed, n=500, dim=10, spread=10**6):
    rng = np.random.RandomState(seed)
    keys = rng.choice(spread, n, replace=False).astype(np.int64)
    return keys, rng.randn(n, dim).astype(np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("shards", [1, 3, 12])
def test_shard_files_byte_identical(shards, tmp_path):
    keys, vals = _table(shards)
    port = cube.export_table(str(tmp_path / "port"), keys, vals, shards)
    ref = jax_cube.export_table(str(tmp_path / "jax"), keys, vals, shards)
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in ref]
    for a, b in zip(port, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_clients_match_jax(tmp_path):
    keys, vals = _table(7)
    paths = cube.export_table(str(tmp_path / "t"), keys, vals, 2)
    probe = np.concatenate([keys[::3], [10**7, 10**7 + 1, -5]])  # three misses
    want = jax_cube.CubeClient(paths).seek(probe)
    with cube.CubeClient(list(reversed(paths))) as client:  # ordered by shard id
        got = client.seek(probe)
    np.testing.assert_array_equal(got, want)
    assert not got[-3:].any()
    np.testing.assert_array_equal(got[:-3], vals[::3])
    default = np.arange(10, dtype=np.float32)
    with cube.CubeClient(paths, default_value=default) as client:
        np.testing.assert_array_equal(
            client.seek(probe), jax_cube.CubeClient(paths, default_value=default).seek(probe))
    with pytest.raises(ValueError, match="contiguous"):
        cube.CubeClient(paths[1:])
    # two port-built servers, one shard each, and one holding both
    fleets = [[(_free_port(), [p]) for p in paths], [(_free_port(), paths)]]
    procs = [cube.start_cube_server(port, shard) for fleet in fleets for port, shard in fleet]
    try:
        for fleet in fleets:
            addrs = [f"127.0.0.1:{port}" for port, _ in fleet]
            with cube.RemoteCubeClient(addrs) as remote:
                assert remote.dim == 10
                np.testing.assert_array_equal(remote.seek(probe), got)
            ref = jax_cube.RemoteCubeClient(addrs)
            np.testing.assert_array_equal(ref.seek(probe), got)
            ref.close()
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


def test_wire_fixtures_and_live_server(tmp_path):
    req_keys = np.array([3, 17, 42], np.int64)
    with open(os.path.join(FIXDIR, "request_shard1.bin"), "rb") as f:
        assert cube.RemoteCubeClient.encode_request(1, req_keys) == f.read()
    with open(os.path.join(FIXDIR, "request_probe.bin"), "rb") as f:
        assert cube.RemoteCubeClient.encode_request(0xFFFFFFFF, np.zeros(0, np.int64)) == f.read()
    with open(os.path.join(FIXDIR, "response_shard1.bin"), "rb") as f:
        want = f.read()
    assert cube.RemoteCubeClient.decode_response_header(want[:20]) == (0, 4, 3, 1)
    with pytest.raises(IOError, match="magic"):
        cube.RemoteCubeClient.decode_response_header(b"\0" * 20)
    # the fixture's table: keys 0..9, dim 4, value[k, j] = k + j/10
    keys = np.arange(10, dtype=np.int64)
    vals = (keys[:, None] + np.arange(4)[None, :] / 10.0).astype(np.float32)
    paths = cube.export_table(str(tmp_path / "t"), keys, vals, num_shards=2)
    port = _free_port()
    proc = cube.start_cube_server(port, [paths[1]])  # the shard-1 server
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            with open(os.path.join(FIXDIR, "request_shard1.bin"), "rb") as f:
                s.sendall(f.read())
            raw = b""
            while len(raw) < len(want):
                got = s.recv(len(want) - len(raw))
                assert got, "server closed early"
                raw += got
        assert raw == want
    finally:
        proc.kill()
        proc.wait()


def _params(dense):
    return {"embedding": {"embedding": pack_table(dense)}}


def _padded(dense):
    return {"embedding": {"embedding": np.concatenate(
        [pack_table(dense), np.zeros((3, 128), np.float32)])}}


def _with_tap(dense):
    return {"embedding": {"embedding": pack_table(dense),
                          "embedding_delta": np.zeros((256, 128), np.float32)}}


# the cases of tests/test_export_cube.py: (params from a (vocab, w) table,
# vocab, sparse_feature_dim, seed, w)
CASES = {
    # 993 % 16 == 1: the w=8 window [63, 126) holds the true w=16 row count
    "exact rows": (_params, 993, 9, 0, 16),
    # rows padded for a mesh (125 → 128)
    "mp padded rows": (_padded, 993, 9, 1, 16),
    # the gradient tap under a module named embedding is no table
    "delta tap excluded": (_with_tap, 993, 9, 3, 16),
    "w8": (_params, 1000, 8, 2, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collect_embedding_tables(case):
    make, vocab, dim, seed, w = CASES[case]
    dense = np.random.RandomState(seed).randn(vocab, w).astype(np.float32)
    params = make(dense)
    got = export_cube.collect_embedding_tables(params, vocab, dim)
    want = jax_collect(params, vocab, dim)
    assert set(got) == set(want) == {"embedding/embedding"}
    np.testing.assert_array_equal(got["embedding/embedding"], want["embedding/embedding"])
    np.testing.assert_array_equal(got["embedding/embedding"], dense)
    # the same table as a state_dict entry: a torch tensor, a dotted name
    flat = {f"embedding.{k}": torch.from_numpy(v)
            for k, v in params["embedding"].items()}
    got = export_cube.collect_embedding_tables(flat, vocab, dim)
    assert set(got) == {"embedding/embedding"}
    np.testing.assert_array_equal(got["embedding/embedding"], dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_only_round_trip_and_export(dtype, tmp_path):
    flat = {"runner.model": "rank.dnn", "hyper_parameters.sparse_feature_number": 1001,
            "hyper_parameters.sparse_feature_dim": 9, "hyper_parameters.fc_sizes": [8],
            "hyper_parameters.sparse_feature_dtype": dtype, "runner.seed": 3}
    trainer = Trainer(Config(flat), device="cpu")
    trainer.init_state()
    state = trainer.state.module.state_dict()
    path = ckpt.save_params_only(state, str(tmp_path), "base_x")
    assert path == str(tmp_path / "base_x")
    assert not os.path.exists(tmp_path / ckpt.DONEFILE)
    back = ckpt.load_params_only(str(tmp_path), "base_x")
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    fresh = Trainer(Config(dict(flat, **{"runner.seed": 4})), device="cpu")
    fresh.load_checkpoint(str(tmp_path), "base_x", params_only=True)
    for k, v in state.items():
        assert torch.equal(fresh.state.module.state_dict()[k], v), k
    # the host tool: the base to two shards of logical rows
    out = tmp_path / "cube"
    yaml = tmp_path / "c.yaml"
    yaml.write_text("runner:\n  model: rank.dnn\n")
    assert export_cube.main([
        "-m", str(yaml), "--out", str(out), "--shards", "2", "-o",
        f"runner.model_init_path={path}",
        *(f"{k}={v}" for k, v in flat.items() if k not in ("runner.model",)
          and not isinstance(v, list)), "hyper_parameters.fc_sizes=[8]"]) == 0
    table = state["embedding.embedding"].float().numpy().reshape(-1, 16)[:1001]
    shards = sorted(str(p) for p in (out / "embedding_embedding").iterdir())
    with cube.CubeClient(shards) as client:
        assert client.dim == 16
        np.testing.assert_array_equal(client.seek(np.arange(1001)), table)
