"""The readers of recall's deepwalk, mind, tisas and ensfm and of the graph
family in the port against the JAX package, bitwise from one written file
and seed: ``WalkPairDataset``, ``MINDDataset``, ``TiSASDataset``,
``ENSFMDataset``, ``GraphWalkDataset`` (two epochs: its walks go on), and
``window_pairs``; the port's ``GraphEngine`` (its own build of
``native/graph_engine.cpp`` under ``build/native/``) against the JAX
package's on counts, walks and samples; ``GraphChunkedDataset`` against the
JAX class over sharded files, two epochs, with the preload thread and
without; the graph models' ``make_dataset`` picks the native engine and,
with ``runner.graph_engine: python``, the Python walker; and mhcn's reader,
which is the port's own.  Writers of each format for quick fixtures live
here (``WRITERS``)."""

import os

import numpy as np
import pytest

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.data import graph_dataset as jax_graph_dataset
from paddlerec_tpu.native import graph as jax_native_graph
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class
from paddlerec_tpu_torch.data import graph_dataset as port_graph_dataset
from paddlerec_tpu_torch.models.graph.gnn.model import GraphWalkDataset
from paddlerec_tpu_torch.native import graph as port_native_graph
from tests.test_torch_graph_common import HYPER, flat_config


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_edges(data_dir, nodes=40, rows=90, seed=0, files=3):
    """``src dst [etype]`` lines over ``nodes`` nodes (a ring and random
    chords, some with an edge type), split over ``files`` files, a short
    line among them; nodes past ``nodes // 2`` in the second half only."""
    rng = np.random.RandomState(seed)
    lines = [f"{i} {(i + 1) % nodes}" for i in range(nodes)]
    for _ in range(rows - nodes):
        a, b = rng.randint(0, nodes, 2)
        lines.append(f"{a} {b}" + (f" {rng.randint(3)}" if rng.rand() < 0.5 else ""))
    lines.insert(5, "7")
    for p in range(files):
        _write(os.path.join(data_dir, f"edges_{p}.txt"), lines[p::files])


def write_mind(data_dir, users=12, seed=0):
    """``user,item,timestamp`` lines, 2 to 12 events a user in shuffled
    order, and a line of two fields."""
    h, rng = HYPER["recall.mind"], np.random.RandomState(seed)
    lines = [f"{u},{rng.randint(h['item_count'])},{rng.randint(10000)}"
             for u in range(users) for _ in range(rng.randint(2, 13))]
    rng.shuffle(lines)
    lines.insert(3, "5,6")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_tisas(data_dir, users=15, seed=0):
    """``user item rating timestamp`` lines, 1 to 14 events a user (a user
    of one event is skipped), timestamps on a grid of 7, item ids past the
    catalogue (taken modulo it), and a short line."""
    h, rng = HYPER["recall.tisas"], np.random.RandomState(seed)
    lines = []
    for u in range(users):
        for _ in range(rng.randint(1, 15)):
            lines.append(f"u{u} {rng.randint(3 * h['item_num'])} 5 "
                         f"{7 * rng.randint(1000)}.0")
    lines.insert(2, "u1 3 5")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_ensfm(data_dir, rows=120, seed=0):
    """``ufeat-ufeat,ifeat-ifeat`` lines of about 40 users and 35 items,
    and a line of one field."""
    rng = np.random.RandomState(seed)
    lines = [f"{rng.randint(40)}-{rng.randint(3)},{rng.randint(35)}-{rng.randint(2)}"
             for _ in range(rows)]
    lines.insert(1, "9-1")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_mhcn(data_dir, rows=70, seed=0):
    """A header, then ``user item weight`` lines."""
    h, rng = HYPER["recall.mhcn"], np.random.RandomState(seed)
    lines = ["userID itemID weight"] + [
        f"{rng.randint(h['num_users'])} {rng.randint(h['num_items'])} {rng.randint(1, 9)}"
        for _ in range(rows)]
    _write(os.path.join(data_dir, "part-0"), lines)


WRITERS = {
    "recall.deepwalk": write_edges, "graph.gnn": write_edges, "graph.lightgcn": write_edges,
    "graph.transformer_conv": write_edges, "graph.deepwalk_million": write_edges,
    "recall.mind": write_mind, "recall.tisas": write_tisas, "recall.ensfm": write_ensfm,
    "recall.mhcn": write_mhcn,
}


def _defs(model, **extra):
    flat = flat_config(model, **extra)
    return jax_model_class(model)(JaxConfig(flat)), get_model_class(model)(Config(flat))


def _equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("model", ["recall.deepwalk", "recall.mind", "recall.tisas",
                                   "recall.ensfm"])
def test_reader_matches_jax_bitwise(tmp_path, model):
    data = str(tmp_path / "data")
    WRITERS[model](data)
    jd, pd = _defs(model)
    for bs in (4, 32):
        _equal(list(pd.make_dataset(data, bs)), list(jd.make_dataset(data, bs)))


def test_python_walker_matches_jax_bitwise_across_epochs(tmp_path):
    data = str(tmp_path / "data")
    write_edges(data)
    jd, pd = _defs("graph.gnn", **{"runner.graph_engine": "python"})
    got, want = pd.make_dataset(data, 8), jd.make_dataset(data, 8)
    assert isinstance(got, GraphWalkDataset)
    for _ in range(2):  # the walker's RandomState carries over
        _equal(list(got), list(want))


def test_window_pairs_match_jax():
    walks = np.random.RandomState(0).randint(0, 30, (7, 6))
    walks[2, 3:] = -1
    walks[5, 1:] = -1
    for win in (1, 2, 5, 9):
        got = port_graph_dataset.window_pairs(walks, win)
        assert np.array_equal(got, jax_graph_dataset.window_pairs(walks, win))
    assert port_graph_dataset.window_pairs(walks[:, :1], 2).shape == (0, 2)


def test_graph_engine_matches_jax_and_builds_into_its_own_directory(tmp_path):
    data = str(tmp_path / "data")
    write_edges(data)
    files = sorted(os.path.join(data, f) for f in os.listdir(data))
    port = port_native_graph.GraphEngine(symmetry=True)
    ref = jax_native_graph.GraphEngine(symmetry=True)
    for f in files:
        assert port.load([f]) == ref.load([f])
    so = port_native_graph.graphlib()._name
    assert os.path.dirname(so) == str(port_native_graph.BUILD_DIR)
    assert os.path.basename(os.path.dirname(os.path.dirname(so))) == "build"
    assert (port.num_nodes, port.num_edges, port.max_node) == (
        ref.num_nodes, ref.num_edges, ref.max_node) == (40, 180, 39)
    assert [port.degree(n) for n in range(45)] == [ref.degree(n) for n in range(45)]
    nodes = port.nodes()
    assert np.array_equal(nodes, ref.nodes())
    for seed in (0, 7, 2**40 + 3):
        w = port.walks(nodes, 6, seed=seed)
        assert np.array_equal(w, ref.walks(nodes, 6, seed=seed))
        for fanout in (1, 3):
            got, want = port.sample(w[:, :3], fanout, seed), ref.sample(w[:, :3], fanout, seed)
            assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    # a node without an edge: mask 0
    _, mask = port.sample(np.array([44]), 2, 0)
    assert not mask.any()
    port.close()
    port.close()


@pytest.mark.parametrize("preload", [True, False])
def test_chunked_dataset_matches_jax_bitwise(tmp_path, preload):
    data = str(tmp_path / "data")
    write_edges(data)
    files = sorted(os.path.join(data, f) for f in os.listdir(data))
    extra = {"hyper_parameters.graph_chunk_nodes": 16}
    jd, pd = _defs("graph.gnn", **extra)
    got = port_graph_dataset.GraphChunkedDataset(files, pd, 16, seed=5, preload=preload,
                                                 num_parts=2)
    want = jax_graph_dataset.GraphChunkedDataset(files, jd, 16, seed=5, preload=preload,
                                                 num_parts=2)
    for _ in range(2):  # epoch e seeds seed + e
        batches = list(got)
        _equal(batches, list(want))
    assert batches[0]["neigh_1"].shape == (16, 2, 3, 2)


def test_graph_models_read_through_the_native_engine(tmp_path):
    data = str(tmp_path / "data")
    write_edges(data)
    for model in ("graph.gnn", "graph.lightgcn", "graph.transformer_conv",
                  "graph.deepwalk_million"):
        jd, pd = _defs(model)
        ds = pd.make_dataset(data, 8)
        assert isinstance(ds, port_graph_dataset.GraphChunkedDataset)
        first = next(iter(ds))
        assert first["pair_nodes"].shape == (8, 2)
        assert ("neigh_0" in first) == (model != "graph.deepwalk_million")
        _equal([first], [next(iter(jd.make_dataset(data, 8)))])


def test_mhcn_reader(tmp_path):
    """The header is skipped, ids are taken modulo the tables, a negative is
    never the positive, the tail batch is short, and each epoch draws new
    negatives from the seed's stream."""
    data = str(tmp_path / "data")
    write_mhcn(data)
    with open(os.path.join(data, "part-0"), "a") as f:
        f.write("23 16 1\n3\n")
    pd = get_model_class("recall.mhcn")(Config(flat_config("recall.mhcn")))
    ds = pd.make_dataset(data, 32)
    first = list(ds)
    assert [len(b["users"]) for b in first] == [32, 32, 7]
    last = first[-1]
    assert (last["users"][-1], last["pos_items"][-1]) == (3, 1)
    for b in first:
        assert all(v.dtype == np.int64 for v in b.values())
        assert np.all(b["neg_items"] != b["pos_items"])
        assert b["users"].max() < 20 and b["neg_items"].max() < 15
    second = list(ds)
    assert np.array_equal(second[0]["pos_items"], first[0]["pos_items"])
    assert not np.array_equal(second[0]["neg_items"], first[0]["neg_items"])
    again = list(pd.make_dataset(data, 32))
    _equal(again, first)
