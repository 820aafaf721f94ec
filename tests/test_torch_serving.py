"""Serving path of the port against the JAX package: artifact, batch
predictor over slot-text files, HTTP service; plus the port's data copies,
its device rule and its import boundary."""

import ast
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.data import slot_reader as jax_reader
from paddlerec_tpu.data import synthetic as jax_synthetic
from paddlerec_tpu.data.schema import schema_from_config as jax_schema
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu_torch.data import slot_reader as port_reader
from paddlerec_tpu_torch.data import synthetic as port_synthetic
from paddlerec_tpu_torch.data.schema import schema_from_config as port_schema
from paddlerec_tpu_torch.serving.webserver import RecClient, RecService
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import predict as port_predict
from tests.conftest import small_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32
ROWS = 100  # 3 full batches and a padded tail of 4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A JAX artifact, the port's artifact made from its parameters, and
    slot-text data written by the port."""
    root = tmp_path_factory.mktemp("serving")
    cfg = small_config(root)
    jax_dir, port_dir = str(root / "jax_export"), str(root / "port_export")
    jax_export.export_model(cfg, jax_dir)
    _, params = jax_export.load_exported(jax_dir)
    port_export.export_model(cfg, port_dir, params=jax.tree.map(np.asarray, params))
    data_dir = str(root / "data")
    port_synthetic.write_criteo_sample(data_dir, num_lines=ROWS, num_files=2,
                                       vocab=10000, seed=5)
    return cfg, jax_dir, port_dir, data_dir


def test_data_copies_match_jax(tmp_path):
    cfg = small_config(tmp_path)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_synthetic.write_criteo_sample(a, num_lines=70, num_files=2, vocab=999, seed=3)
    port_synthetic.write_criteo_sample(b, num_lines=70, num_files=2, vocab=999, seed=3)
    for name in ("part-0", "part-1"):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read()
    ref = list(jax_reader.SlotDataset(jax_reader.list_data_files(a), jax_schema(cfg), 16))
    got = list(port_reader.SlotDataset(port_reader.list_data_files(b), port_schema(cfg), 16))
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        assert sorted(r) == sorted(g)
        for k in r:
            assert r[k].dtype == g[k].dtype and np.array_equal(r[k], g[k]), k
    assert got[-1]["mask"].sum() == 70 - 4 * 16


def test_run_predict_matches_jax(artifacts):
    _, jax_dir, port_dir, data_dir = artifacts
    ref, _ = jax_predict.run_predict(jax_dir, data_dir, BATCH)
    out, report = port_predict.run_predict(port_dir, data_dir, BATCH, device="cpu")
    assert [len(o) for o in out] == [len(r) for r in ref] == [32, 32, 32, 4]
    np.testing.assert_allclose(np.concatenate(out), np.concatenate(ref),
                               rtol=0, atol=1e-5)
    assert report["batches"] == 3  # batch 0 warms up; the padded tail counts
    assert report["qps"] > 0 and report["p99_ms"] >= report["p50_ms"]


def test_cli_predict_on_cpu(artifacts):
    _, _, port_dir, data_dir = artifacts
    port_predict.main(["--export_dir", port_dir, "--data_dir", data_dir,
                       "--batch_size", "50", "--device", "cpu"])


def test_http_service_answers_like_run_predict(artifacts):
    cfg, _, port_dir, data_dir = artifacts
    want, _ = port_predict.run_predict(port_dir, data_dir, BATCH, device="cpu")
    service = RecService(port_dir, device="cpu")
    server = service.run_web_service(port=0, background=True)
    try:
        client = RecClient("127.0.0.1", server.server_address[1])
        dataset = port_reader.SlotDataset(
            port_reader.list_data_files(data_dir), port_schema(cfg), BATCH)
        answers = client.predict_batches(dataset, limit=2)
    finally:
        server.shutdown()
        server.server_close()
    assert len(answers) == 2
    for got, ref in zip(answers, want):
        np.testing.assert_allclose(got["result"]["predictions"], ref,
                                   rtol=0, atol=1e-6)


def test_entry_points_raise_without_cuda(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, _, port_dir, data_dir = artifacts
    calls = [
        lambda: port_export.load_exported(port_dir),
        lambda: port_predict.run_predict(port_dir, data_dir, BATCH),
        lambda: port_predict.main(["--export_dir", port_dir, "--data_dir", data_dir]),
        lambda: RecService(port_dir),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddlerec_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
        "m.split('.')[0] in ('flax', 'optax', 'orbax', 'paddlerec_tpu'))\n"
        "assert not bad, bad\n"
        "print('\\n'.join(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # every module file of the package was walked, the training slice's too
    walked = set(res.stdout.split())
    on_disk = set()
    for path in glob.glob(os.path.join(REPO, "paddlerec_tpu_torch", "**", "*.py"),
                          recursive=True):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        on_disk.add(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    assert on_disk - {"paddlerec_tpu_torch"} == walked
    for name in ("train.trainer", "train.optimizers", "train.checkpoint", "train.state",
                 "core.metrics", "data.wire", "data.binary", "data.superbatch",
                 "tools.train", "tools.infer", "utils.fs", "ops.sparse_update",
                 "models.rank.dnn.model", "models.rank.wide_deep.model", "ops.sequence",
                 *(f"models.rank.{m}.model" for m in (
                     "lr", "fm", "slot_dnn", "dcn", "dcn_v2", "dlrm", "xdeepfm",
                     "autoint", "gatenet", "flen", "deepfefm", "difm", "ffm",
                     "fat_deepffm", "fgcnn", "autofis",
                     "din", "dien", "bst", "dsin", "dmr", "dpin",
                     "deeprec", "iprec", "naml", "fastformer", "sign", "bert4rec")),
                 "models.multitask.base",
                 *(f"models.multitask.{m}.model" for m in (
                     "share_bottom", "mmoe", "ple", "esmm", "aitm", "escm2", "dselect_k",
                     "maml", "metaheac")),
                 *(f"models.{m}.model" for m in (
                     "match.dssm", "match.multiview_simnet", "match.match_pyramid",
                     "match.kim", "contentunderstanding.textcnn",
                     "contentunderstanding.tagspace", "recall.ncf", "recall.word2vec")),
                 "data.alias", "tools.cal_pos_neg", "tools.analogy_eval",
                 *(f"models.{m}.model" for m in (
                     "recall.deepwalk", "recall.mind", "recall.tisas", "recall.ensfm",
                     "recall.mhcn", "graph.gnn")),
                 "models.graph.layers", "native", "native.graph", "data.graph_dataset",
                 "models.treebased.tree", "models.treebased.tdm.model", "models.treebased.jtm",
                 "tools.jtm", "models.rl.a2c.model", "models.demo.movie_recommand.model",
                 "serving.vector_index", "serving.movie_recommender",
                 "train.online", "train.touched", "native.cube", "tools.online_train",
                 "tools.export_cube", "tools.cube_server",
                 "parallel.host_table", "train.host_loop", "native.reader",
                 "tools.dataset_convert", "data.external", "utils.onoff_diff",
                 "utils.profiler", "utils.visual"):
        assert f"paddlerec_tpu_torch.{name}" in walked, name


def test_no_import_of_jax_anywhere_in_the_port():
    """Every import statement, module level or inside a function, of the
    port and of chip_smoke.py."""
    files = glob.glob(os.path.join(REPO, "paddlerec_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 75
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert not top.startswith("jax") and top not in (
                    "flax", "optax", "orbax", "paddlerec_tpu"), (path, name)
