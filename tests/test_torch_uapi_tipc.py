"""The port's single-device API and tools against the JAX package's:
``RankModel`` (train, evaluate, export, infer, predict, compression),
``tools.compress`` and the compressed artifact's load, ``tools.
feature_importance``, ``tools.tipc`` and its benchmark gate,
``tools.tipc_benchmark_summary`` and ``utils.benchmark``.  The cases of
``tests/test_uapi_tipc.py``, each run through the port on the CPU and, where
the two can be compared, held against the JAX package on the same
parameters and rows."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.tools import compress as jax_compress
from paddlerec_tpu.tools import feature_importance as jax_fi
from paddlerec_tpu.tools import tipc as jax_tipc
from paddlerec_tpu.tools.export import export_model as jax_export_model
from paddlerec_tpu.tools.predict import run_predict as jax_run_predict
from paddlerec_tpu.train.trainer import Trainer as JaxTrainer
from paddlerec_tpu.uapi import RankModel as JaxRankModel
from paddlerec_tpu_torch.convert import from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.tools import compress as port_compress
from paddlerec_tpu_torch.tools import feature_importance as port_fi
from paddlerec_tpu_torch.tools import tipc as port_tipc
from paddlerec_tpu_torch.tools.export import export_model as port_export_model
from paddlerec_tpu_torch.tools.predict import run_predict as port_run_predict
from paddlerec_tpu_torch.tools.tipc_benchmark_summary import main as summary_main
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from paddlerec_tpu_torch.uapi import RankModel, UnsupportedAPIError
from paddlerec_tpu_torch.utils.benchmark import InferBenchmark

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "hyper_parameters.sparse_inputs_slots": 27,
    "hyper_parameters.dense_input_dim": 13,
    "hyper_parameters.sparse_feature_number": 5000,
    "hyper_parameters.sparse_feature_dim": 8,
    "hyper_parameters.fc_sizes": [32, 16],
    "runner.train_batch_size": 16,
    "runner.infer_batch_size": 16,
    "runner.epochs": 1,
}
# the train() keys that are timings, not metrics
TIMINGS = ("epoch_time", "ips")


@pytest.fixture
def criteo_dir(tmp_path):
    out = tmp_path / "train"
    write_criteo_sample(str(out), num_lines=64, num_files=1, vocab=5000)
    return str(out)


def _preds(path):
    return np.array([float(x) for x in open(path)])


def _jax_params(flat):
    """The JAX trainer's initial parameters for a config (runner.seed)."""
    trainer = JaxTrainer(JaxConfig(dict(flat)))
    trainer.init_state()
    return jax.tree.map(np.asarray, jax.device_get(trainer.state.params))


def _jax_trained(flat, root, tag="0"):
    """The parameters of a JAX checkpoint ``root/tag``."""
    trainer = JaxTrainer(JaxConfig(dict(flat)))
    trainer.init_state()
    trainer.load_checkpoint(root, tag, params_only=True)
    return jax.tree.map(np.asarray, jax.device_get(trainer.state.params))


def _port_checkpoint(params, root, tag="0") -> str:
    """A port checkpoint (params only) of a JAX parameter tree."""
    return port_ckpt.save_params_only(from_jax_params(params), root, tag)


def test_uapi_train_evaluate_export_infer(tmp_path, criteo_dir, monkeypatch):
    """The port's ``RankModel`` on a small dnn from the JAX trainer's initial
    parameters: the same ``train()`` metrics (rtol 1e-5) as the JAX
    ``RankModel`` on the same rows, then evaluate, export and infer."""
    flat = {"runner.model": "rank.dnn", **SMALL}
    start = _jax_params(flat)
    init = port_trainer_mod.Trainer.init_state

    def init_from_jax(self, seed=None):
        state = init(self, seed)
        state.module.load_state_dict(from_jax_params(start))
        return state

    monkeypatch.setattr(port_trainer_mod.Trainer, "init_state", init_from_jax)
    model = RankModel("dnn", config=dict(SMALL), device="cpu")
    metrics = model.train(dataset=criteo_dir, save_dir=str(tmp_path / "ckpt"))
    ref = JaxRankModel("dnn", config=dict(SMALL)).train(
        dataset=criteo_dir, save_dir=str(tmp_path / "jax_ckpt"))
    assert sorted(metrics) == sorted(ref) and "auc" in ref
    for key in set(ref) - set(TIMINGS):
        np.testing.assert_allclose(metrics[key], ref[key], rtol=1e-5, err_msg=key)
    ev = model.evaluate(dataset=criteo_dir, weight_path=str(tmp_path / "ckpt" / "0"))
    assert 0.0 <= ev["auc"] <= 1.0
    export_dir = str(tmp_path / "export")
    model.export(str(tmp_path / "ckpt" / "0"), export_dir)
    assert os.path.exists(os.path.join(export_dir, "config.json"))
    preds = _preds(model.infer(export_dir, criteo_dir, str(tmp_path / "infer")))
    assert len(preds) == 64
    assert np.all((preds >= 0.0) & (preds <= 1.0))


def test_uapi_predict_writes_the_jax_predictions(tmp_path, criteo_dir):
    """``predict`` from a trained JAX checkpoint and from the port's
    checkpoint of the same parameters: the same ``predictions.txt`` values
    (rtol 1e-5), one ``%.6f`` line a row in ``run_predict``'s order."""
    flat = {"runner.model": "rank.dnn", **SMALL}
    jax_model = JaxRankModel("dnn", config=dict(SMALL))
    jax_model.train(dataset=criteo_dir, save_dir=str(tmp_path / "jax"))
    trained = _jax_trained(flat, str(tmp_path / "jax"))
    weight = _port_checkpoint(trained, str(tmp_path / "port"))
    got = RankModel("dnn", config=dict(SMALL), device="cpu").predict(
        weight, criteo_dir, str(tmp_path / "p_port"), batch_size=16)
    want = jax_model.predict(str(tmp_path / "jax" / "0"), criteo_dir,
                             str(tmp_path / "p_jax"), batch_size=16)
    lines = open(got).read().splitlines()
    assert all(len(x.split(".")[1]) == 6 for x in lines)
    np.testing.assert_allclose(_preds(got), _preds(want), rtol=1e-5)


def test_uapi_unknown_model():
    with pytest.raises(ValueError, match="unknown model"):
        RankModel("not_a_model", device="cpu")


def test_uapi_precheck():
    model = RankModel("dnn", config=dict(SMALL), device="cpu")
    with pytest.raises(UnsupportedAPIError, match="train_data_dir"):
        model.train()
    with pytest.raises(UnsupportedAPIError, match="test_data_dir"):
        model.evaluate()


def test_uapi_resolves_a_config_path(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("runner:\n  model: rank.deepfm\n  train_batch_size: 8\n")
    model = RankModel(str(path), device="cpu")
    assert model.model_name == "rank.deepfm"
    assert model.config.runner("train_batch_size") == 8
    assert RankModel("rank.dnn", device="cpu").model_name == "rank.dnn"


def test_uapi_needs_a_card_or_the_cpu(tmp_path, criteo_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankModel("dnn", config=dict(SMALL)).train(dataset=criteo_dir)


def test_uapi_compression_quantizes_and_predicts(tmp_path, criteo_dir):
    """compression(): int8 tables; the compressed artifact predicts within
    the int8 error of the plain one (atol 0.02, as the JAX test)."""
    model = RankModel("dnn", config=dict(
        SMALL, **{"runner.train_data_dir": criteo_dir}), device="cpu")
    save = tmp_path / "trained"
    model.train(save_dir=str(save))
    comp = model.compression(str(save / "0"), str(tmp_path / "small"))
    assert os.path.exists(os.path.join(comp, "quantized.npz"))
    assert json.load(open(os.path.join(comp, "config.json")))["compressed"] is True
    exp = tmp_path / "plain"
    model.export(str(save / "0"), str(exp))
    pa = _preds(model.infer(str(exp), criteo_dir, str(tmp_path / "ia"), batch_size=16))
    pb = _preds(model.infer(comp, criteo_dir, str(tmp_path / "ib"), batch_size=16))
    assert len(pa) == len(pb) == 64
    np.testing.assert_allclose(pa, pb, atol=0.02)


def _jax_compressed(params, out_dir):
    """The JAX tool's compression of a parameter tree: its
    ``quantize_params`` and the ``quantized.npz`` payload of its
    ``compress_artifact``.  Returns (placeholder tree, quant dict)."""
    small, quant = jax_compress.quantize_params(params)
    payload = {}
    for name, (q, scale, dtype) in quant.items():
        payload.update({f"{name}/q": q, f"{name}/scale": scale,
                        f"{name}/dtype": np.asarray(dtype)})
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "quantized.npz"), **payload)
    return small, quant


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_artifact_bitwise_as_jax(tmp_path, dtype):
    """The same parameters through the port's export and compression and
    through the JAX tool's quantization: the same quantized leaves, ``q``
    and ``scale`` bitwise equal, the same dtype names; a bfloat16 table
    stays whole in both (the JAX rule does not take it)."""
    flat = {"runner.model": "rank.deepfm", **SMALL,
            "hyper_parameters.sparse_feature_number": 20000,
            "hyper_parameters.sparse_feature_dim": 9,
            "hyper_parameters.sparse_feature_dtype": dtype}
    params = _jax_params(flat)
    trainer = JaxTrainer(JaxConfig(dict(flat)))
    trainer.init_state()
    _jax_compressed(jax.device_get(trainer.state.params), str(tmp_path / "jc"))
    port_export_model(Config(dict(flat)), str(tmp_path / "pe"), params=params)
    port_compress.compress_artifact(str(tmp_path / "pe"), str(tmp_path / "pc"))
    pz = np.load(tmp_path / "pc" / "quantized.npz")
    jz = np.load(tmp_path / "jc" / "quantized.npz")
    assert sorted(pz.files) == sorted(jz.files)
    if dtype == "float32":
        assert "embedding/embedding/q" in pz.files
    else:
        assert not pz.files
    for k in pz.files:
        assert pz[k].dtype == jz[k].dtype, k
        np.testing.assert_array_equal(pz[k], jz[k], err_msg=k)
    with np.load(tmp_path / "pc" / "params.npz") as small:
        for k in pz.files:
            if k.endswith("/q"):
                assert small[k[:-2]].shape == (0,)
    # the port's quantize_params on the JAX tree itself
    jq = jax_compress.quantize_params(params)[1]
    small, quant = port_compress.quantize_params(params)
    assert sorted(quant) == sorted(jq)
    for k, (q, scale, name) in quant.items():
        np.testing.assert_array_equal(q, jq[k][0])
        np.testing.assert_array_equal(scale, jq[k][1])
        assert name == jq[k][2]
        assert small[k].shape == (0,)


def test_compressed_artifacts_predict_alike(tmp_path, monkeypatch):
    """The JAX package's compressed parameters served by its ``run_predict``
    and the port's compressed artifact of the same parameters served by the
    port's ``run_predict`` (whose ``load_exported`` dequantizes
    ``quantized.npz``): the same predictions (rtol 1e-5, atol 1e-6).

    The JAX ``compress_artifact`` cannot write an artifact whose tables are
    quantized with this orbax (it refuses the zero-size placeholders), so
    its ``run_predict`` is given what its ``load_exported`` returns for such
    an artifact: the placeholder tree through its ``dequantize_into``."""
    data = tmp_path / "data"
    write_criteo_sample(str(data), num_lines=96, num_files=1, vocab=20000)
    flat = {"runner.model": "rank.deepfm", **SMALL,
            "hyper_parameters.sparse_feature_number": 20000,
            "hyper_parameters.sparse_feature_dim": 9}
    params = _jax_params(flat)
    jax_export_model(JaxConfig(dict(flat)), str(tmp_path / "je"))
    trainer = JaxTrainer(JaxConfig(dict(flat)))
    trainer.init_state()
    small, quant = _jax_compressed(jax.device_get(trainer.state.params),
                                   str(tmp_path / "jc"))
    assert "embedding/embedding" in quant
    from paddlerec_tpu.core.registry import load_model_def
    from paddlerec_tpu.tools import predict as jax_predict

    deq = jax_compress.dequantize_into(small, np.load(tmp_path / "jc" / "quantized.npz"))
    monkeypatch.setattr(jax_predict, "load_exported",
                        lambda _: (load_model_def(JaxConfig(dict(flat))), deq))
    want = np.concatenate(jax_run_predict(str(tmp_path / "je"), str(data), 32)[0])
    port_export_model(Config(dict(flat)), str(tmp_path / "pe"), params=params)
    port_compress.main(["--export_dir", str(tmp_path / "pe"), "--out", str(tmp_path / "pc")])
    got = np.concatenate(port_run_predict(str(tmp_path / "pc"), str(data), 32,
                                          device="cpu")[0])
    plain = np.concatenate(port_run_predict(str(tmp_path / "pe"), str(data), 32,
                                            device="cpu")[0])
    assert got.shape == want.shape == (96,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(got, plain)  # the tables were quantized
    np.testing.assert_allclose(got, plain, atol=0.02)


def test_feature_importance_matches_jax(tmp_path):
    """The same checkpoint (the JAX one, converted) and rows: the same
    baseline AUC and AUC delta per slot group (atol 1e-6)."""
    data = tmp_path / "data"
    write_criteo_sample(str(data), num_lines=256, num_files=1, vocab=5000, seed=3)
    flat = {"runner.model": "rank.dnn", **SMALL, "runner.infer_batch_size": 64,
            "runner.test_data_dir": str(data), "runner.train_data_dir": str(data)}
    JaxRankModel("dnn", config=dict(flat)).train(save_dir=str(tmp_path / "jax"))
    trained = _jax_trained(flat, str(tmp_path / "jax"))
    _port_checkpoint(trained, str(tmp_path / "port"))
    groups = [[0], [1, 2], [12]]
    want = jax_fi.run(JaxConfig(dict(
        flat, **{"runner.model_init_path": str(tmp_path / "jax" / "0")})), groups)
    got = port_fi.run(Config(dict(
        flat, **{"runner.model_init_path": str(tmp_path / "port" / "0")})), groups,
        device="cpu")
    assert sorted(got) == sorted(want) == ["0", "1,2", "12", "baseline"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    assert got["baseline"] > 0.5


TIPC_CONFIGS = sorted(glob.glob(os.path.join(REPO, "test_tipc", "configs", "*",
                                             "train_infer_python.txt")))


@pytest.mark.parametrize("path", TIPC_CONFIGS,
                         ids=[os.path.basename(os.path.dirname(p)) for p in TIPC_CONFIGS])
def test_parse_config_txt_as_jax(path):
    """Every TIPC parameter file, in every mode: the same dict."""
    assert port_tipc.MODES == jax_tipc.MODES
    for mode in port_tipc.MODES:
        assert port_tipc.parse_config_txt(path, mode) == jax_tipc.parse_config_txt(path, mode)


def _tipc_txt(tmp_path, data, **extra):
    lines = {
        "model_name": "dnn", "runner.model": "rank.dnn",
        "runner.train_data_dir": str(data), "runner.test_data_dir": str(data),
        "runner.epochs": "lite_train_lite_infer=1|whole_train_whole_infer=4",
        "runner.train_batch_size": "16", "runner.infer_batch_size": "16",
        "hyper_parameters.sparse_inputs_slots": "27",
        "hyper_parameters.dense_input_dim": "13",
        "hyper_parameters.sparse_feature_number": "5000",
        "hyper_parameters.sparse_feature_dim": "8",
        "hyper_parameters.fc_sizes": "[32,16]", "skip_me": "null", **extra,
    }
    path = tmp_path / "train_infer_python.txt"
    path.write_text("".join(f"{k}:{v}\n" for k, v in lines.items()))
    return str(path)


def test_tipc_parse_and_run(tmp_path, criteo_dir):
    """``run_mode``'s status log: the same step lines as the JAX tool's."""
    cfg_txt = _tipc_txt(tmp_path, criteo_dir)
    spec = port_tipc.parse_config_txt(cfg_txt, "lite_train_lite_infer")
    assert spec["runner.epochs"] == "1"
    assert "skip_me" not in spec
    assert port_tipc.parse_config_txt(cfg_txt, "whole_train_whole_infer")["runner.epochs"] == "4"
    assert port_tipc.run_mode(cfg_txt, "lite_train_lite_infer",
                              output_dir=str(tmp_path / "out"), device="cpu")
    assert jax_tipc.run_mode(cfg_txt, "lite_train_lite_infer",
                             output_dir=str(tmp_path / "jax_out"))
    name = "results_python_lite_train_lite_infer.log"
    got = (tmp_path / "out" / name).read_text()
    assert got.count("Run successfully") == 3
    assert got == (tmp_path / "jax_out" / name).read_text()
    preds = _preds(tmp_path / "out" / "dnn_lite_train_lite_infer_infer" / "predictions.txt")
    assert len(preds) == 64


def test_tipc_run_mode_records_a_failed_step(tmp_path, criteo_dir):
    cfg_txt = _tipc_txt(tmp_path, criteo_dir,
                        **{"runner.train_data_dir": str(tmp_path / "missing"),
                           "runner.test_data_dir": str(tmp_path / "missing")})
    assert not port_tipc.run_mode(cfg_txt, "lite_train_lite_infer",
                                  output_dir=str(tmp_path / "out"), device="cpu")
    log = (tmp_path / "out" / "results_python_lite_train_lite_infer.log").read_text()
    assert "Run failed with command - train dnn!" in log


def _bench_txt(tmp_path, rows=256, batches="32|64", devices="1|2"):
    data = tmp_path / "data"
    write_criteo_sample(str(data), num_lines=rows, num_files=1, vocab=1000)
    cfg = tmp_path / "bench.txt"
    cfg.write_text(
        "model_name:dnn\n"
        "runner.model:rank.dnn\n"
        f"runner.train_data_dir:{data}\n"
        "hyper_parameters.sparse_inputs_slots:27\n"
        "hyper_parameters.dense_input_dim:13\n"
        "hyper_parameters.sparse_feature_number:1000\n"
        "hyper_parameters.sparse_feature_dim:8\n"
        "hyper_parameters.fc_sizes:[16]\n"
        f"benchmark.batch_sizes:{batches}\n"
        f"benchmark.device_nums:{devices}\n"
        "benchmark.steps:4\n"
    )
    return cfg, data


def test_tipc_benchmark_train_mode(tmp_path, monkeypatch):
    """benchmark_train: ips per batch cell; device_num 2 above the world
    size of 1 is skipped with its reason; a floor record passes the >20%
    gate and an inflated one trips it."""
    monkeypatch.setenv("TIPC_ASSUME_CORES", "8")  # the gate arms on a small host
    cfg, _ = _bench_txt(tmp_path)
    out = tmp_path / "out"
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out), device="cpu")
    rec_path = out / "benchmark_train_dnn.cpu.json"
    rec = json.load(open(rec_path))
    assert rec["backend"] == "cpu" and rec["warmup"] == 3
    assert {(r["batch"], r["devices"]) for r in rec["results"]} == {(32, 1), (64, 1)}
    assert all(r["ips"] > 0 and r["steps"] == 50 for r in rec["results"])
    assert rec["skipped"] == [{"devices": 2, "reason": "only 1 devices"}]
    floor = dict(rec, results=[dict(r, ips=r["ips"] * 0.01) for r in rec["results"]])
    rec_path.write_text(json.dumps(floor))
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out), device="cpu")
    inflated = dict(rec, results=[dict(r, ips=r["ips"] * 100.0) for r in rec["results"]])
    rec_path.write_text(json.dumps(inflated))
    assert not port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out),
                                       device="cpu")


def test_benchmark_regression_keeps_baseline(tmp_path, monkeypatch):
    """A regressed run does not overwrite the tracked baseline; the run
    artifact with the findings lands in output_dir."""
    monkeypatch.setenv("TIPC_ASSUME_CORES", "8")
    cfg, _ = _bench_txt(tmp_path, rows=128, batches="32", devices="1")
    out, records = tmp_path / "out", tmp_path / "records"
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(records),
                                   device="cpu")
    rec_path = records / "benchmark_train_dnn.cpu.json"
    baseline = json.load(open(rec_path))
    inflated = dict(baseline, results=[dict(r, ips=r["ips"] * 100.0)
                                       for r in baseline["results"]])
    rec_path.write_text(json.dumps(inflated))
    assert not port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(records),
                                       device="cpu")
    assert json.load(open(rec_path)) == inflated
    run_rec = json.load(open(out / "benchmark_train_dnn.cpu.json"))
    assert run_rec["regressions"], run_rec
    # another backend's baseline is never diffed: no gate, a clean run
    rec_path.write_text(json.dumps(dict(inflated, backend="cuda:another card")))
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(records),
                                   device="cpu")


def test_benchmark_summary_empty_dir_fails(tmp_path):
    assert summary_main([str(tmp_path)]) == 1


def test_benchmark_summary_gates_on_regressions(tmp_path):
    rec = {"model": "dnn", "results": [{"batch": 32, "devices": 1, "ips": 10.0}],
           "skipped": [{"devices": 2, "reason": "only 1 devices"}], "backend": "cpu"}
    (tmp_path / "benchmark_train_dnn.cpu.json").write_text(json.dumps(rec))
    assert summary_main([str(tmp_path)]) == 0
    summary = json.load(open(tmp_path / "benchmark_summary.json"))
    assert summary["models"] == 1 and summary["skipped_cells"] == 1
    assert "dnn.cpu" in summary["records"]
    rec["regressions"] = [{"batch": 32, "devices": 1, "ips": 1.0, "prev_ips": 10.0,
                           "drop_pct": 90.0}]
    (tmp_path / "benchmark_train_dnn.cpu.json").write_text(json.dumps(rec))
    assert summary_main([str(tmp_path)]) == 1


def test_benchmark_rebaseline_and_empty_run_guard(tmp_path, monkeypatch):
    """--rebaseline accepts a regressed run as the new baseline (the record
    keeps the re-baselined cells); a run that measured no cell never
    clobbers a baseline."""
    monkeypatch.setenv("TIPC_ASSUME_CORES", "8")
    cfg, data = _bench_txt(tmp_path, rows=128, batches="32", devices="1")
    out = tmp_path / "out"
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out), device="cpu")
    rec_path = out / "benchmark_train_dnn.cpu.json"
    rec = json.load(open(rec_path))
    inflated = dict(rec, results=[dict(r, ips=r["ips"] * 100.0) for r in rec["results"]])
    rec_path.write_text(json.dumps(inflated))
    assert port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out),
                                   rebaseline=True, device="cpu")
    new = json.load(open(rec_path))
    assert new["rebaselined"] and not new["regressions"]
    assert new["results"][0]["ips"] < inflated["results"][0]["ips"]
    cfg.write_text(cfg.read_text().replace(str(data), str(data) + "_gone"))
    before = rec_path.read_text()
    assert not port_tipc.run_benchmark(str(cfg), str(out), record_dir=str(out),
                                       device="cpu")
    assert rec_path.read_text() == before


def test_tipc_cli_and_fixture(tmp_path, monkeypatch):
    """The CLI on the repo's dnn parameter file (read only) over the port's
    own criteo fixture, from a working directory of its own."""
    monkeypatch.chdir(tmp_path)
    port_tipc.write_criteo_fixture()
    assert len(os.listdir(tmp_path / "test_tipc" / "data" / "train")) == 2
    txt = os.path.join(REPO, "test_tipc", "configs", "dnn", "train_infer_python.txt")
    assert port_tipc.main([txt, "lite_train_lite_infer", "--device", "cpu"]) == 0
    log = tmp_path / "test_tipc" / "output" / "results_python_lite_train_lite_infer.log"
    assert log.read_text().count("Run successfully") == 3


def test_infer_benchmark_reports_the_device():
    bench = InferBenchmark(model_info={"model": "dnn"}, data_info={"batch": 4},
                           device="cpu")
    x = torch.ones(4, 4)
    bench.time_fn(lambda b: b @ x, [x] * 6, warmup=2)
    rep = bench("dnn")
    assert rep["env"]["device"] == "cpu" and rep["env"]["process_count"] == 1
    assert rep["perf"]["count"] == 6 and rep["perf"]["qps"] > 0
    assert rep["perf"]["p50_ms"] <= rep["perf"]["max_ms"]
    assert InferBenchmark(device="cpu").stats() == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferBenchmark()
