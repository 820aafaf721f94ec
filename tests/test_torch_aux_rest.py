"""The port's observability and auxiliary modules against the JAX package's:
``dump_fields`` from ``evaluate()`` with ``utils/onoff_diff.py``,
``profiler_options`` (``utils/profiler.py``), ``use_visual``
(``utils/visual.py``), the external sources (``data/external.py``) and the
filesystem routing (``utils/fs.py``); and ``check_ported``, which no longer
refuses the keys these modules serve."""

import json
import os
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.data import external as jax_external
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu.utils import onoff_diff as jax_onoff
from paddlerec_tpu.utils import profiler as jax_profiler
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.data import external as port_external
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from paddlerec_tpu_torch.utils import fs as port_fs
from paddlerec_tpu_torch.utils import onoff_diff as port_onoff
from paddlerec_tpu_torch.utils import profiler as port_profiler
from paddlerec_tpu_torch.utils.visual import ScalarWriter

torch.set_num_threads(1)


def _flat(tmp_path, **extra):
    flat = {
        "runner.model": "rank.dnn",
        "runner.train_data_dir": str(tmp_path / "train"),
        "runner.test_data_dir": str(tmp_path / "train"),
        "runner.train_batch_size": 16,
        "runner.infer_batch_size": 16,
        "runner.epochs": 1,
        "runner.print_interval": 2,
        "runner.seed": 0,
        "hyper_parameters.sparse_inputs_slots": 27,
        "hyper_parameters.dense_input_dim": 13,
        "hyper_parameters.sparse_feature_number": 5000,
        "hyper_parameters.sparse_feature_dim": 8,
        "hyper_parameters.fc_sizes": [32, 16],
        "hyper_parameters.optimizer.class": "Adam",
        "hyper_parameters.optimizer.learning_rate": 0.001,
    }
    flat.update(extra)
    return flat


def _pair(flat):
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


@pytest.mark.parametrize("fields", [["predictions"], "[predictions,labels]"])
def test_dump_fields_against_the_jax_trainer(tmp_path, fields):
    """70 rows at batch 16: four whole batches and a padded one whose masked
    rows are skipped.  The port's JSONL holds JAX's instances and vars,
    within 1e-6 through both packages' ``diff_report``."""
    write_criteo_sample(str(tmp_path / "train"), num_lines=70, num_files=1, vocab=5000)
    dumps = {}
    for name in ("jax", "port"):
        dumps[name] = str(tmp_path / f"{name}.jsonl")
    ref, port = _pair(_flat(tmp_path, **{"runner.dump_fields": fields,
                                         "runner.dump_fields_path": dumps["jax"]}))
    ref.evaluate()
    port.config["runner.dump_fields_path"] = dumps["port"]
    port.evaluate()
    recs = [json.loads(line) for line in open(dumps["port"])]
    want = [json.loads(line) for line in open(dumps["jax"])]
    assert len(recs) == len(want) == 70
    assert [r["ins_id"] for r in recs] == [r["ins_id"] for r in want]
    assert recs[-1]["ins_id"] == "4_5"
    assert [sorted(r["vars"]) for r in recs] == [sorted(r["vars"]) for r in want]
    for diff_report in (jax_onoff.diff_report, port_onoff.diff_report):
        rep = diff_report(dumps["port"], dumps["jax"], 1e-6)
        assert rep["consistent"] and rep["num_shared"] == 70, rep
        assert all(v["max_diff"] <= 1e-6 for v in rep["per_var"].values())


def test_onoff_diff_reports_as_the_jax_package(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    rng = np.random.RandomState(0)
    with open(a, "w") as fa, open(b, "w") as fb:
        for i in range(20):
            x = rng.rand(3).tolist()
            y = [v + (1e-3 if i % 7 == 0 else 0.0) for v in x]
            fa.write(json.dumps({"ins_id": str(i), "vars": {"p": x, "q": [i]}}) + "\n")
            if i != 5:
                fb.write(json.dumps({"ins_id": str(i), "vars": {"p": y}}) + "\n")
    for t in (1e-5, 1e-2):
        assert port_onoff.diff_report(str(a), str(b), t) == jax_onoff.diff_report(
            str(a), str(b), t)
    assert port_onoff.main([str(a), str(b)]) == jax_onoff.main([str(a), str(b)]) == 1
    assert port_onoff.main([str(a), str(a)]) == 0
    assert port_onoff.main([]) == 2


@pytest.mark.parametrize("options", [
    "batch_range=[5, 9]; profile_path=/tmp/x; exit_on_finished=false",
    "batch_range=[9,5]",
    "batch_range=[0,1];state=GPU;tracer_option=OpDetail;sorted_key=calls",
    "exit_on_finished=yes;unknown=1;;",
    "",
])
def test_profiler_options_parse_as_the_jax_package(options):
    port, ref = port_profiler.ProfilerOptions(options), jax_profiler.ProfilerOptions(options)
    if "profile_path" not in options:  # the default lives under $TMPDIR in the port
        assert port["profile_path"] == os.path.join(tempfile.gettempdir(),
                                                    "paddlerec_tpu_profile")
        port._options["profile_path"] = ref["profile_path"]
    assert port._options == ref._options


def test_profiler_traces_the_batch_range(tmp_path):
    port_profiler.reset()
    opts = f"batch_range=[1,3];profile_path={tmp_path};exit_on_finished=false"
    for _ in range(5):
        port_profiler.add_profiler_step(opts)
        torch.ones(8, 8) @ torch.ones(8, 8)
    port_profiler.reset()
    trace = tmp_path / "trace_1_3.json"
    events = json.load(open(trace))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    # exit_on_finished leaves the process as the JAX hook does
    port_profiler.reset()
    with pytest.raises(SystemExit):
        for _ in range(3):
            port_profiler.add_profiler_step(f"batch_range=[0,1];profile_path={tmp_path}")
    port_profiler.reset()


def test_trainer_profiler_options_and_visual_against_the_jax_trainer(tmp_path):
    """``train()`` with ``profiler_options`` writes a trace of its batch
    range, and ``use_visual`` the scalars of the JAX trainer: the same tags
    and steps."""
    write_criteo_sample(str(tmp_path / "train"), num_lines=96, num_files=1, vocab=5000)
    port_profiler.reset()
    jax_profiler.reset()
    visual = {}
    for name in ("jax", "port"):
        visual[name] = tmp_path / f"visual_{name}"
    flat = _flat(tmp_path, **{"runner.use_visual": True,
                              "runner.train_visual_path": str(visual["jax"])})
    ref, port = _pair(flat)
    ref.train()
    port.config["runner.train_visual_path"] = str(visual["port"])
    port.config["runner.profiler_options"] = (
        f"batch_range=[1,4];profile_path={tmp_path / 'prof'};exit_on_finished=false")
    port.train()
    port_profiler.reset()
    assert (tmp_path / "prof" / "trace_1_4.json").exists()
    got = [json.loads(line) for line in open(visual["port"] / "scalars.jsonl")]
    want = [json.loads(line) for line in open(visual["jax"] / "scalars.jsonl")]
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert [r["tag"] for r in got[:2]] == ["train/loss", "train/ips"]
    assert len(got) == 2 * (96 // 16 // 2)
    losses = [r["value"] for r in got if r["tag"] == "train/loss"]
    np.testing.assert_allclose(
        losses, [r["value"] for r in want if r["tag"] == "train/loss"], rtol=0, atol=1e-5)


def test_scalar_writer_appends_records(tmp_path):
    w = ScalarWriter(str(tmp_path / "v"))
    w.add_scalars({"a": 1.0, "b": 2}, 3)
    w.close()
    w = ScalarWriter(str(tmp_path / "v"))
    w.add_scalar("a", 0.5, 4)
    w.close()
    recs = [json.loads(line) for line in open(tmp_path / "v" / "scalars.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in recs] == [
        ("a", 1.0, 3), ("b", 2.0, 3), ("a", 0.5, 4)]


def test_tfrecord_round_trip_across_packages(tmp_path):
    recs = [b"hello", b"", b"x" * 1000]
    port_external.write_tfrecord(str(tmp_path / "port.tfrecord"), recs)
    jax_external.write_tfrecord(str(tmp_path / "jax.tfrecord"), recs)
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()
    assert list(port_external.TFRecordSource([str(tmp_path / "jax.tfrecord")])) == recs
    assert list(jax_external.TFRecordSource([str(tmp_path / "port.tfrecord")])) == recs
    truncated = tmp_path / "cut.tfrecord"
    truncated.write_bytes((tmp_path / "port.tfrecord").read_bytes()[:-600])
    assert list(port_external.TFRecordSource([str(truncated)])) == recs[:2]


def test_file_line_source_and_gated_clients(tmp_path, monkeypatch):
    p = tmp_path / "a.txt"
    p.write_text("one\ntwo\n")
    q = tmp_path / "b.txt"
    q.write_text("three")
    assert list(port_external.FileLineSource([str(p), str(q)])) == ["one", "two", "three"]
    with pytest.raises(RuntimeError, match="confluent_kafka"):
        port_external.KafkaLineSource("localhost:9092", "g", ["t"])
    with pytest.raises(RuntimeError, match="pyodps"):
        port_external.OdpsTableSource("id", "key", "proj", "http://e", "t")
    # gs:// without google-cloud-storage: the gated import's error (the
    # client is never built here, so nothing looks for credentials)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    with pytest.raises(RuntimeError, match="google-cloud-storage is not installed"):
        port_fs.get_fs("gs://bucket/path")


def test_local_fs_and_scheme_routing(tmp_path):
    fs = port_fs.get_fs(str(tmp_path))
    assert isinstance(fs, port_fs.LocalFS)
    with fs.open(str(tmp_path / "a/b.txt"), "w") as f:
        f.write("hi")
    assert fs.exists(str(tmp_path / "a/b.txt")) and fs.isdir(str(tmp_path / "a"))
    fs.upload(str(tmp_path / "a/b.txt"), str(tmp_path / "c.txt"))
    fs.upload(str(tmp_path / "c.txt"), str(tmp_path / "c.txt"))  # onto itself: no-op
    assert fs.ls(str(tmp_path)) == [str(tmp_path / "a"), str(tmp_path / "c.txt")]
    assert fs.ls(str(tmp_path / "*.txt")) == [str(tmp_path / "c.txt")]
    fs.download(str(tmp_path / "a"), str(tmp_path / "copy"))
    assert fs.read_text(str(tmp_path / "copy" / "b.txt")) == "hi"
    fs.append_line(str(tmp_path / "d" / "done.txt"), "x")
    fs.append_line(str(tmp_path / "d" / "done.txt"), "y")
    assert fs.read_text(str(tmp_path / "d" / "done.txt")) == "x\ny\n"
    fs.rm(str(tmp_path / "c.txt"))
    fs.rm(str(tmp_path / "copy"))
    assert not fs.exists(str(tmp_path / "c.txt")) and not fs.exists(str(tmp_path / "copy"))
    for url in ("hdfs://cluster/path", "afs://cluster/path"):
        with pytest.raises(RuntimeError, match="gs://"):
            port_fs.get_fs(url)


@pytest.mark.parametrize("key,value", [
    ("runner.use_host_table", True), ("runner.feed_device_resident", True),
    ("runner.use_visual", True), ("runner.profiler_options", "batch_range=[2,4]"),
    ("runner.dump_fields", ["predictions"]), ("runner.pipe_command", "cat"),
])
def test_check_ported_accepts_the_keys_this_slice_ports(tmp_path, key, value):
    port_trainer_mod.check_ported(Config(_flat(tmp_path, **{key: value})))
    port_trainer_mod.Trainer(Config(_flat(tmp_path, **{key: value})), device="cpu")
