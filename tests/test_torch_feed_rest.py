"""The rest of the port's feed against the JAX package: the native slot-text
reader (``native/reader.py`` over the port's build of
``native/fast_reader.cpp``), ``reader_type: native`` in ``make_dataset``,
the ``pipe_command`` stage with the built ``criteo_parser``, the
text → slotbin converter (``tools/dataset_convert.py``, byte-identical
output), and ``runner.feed_device_resident`` (staged superbatches kept on
the device and replayed, per-step losses against the JAX trainer's).  The
JAX package's readers run here over the port's builds of the same unedited
sources (``build/native/``), so that these tests never compile into
``native/build/`` while the JAX package's own tests may be building there."""

import glob
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.data import slot_reader as jax_slot_reader
from paddlerec_tpu.native import reader as jax_native
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.tools import dataset_convert as jax_convert
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.data import slot_reader as port_slot_reader
from paddlerec_tpu_torch.data.binary import BinarySlotDataset
from paddlerec_tpu_torch.data.schema import SlotSchema
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.native import build_criteo_parser, fastreader
from paddlerec_tpu_torch.native import reader as port_native
from paddlerec_tpu_torch.tools import dataset_convert as port_convert
from paddlerec_tpu_torch.train import trainer as port_trainer_mod

torch.set_num_threads(1)

SCHEMA = SlotSchema.criteo(26, 13)


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("trailing_newline", [True, False])
def test_native_reader_is_bitwise_the_jax_packages_and_the_python_readers(
        tmp_path, monkeypatch, trailing_newline):
    monkeypatch.setattr(jax_native, "fastreader", fastreader)
    write_criteo_sample(str(tmp_path), num_lines=150, num_files=2, vocab=10**9, seed=3)
    files = sorted(glob.glob(str(tmp_path / "part-*")))
    if not trailing_newline:
        for f in files:
            text = open(f).read()
            assert text.endswith("\n")
            open(f, "w").write(text.rstrip("\n"))
    for drop_last in (False, True):
        port = list(port_native.NativeSlotDataset(files, 26, 13, 32, drop_last=drop_last,
                                                  num_threads=3))
        _same_batches(port, list(jax_native.NativeSlotDataset(
            files, 26, 13, 32, drop_last=drop_last, num_threads=3)))
        _same_batches(port, list(port_slot_reader.SlotDataset(
            files, SCHEMA, 32, drop_last=drop_last)))
    assert port[-1]["mask"].sum() == 32  # 150 rows: 4 whole batches, 22 dropped
    labels, sparse, dense = port_native.parse_file(files[0], 26, 13, num_threads=2)
    assert labels.shape == (75,) and sparse.shape == (75, 26) and dense.shape == (75, 13)


def test_parse_buffer_and_count_lines(tmp_path):
    import ctypes

    lib = fastreader()
    text = b"click:1 dense_feature:0.5 1:7 2:9\nclick:0 dense_feature:0.25 1:3 2:4\n"
    path = tmp_path / "t.txt"
    path.write_bytes(text)
    assert lib.frd_count_lines(str(path).encode()) == 2
    labels = np.zeros(2, np.int64)
    sparse = np.zeros((2, 2), np.int64)
    dense = np.zeros((2, 1), np.float32)
    n = lib.frd_parse_buffer(
        text, len(text), 2, 1, 2, 2,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    assert n == 2
    assert labels.tolist() == [1, 0] and sparse.tolist() == [[7, 9], [3, 4]]
    assert dense.ravel().tolist() == [0.5, 0.25]
    so = os.path.realpath(lib._name)
    assert os.sep + os.path.join("build", "native") + os.sep in so
    assert os.sep + os.path.join("native", "build") + os.sep not in so


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _small(tmp_path, **extra):
    flat = {
        "runner.model": "rank.dnn",
        "runner.train_data_dir": str(tmp_path / "train"),
        "runner.test_data_dir": str(tmp_path / "train"),
        "runner.train_batch_size": 16,
        "runner.infer_batch_size": 16,
        "runner.epochs": 3,
        "runner.print_interval": 1000,
        "runner.wire_format": "compact",
        "runner.feed_superbatch": 2,
        "runner.feed_device_resident": True,
        "hyper_parameters.sparse_inputs_slots": 27,
        "hyper_parameters.dense_input_dim": 13,
        "hyper_parameters.sparse_feature_number": 1000,
        "hyper_parameters.sparse_feature_dim": 8,
        "hyper_parameters.fc_sizes": [16],
    }
    flat.update(extra)
    return flat


def test_make_dataset_reads_native_with_no_fallback(tmp_path):
    write_criteo_sample(str(tmp_path / "train"), num_lines=96, num_files=2, vocab=1000)
    rec = _Records()
    port_trainer_mod.logger.addHandler(rec)
    try:
        trainer = port_trainer_mod.Trainer(Config(_small(
            tmp_path, **{"runner.reader_type": "native", "runner.reader_threads": 2})),
            device="cpu")
        ds = trainer.make_dataset(str(tmp_path / "train"), 16)
    finally:
        port_trainer_mod.logger.removeHandler(rec)
    assert isinstance(ds, port_native.NativeSlotDataset)
    assert ds.num_threads == 2 and (ds.num_sparse, ds.dense_dim) == (26, 13)
    assert not any("falling back" in m for m in rec.messages), rec.messages
    plain = port_trainer_mod.Trainer(Config(_small(tmp_path)), device="cpu")
    _same_batches(list(ds), list(plain.make_dataset(str(tmp_path / "train"), 16)))


def _raw_criteo(path, rows, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        ints = [str(rng.randint(0, 50)) if rng.rand() > 0.1 else "" for _ in range(13)]
        cats = [f"{rng.randint(0, 1 << 32):08x}" if rng.rand() > 0.1 else ""
                for _ in range(26)]
        lines.append("\t".join([str(rng.randint(0, 2))] + ints + cats))
    path.write_text("\n".join(lines) + "\n")


def test_pipe_command_criteo_parser_matches_the_jax_reader(tmp_path):
    _raw_criteo(tmp_path / "day0", 70, seed=1)
    _raw_criteo(tmp_path / "day1", 50, seed=2)
    files = [str(tmp_path / "day0"), str(tmp_path / "day1")]
    binary = build_criteo_parser()
    assert os.access(binary, os.X_OK)
    from paddlerec_tpu.data.schema import SlotSchema as JaxSchema

    want = list(jax_slot_reader.SlotDataset(
        files, JaxSchema.criteo(26, 13), 32, pipe_command=binary))
    got = list(port_slot_reader.SlotDataset(files, SCHEMA, 32, pipe_command=binary))
    _same_batches(got, want)
    assert got[-1]["mask"].sum() == 120 - 96
    # make_dataset passes runner.pipe_command through
    (tmp_path / "train").mkdir()
    for f in files:
        os.rename(f, str(tmp_path / "train" / os.path.basename(f)))
    trainer = port_trainer_mod.Trainer(Config(_small(
        tmp_path, **{"runner.pipe_command": binary})), device="cpu")
    ds = trainer.make_dataset(str(tmp_path / "train"), 32, drop_last=False)
    assert ds.pipe_command == binary
    _same_batches(list(ds), want)


def test_pipe_command_awk_stage_and_a_failing_command(tmp_path):
    raw = tmp_path / "raw.csv"
    raw.write_text("1,10,20\n0,30,40\n1,50,60\n0,70,80\n")
    cmd = "awk -F, '{print \"click:\" $1, \"1:\" $2, \"2:\" $3}'"
    schema = SlotSchema(label_slot="click", sparse_slots=["1", "2"])
    batches = list(port_slot_reader.SlotDataset([str(raw)], schema, 2, pipe_command=cmd))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["label"], [1, 0])
    np.testing.assert_array_equal(batches[1]["sparse"][:, 1], [60, 80])
    # a failing pipe surfaces, not silently truncates
    with pytest.raises(RuntimeError, match="pipe_command 'false' failed with exit code 1"):
        list(port_slot_reader.SlotDataset([str(raw)], schema, 2, pipe_command="false"))
    # an abandoned epoch reaps its child
    it = iter(port_slot_reader.SlotDataset([str(raw)], schema, 1, pipe_command=cmd))
    next(it)
    it.close()


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataset_convert_is_byte_identical_to_the_jax_tools(tmp_path, monkeypatch, shuffle):
    monkeypatch.setattr(jax_native, "fastreader", fastreader)
    data = tmp_path / "train"
    write_criteo_sample(str(data), num_lines=300, num_files=3, vocab=5000, seed=4)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("runner:\n  model: rank.dnn\nhyper_parameters:\n"
                   "  sparse_inputs_slots: 27\n  dense_input_dim: 13\n"
                   "  sparse_feature_number: 5000\n")
    flags = ["--shuffle"] if shuffle else []
    common = ["-m", str(cfg), "--data_dir", str(data), "--workers", "1", "--threads", "2"]
    assert jax_convert.main(common + ["--out_suffix", "_jax"] + flags) == 0
    assert port_convert.main(common + ["--out_suffix", "_port"] + flags) == 0
    names = sorted(os.listdir(tmp_path / "train_jax"))
    assert names == sorted(os.listdir(tmp_path / "train_port")) == [
        "part-0.bin", "part-1.bin", "part-2.bin"]
    for n in names:
        a = (tmp_path / "train_jax" / n).read_bytes()
        assert a == (tmp_path / "train_port" / n).read_bytes(), n
    files = sorted(glob.glob(str(tmp_path / "train_port" / "*.bin")))
    back = list(BinarySlotDataset(files, 100, drop_last=True))
    text = list(port_slot_reader.SlotDataset(sorted(glob.glob(str(data / "part-*"))),
                                             SCHEMA, 100, drop_last=True))
    assert len(back) == len(text) == 3
    for x, y in zip(back, text):  # a file a batch: the same rows, shuffled or not
        rows_x = np.column_stack([np.asarray(x["label"]), np.asarray(x["sparse"])])
        rows_y = np.column_stack([y["label"], y["sparse"]])
        if shuffle:
            assert not np.array_equal(rows_x, rows_y)
            rows_x, rows_y = (r[np.lexsort(r.T[::-1])] for r in (rows_x, rows_y))
        np.testing.assert_array_equal(rows_x, rows_y)


# -- the device-resident feed --------------------------------------------------

class _Counting:
    """Counts the calls of a module function while patched in."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _jax_pair(tmp_path, **extra):
    flat = _small(tmp_path, **extra)
    ref = jax_trainer_mod.Trainer(JaxConfig(flat), mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state()
    port = port_trainer_mod.Trainer(Config(flat), device="cpu")
    port.init_state()
    port.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


def test_resident_losses_match_the_jax_trainer_over_two_epochs(tmp_path):
    """Epoch 0 stages, epoch 1 replays in ``RandomState(1).permutation``
    order: every step's loss within 1e-5 of the JAX trainer's, which holds
    the replay order too."""
    write_criteo_sample(str(tmp_path / "train"), num_lines=160, num_files=2, vocab=1000)
    ref, port = _jax_pair(tmp_path, **{"runner.epochs": 2})
    ref._train_step = ref._build_train_step()
    jax_super, ref_losses = ref._train_step_super, []

    def jax_step(*args):
        out = jax_super(*args)
        ref_losses.append(float(out[2]))
        return out

    ref._train_step_super = jax_step
    port_super, port_losses = port.super_step, []

    def torch_step(*args):
        out = port_super(*args)
        port_losses.append(float(out[1]))
        return out

    port.super_step = torch_step
    m_ref, m_port = ref.train(), port.train()
    assert len(port_losses) == len(ref_losses) == 20
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert abs(m_port["auc"] - m_ref["auc"]) < 1e-4
    (key,) = [k for k in port._resident if k.startswith("train:")]
    assert key == [k for k in ref._resident if k.startswith("train:")][0]
    assert port._resident[key]["replays"] == 1 and len(port._resident[key]["sbs"]) == 5


def test_resident_epochs_read_no_file_and_stage_nothing(tmp_path, monkeypatch):
    write_criteo_sample(str(tmp_path / "train"), num_lines=96, num_files=2, vocab=1000)
    staged = _Counting(port_trainer_mod.to_tensors)
    monkeypatch.setattr(port_trainer_mod, "to_tensors", staged)
    reads = _Counting(port_slot_reader.SlotDataset._iter_lines)
    monkeypatch.setattr(port_slot_reader.SlotDataset, "_iter_lines",
                        lambda self: reads(self))
    trainer = port_trainer_mod.Trainer(Config(_small(tmp_path, **{"runner.epochs": 1})),
                                       device="cpu")
    trainer.train()
    # 96 rows / batch 16 = 6 batches: 3 superbatches of K=2, each staged once
    assert (reads.calls, staged.calls) == (1, 3)
    trainer.config["runner.epochs"] = 3  # three more epochs, all replayed
    m = trainer.train()
    assert m["auc"] > 0
    (ent,) = trainer._resident.values()
    assert len(ent["sbs"]) == 3 and ent["replays"] == 3 and ent["bytes"] > 0
    assert (reads.calls, staged.calls) == (1, 3)  # epochs after the first: nothing


def test_resident_eval_identical_to_streaming(tmp_path):
    write_criteo_sample(str(tmp_path / "train"), num_lines=96, num_files=2, vocab=1000)
    trainer = port_trainer_mod.Trainer(Config(_small(tmp_path, **{"runner.epochs": 1})),
                                       device="cpu")
    trainer.init_state()
    ev1 = trainer.evaluate()  # stages and keeps
    assert any(k.startswith("eval:") for k in trainer._resident)
    ev2 = trainer.evaluate()  # replays from the device
    streaming = port_trainer_mod.Trainer(Config(_small(
        tmp_path, **{"runner.epochs": 1, "runner.feed_device_resident": False})),
        device="cpu")
    streaming.init_state()
    streaming.state.module.load_state_dict(trainer.state.module.state_dict())
    ev3 = streaming.evaluate()
    assert not streaming._resident
    for k in ("auc", "total_ins", "mae", "rmse", "predicted_ctr"):
        assert ev1[k] == ev2[k] == ev3[k], k


def test_resident_streams_over_the_cap_and_restages_on_change(tmp_path):
    data = str(tmp_path / "train")
    write_criteo_sample(data, num_lines=96, num_files=2, vocab=1000)
    over = port_trainer_mod.Trainer(Config(_small(
        tmp_path, **{"runner.resident_max_gb": 1e-9})), device="cpu")
    assert over.train()["auc"] > 0
    (ent,) = [v for k, v in over._resident.items() if k.startswith("train:")]
    assert ent["sbs"] is None  # spilled: streaming fallback

    trainer = port_trainer_mod.Trainer(Config(_small(tmp_path, **{"runner.epochs": 1})),
                                       device="cpu")
    trainer.train()
    keys1 = [k for k in trainer._resident if k.startswith("train:")]
    write_criteo_sample(data, num_lines=96, num_files=2, vocab=1000, seed=99)
    f0 = sorted(os.listdir(data))[0]
    now = time.time() + 2
    os.utime(os.path.join(data, f0), (now, now))
    trainer.train()
    keys2 = [k for k in trainer._resident if k.startswith("train:")]
    assert len(keys1) == len(keys2) == 1 and keys1 != keys2  # restaged, old dropped


def test_resident_off_by_default(tmp_path):
    write_criteo_sample(str(tmp_path / "train"), num_lines=64, num_files=1, vocab=1000)
    trainer = port_trainer_mod.Trainer(Config(_small(
        tmp_path, **{"runner.feed_device_resident": False, "runner.epochs": 1})),
        device="cpu")
    trainer.train()
    assert not trainer._resident
