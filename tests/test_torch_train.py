"""The training slice of the port as a whole against the JAX trainer: both
packages built from one config, the same parameters copied in, the same 20
batches; then the trainer loop, the CLIs, the checkpoint and the keys that
are not ported."""

import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.data.synthetic import write_criteo_sample
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch.convert import adam_state_from_optax, from_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.data.binary import write_slotbin
from paddlerec_tpu_torch.data.superbatch import stack_superbatches
from paddlerec_tpu_torch.data.wire import WireEncoder
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.conftest import small_config

torch.set_num_threads(1)

CPU = torch.device("cpu")
VOCAB, BATCH, STEPS = 5000, 64, 20
SMALL = {
    "hyper_parameters.sparse_feature_number": VOCAB,
    "hyper_parameters.sparse_feature_dim": 9,
    "hyper_parameters.fc_sizes": [32, 16],
    "runner.train_batch_size": BATCH,
    "runner.infer_batch_size": BATCH,
}


def _batches(seed, steps=STEPS, rows=BATCH):
    """Hashed ids beyond the vocab, a planted signal, a few masked rows."""
    rng = np.random.RandomState(seed)
    weight = rng.randn(3 * VOCAB)
    out = []
    for _ in range(steps):
        sparse = rng.randint(0, 3 * VOCAB, (rows, 26)).astype(np.int64)
        dense = rng.rand(rows, 13).astype(np.float32)
        score = weight[sparse].mean(axis=1) * 6 + dense.mean(axis=1) - 0.5
        label = (rng.rand(rows) < 1 / (1 + np.exp(-score))).astype(np.float32)
        mask = (rng.rand(rows) < 0.95).astype(np.float32)
        out.append({"label": label, "sparse": sparse, "dense": dense, "mask": mask})
    return out


def _pair(tmp_path, **extra):
    cfg = small_config(tmp_path, **{**SMALL, **extra})
    ref = jax_trainer_mod.Trainer(cfg, mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(cfg.to_dict()), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


# table dtype → (loss atol, atol of the float32 parameters).  f32: sums in
# another order, and Adam's m / sqrt(v) keeps a relative error of the
# gradient, so 1e-5 on parameters that move 1e-3 a step (measured: loss
# 1.2e-7, parameters 3.4e-6).  bf16 table: the tower, the head and
# ``dense_w`` stay float32 and are held almost as tightly (measured 9.7e-6 on
# ``tower.fc_0.weight``, which reads the bf16 rows; 1.5e-6 elsewhere); the
# looked-up rows and their gradients are bf16 on both sides (measured after
# 20 steps: loss 1.5e-5, first moment 1.1e-5, second moment 1.5e-8).
TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 3e-5)}
# The bf16 table itself: a gradient can differ by a bf16 ulp between the two
# packages; where that gradient is near zero Adam's m / sqrt(v) turns it into
# a step of another size, up to lr = 1e-3 a step, so single elements may be
# off by 4e-3 (measured 1.9e-3).  Those are few: of 80,000 elements 45 differ
# by more than 1e-4 and 614 by more than 1e-5.  An Adam step wrong by a few
# percent would move most of the table by more than that.
BF16_TABLE = {"atol": 4e-3, "share_beyond": {1e-4: 1.5e-3, 1e-5: 1.5e-2}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twenty_steps_match_the_jax_trainer(tmp_path, dtype):
    ref, port = _pair(tmp_path, **{"hyper_parameters.sparse_feature_dtype": dtype})
    loss_atol, param_atol = TOLERANCE[dtype]
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for batch in _batches(1):
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(batch), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=loss_atol)
    assert np.all(np.isfinite(port_losses))
    assert port.state.step == int(ref.state.step) == STEPS

    want = from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if v.dtype == torch.bfloat16:
            assert k == "embedding.embedding"
            diff = (got[k].float() - v.float()).abs()
            assert float(diff.max()) <= BF16_TABLE["atol"]
            for beyond, share in BF16_TABLE["share_beyond"].items():
                assert float((diff > beyond).float().mean()) <= share, beyond
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   rtol=0, atol=param_atol, err_msg=k)
    assert got["embedding.embedding"].dtype == getattr(torch, dtype)

    adam = adam_state_from_optax(jax.device_get(ref.state.opt_state))
    assert port.state.opt_state["count"] == adam["count"] == STEPS
    for k in want:
        mu, nu = port.state.opt_state["mu"][k], port.state.opt_state["nu"][k]
        assert mu.dtype == adam["mu"][k].dtype == torch.float32, k
        assert nu.dtype == adam["nu"][k].dtype == want[k].dtype, k
        # moments are sums of gradients of size <= 1e-2: absolute tolerances
        np.testing.assert_allclose(mu.numpy(), adam["mu"][k].numpy(), rtol=0,
                                   atol=1e-6 if dtype == "float32" else 5e-5, err_msg=k)
        np.testing.assert_allclose(nu.float().numpy(), adam["nu"][k].float().numpy(),
                                   rtol=0, atol=1e-7 if dtype == "float32" else 1e-6,
                                   err_msg=k)

    ref_bundle = ref._compute_metrics(ref_ms)
    port_bundle = port._compute_metrics(port_ms)
    if dtype == "float32":
        for k in ("stat_pos", "stat_neg"):
            np.testing.assert_array_equal(port_ms["auc"][k].numpy(),
                                          np.asarray(ref_ms["auc"][k]))
        for k, v in ref_bundle.items():
            assert abs(port_bundle[k] - v) < 1e-6, k
        assert port._bundle_str(port_bundle, "train") == ref._bundle_str(ref_bundle, "train")
    else:  # a prediction may cross a bucket's edge: counts move to a neighbour
        assert port_bundle["total_ins"] == ref_bundle["total_ins"]
        assert abs(port_bundle["auc"] - ref_bundle["auc"]) < 1e-3  # measured 1.3e-5
        assert abs(port_bundle["mae"] - ref_bundle["mae"]) < 1e-4  # measured 3e-7


def test_superbatch_steps_equal_plain_steps(tmp_path):
    """The same wire-encoded batches, one at a time and as staged
    superbatches indexed on the device: bitwise the same run."""
    cfg = Config(small_config(tmp_path, **SMALL).to_dict())
    enc = WireEncoder(VOCAB)
    encoded = [enc(b) for b in _batches(2, steps=6)]
    runs = []
    for staged in (False, True):
        trainer = port_trainer_mod.Trainer(cfg, device="cpu")
        trainer.init_state(seed=3)
        ms, losses = trainer._init_metric_state(), []
        if staged:
            for sb in stack_superbatches(iter(encoded), 4):
                sb = to_tensors(sb, CPU)
                assert sb["sparse"].dtype == torch.uint8
                for i in range(sb["label"].shape[0]):
                    ms, loss = trainer.super_step(sb, i, ms)
                    losses.append(float(loss))
        else:
            for b in encoded:
                ms, loss = trainer.train_step(to_tensors(b, CPU), ms)
                losses.append(float(loss))
        runs.append((losses, trainer.state.module.state_dict(), ms))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 6
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    assert torch.equal(runs[0][2]["auc"]["stat_pos"], runs[1][2]["auc"]["stat_pos"])


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _captured(logger, fn):
    handler = _Capture()
    logger.addHandler(handler)
    try:
        result = fn()
    finally:
        logger.removeHandler(handler)
    return result, handler.lines


NUM = r"-?\d+\.\d+"
BUNDLE = (rf"AUC={NUM} BUCKET_ERROR={NUM} MAE={NUM} RMSE={NUM} Actual_CTR={NUM} "
          rf"Predicted_CTR={NUM} COPC={NUM} MEAN Q_VALUE={NUM} Ins number=\d+")
STEP_LINE = re.compile(
    rf"^epoch: \d+, batch_id: \d+, auc: {NUM}, loss: {NUM}, avg_reader_cost: {NUM} sec, "
    rf"avg_batch_cost: {NUM} sec, avg_samples: {NUM}, ips: {NUM} ins/s$")
EPOCH_LINE = re.compile(
    rf"^epoch: \d+ done, train {BUNDLE}, epoch time: {NUM} s, ips: {NUM} ins/s$")
INFER_STEP_LINE = re.compile(rf"^infer batch_id: \d+, auc: {NUM}, $")
INFER_LINE = re.compile(rf"^infer {BUNDLE}, infer time: {NUM} s, ips: {NUM} ins/s$")


def _count(lines, pattern):
    return sum(1 for line in lines if pattern.match(line))


def test_cli_trains_logs_saves_and_evaluates(tmp_path):
    """``tools.train`` then ``tools.infer`` with ``--device cpu`` on Criteo
    sample text; the JAX trainer's own lines pass the same patterns."""
    data = str(tmp_path / "train")
    write_criteo_sample(data, num_lines=256, num_files=2, vocab=VOCAB, seed=7)
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "rank", "deepfm", "config.yaml")
    save = str(tmp_path / "out")
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1",
            f"hyper_parameters.sparse_feature_number={VOCAB}",
            "hyper_parameters.fc_sizes=[32,16]"]
    metrics, lines = _captured(
        port_trainer_mod.logger,
        lambda: port_train.main(["-m", config, "--device", "cpu", "-o", *opts]))
    assert _count(lines, STEP_LINE) == 8  # 2 epochs x 8 batches of 32, every 2nd
    assert _count(lines, EPOCH_LINE) == 2
    assert np.isfinite(metrics["auc"]) and metrics["ips"] > 0
    assert metrics["total_ins"] == 256

    for epoch in (0, 1):
        assert os.path.isfile(os.path.join(save, str(epoch), "state", "checkpoint.pt"))
    with open(os.path.join(save, "donefile.txt")) as f:
        done = f.read().splitlines()
    assert done == [f"0\t{os.path.join(save, '0')}", f"1\t{os.path.join(save, '1')}"]
    assert port_ckpt.last_saved_tag(save) == "1"
    params, opt_state, extra = port_ckpt.load_model(save, 1)
    assert extra is None  # row-wise side state: sparse runs only
    assert opt_state["count"] == 16 and sorted(opt_state) == ["count", "mu", "nu"]
    assert sorted(port_ckpt.load_params_from_state(save, 0)) == sorted(params)

    results, lines = _captured(
        port_trainer_mod.logger,
        lambda: port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                                 "runner.infer_end_epoch=2"]))
    assert sorted(results) == [0, 1] and _count(lines, INFER_LINE) == 2
    assert _count(lines, INFER_STEP_LINE) == 8
    assert results[1]["auc"] > results[0]["auc"] > 0.5  # it learned the sample
    assert results[1]["total_ins"] == 256

    cfg = small_config(tmp_path, **{**SMALL, "runner.train_batch_size": 32,
                                    "runner.infer_batch_size": 32,
                                    "runner.print_interval": 2,
                                    "runner.train_data_dir": data,
                                    "runner.test_data_dir": data})
    ref = jax_trainer_mod.Trainer(cfg, mesh=create_mesh(1, 1, jax.devices()[:1]))
    _, train_lines = _captured(jax_trainer_mod.logger, ref.train)
    _, infer_lines = _captured(jax_trainer_mod.logger, ref.evaluate)
    assert _count(train_lines, STEP_LINE) == 4 and _count(train_lines, EPOCH_LINE) == 1
    assert _count(infer_lines, INFER_STEP_LINE) == 4 and _count(infer_lines, INFER_LINE) == 1


def test_trainer_feeds_slotbin_superbatches_and_resumes(tmp_path):
    """``Trainer.train()`` over slotbin files through superbatch staging with
    the compact wire format, then a resume from the saved checkpoint."""
    rows = _batches(9, steps=1, rows=200)[0]
    os.makedirs(tmp_path / "bin")
    for i in range(2):
        part = slice(100 * i, 100 * (i + 1))
        write_slotbin(str(tmp_path / "bin" / f"part-{i}.bin"), rows["label"][part],
                      rows["sparse"][part].astype(np.int32), rows["dense"][part])
    flat = small_config(tmp_path, **{
        **SMALL, "runner.train_batch_size": 16, "runner.infer_batch_size": 16,
        "runner.train_data_dir": str(tmp_path / "bin"),
        "runner.test_data_dir": str(tmp_path / "bin"),
        "runner.model_save_path": str(tmp_path / "out"),
        "runner.infer_load_path": str(tmp_path / "out"),
        "runner.feed_superbatch": 4, "runner.wire_format": "compact",
        "runner.print_interval": 5}).to_dict()
    trainer = port_trainer_mod.Trainer(Config(flat), device="cpu")
    metrics = trainer.train()
    assert metrics["total_ins"] == 192  # 12 full batches of 16, the tail dropped
    assert trainer.state.step == 12
    evaluated = trainer.evaluate(epoch_tag=0)
    assert evaluated["total_ins"] == 200  # the padded tail counts its 8 rows

    resumed = port_trainer_mod.Trainer(Config({
        **flat, "runner.model_init_path": str(tmp_path / "out" / "0"),
        "runner.last_epoch": 0, "runner.epochs": 2}), device="cpu")
    resumed.train()
    assert resumed.state.opt_state["count"] == 24
    fresh = port_trainer_mod.Trainer(Config(flat), device="cpu")
    fresh.load_checkpoint(str(tmp_path / "out"), 0, params_only=True)
    assert fresh.state.opt_state["count"] == 0
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(fresh.state.module.state_dict()[k], v), k


@pytest.mark.parametrize("key,value", [
    ("runner.sync_mode", "geo"), ("runner.sync_mode", "fl"),
    ("runner.mesh_mp", 2), ("runner.mesh_dp", 2),
    ("hyper_parameters.distributed_embedding", 1),
])
def test_keys_that_are_not_ported_raise_by_name(tmp_path, key, value):
    """``check_ported`` at one process, sparse runs included, as the JAX
    trainer at one process: geo trains as plain sync and a 1×1
    ``distributed_embedding`` mesh is accepted (both build), fl raises the
    reference's ValueError, and a mesh wider than the one rank raises the
    mesh's ValueError (the JAX ``create_mesh``'s)."""
    for sparse in (False, True):
        cfg = Config({**small_config(tmp_path, **SMALL).to_dict(), key: value,
                      "hyper_parameters.sparse_update": sparse})
        if value == "fl":
            with pytest.raises(ValueError, match="sync_mode: fl needs >1 process"):
                port_trainer_mod.Trainer(cfg, device="cpu")
        elif value in ("geo", 1):
            trainer = port_trainer_mod.Trainer(cfg, device="cpu")
            assert (trainer.mesh.dp, trainer.mesh.mp) == (1, 1)
        else:
            with pytest.raises(ValueError, match=r"mesh \d+x\d+ != world size 1"):
                port_trainer_mod.Trainer(cfg, device="cpu")


def test_set_hyperparams_retunes_the_injected_values(tmp_path):
    flat = small_config(tmp_path, **SMALL).to_dict()
    plain = port_trainer_mod.Trainer(Config(flat), device="cpu")
    with pytest.raises(ValueError, match="set_hyperparams needs optimizer.runtime_inject"):
        plain.set_hyperparams(learning_rate=0.1)
    trainer = port_trainer_mod.Trainer(Config({
        **flat, "hyper_parameters.optimizer.runtime_inject": True}), device="cpu")
    trainer.set_hyperparams(learning_rate=0.0, embedding_l2=0.5)  # builds the state
    assert trainer.state.opt_state["hyperparams"] == {"learning_rate": 0.0,
                                                     "embedding_l2": 0.5}
    with pytest.raises(KeyError, match="not injected hyperparams"):
        trainer.set_hyperparams(momentum=0.9)
    before = {k: v.clone() for k, v in trainer.state.module.state_dict().items()}
    batch = to_tensors(_batches(3, steps=1)[0], CPU)
    ms, _ = trainer.train_step(batch, trainer._init_metric_state())
    for k, v in trainer.state.module.state_dict().items():  # lr 0: nothing moves
        assert torch.equal(v, before[k]), k
    trainer.set_hyperparams(learning_rate=0.01)
    trainer.train_step(batch, ms)
    table = trainer.state.module.state_dict()["embedding.embedding"]
    # a row no id touched decays by lr * el2 and nothing else
    rows = np.ones(table.shape[0], bool)
    rows[(_batches(3, steps=1)[0]["sparse"].reshape(-1) % VOCAB) // 8] = False
    assert rows.sum() > 10
    ratio = table[rows] / before["embedding.embedding"][rows]
    np.testing.assert_allclose(ratio.numpy(), 1 - 0.01 * 0.5, rtol=1e-5)
    # the values ride in the checkpoint with the rest of the optimizer state
    port_ckpt.save_model(trainer.state.module.state_dict(), trainer.state.opt_state,
                         str(tmp_path / "hp"), 0)
    other = port_trainer_mod.Trainer(Config({
        **flat, "hyper_parameters.optimizer.runtime_inject": True}), device="cpu")
    other.load_checkpoint(str(tmp_path / "hp"), 0)
    assert other.state.opt_state["hyperparams"] == {"learning_rate": 0.01,
                                                   "embedding_l2": 0.5}
    assert other.state.opt_state["count"] == 2


def test_native_reader_falls_back_with_a_warning(tmp_path, monkeypatch):
    """``reader_type: native`` reads through the native parser; only when it
    cannot be built (no toolchain) does the trainer fall back to the Python
    reader, with the JAX package's warning."""
    from paddlerec_tpu_torch import native

    data = str(tmp_path / "train")
    write_criteo_sample(data, num_lines=64, num_files=1, vocab=VOCAB)
    cfg = Config({**small_config(tmp_path, **SMALL).to_dict(),
                  "runner.reader_type": "native"})
    trainer = port_trainer_mod.Trainer(cfg, device="cpu")
    dataset, lines = _captured(port_trainer_mod.logger,
                               lambda: trainer.make_dataset(data, 16))
    assert type(dataset).__name__ == "NativeSlotDataset"
    assert not any("falling back" in line for line in lines)
    native_batches = list(dataset)

    def unavailable():
        raise native.NativeUnavailable("building libfastreader.so failed: no g++")

    monkeypatch.setattr(native, "fastreader", unavailable)
    dataset, lines = _captured(port_trainer_mod.logger,
                               lambda: trainer.make_dataset(data, 16))
    assert any("falling back to the Python reader" in line for line in lines)
    batches = list(dataset)
    assert len(batches) == len(native_batches) == 4
    for x, y in zip(batches, native_batches):
        for k in x:
            assert x[k].tobytes() == y[k].tobytes(), k


def test_train_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = Config(small_config(tmp_path, **SMALL).to_dict())
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "rank", "deepfm", "config.yaml")
    for call in (lambda: port_trainer_mod.Trainer(cfg),
                 lambda: port_train.main(["-m", config]),
                 lambda: port_infer.main(["-m", config])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
