"""Sparse runs (``hyper_parameters.sparse_update``) of the port as a whole
against the JAX trainer: both packages built from one config, the same
parameters copied in, the same 20 host-deduped batches; then the trainer
loop with its feed, the checkpoint with the row-wise side state, the
conversion of parameters and state, and the export of a sparse run."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.ops import sparse_update as jax_su
from paddlerec_tpu.parallel.mesh import create_mesh
from paddlerec_tpu.train import trainer as jax_trainer_mod
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import HOST_KEYS, to_tensors
from paddlerec_tpu_torch.data.binary import write_slotbin
from paddlerec_tpu_torch.data.schema import schema_from_config
from paddlerec_tpu_torch.data.slot_reader import SlotDataset, list_data_files
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.data.wire import WireEncoder
from paddlerec_tpu_torch.ops import sparse_update as port_su
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import predict as port_predict
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
    "hyper_parameters.sparse_update": True,
    "runner.train_batch_size": BATCH,
    "runner.infer_batch_size": BATCH,
}
TABLE = "embedding.embedding"
KEY = "embedding/embedding_delta"


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


def _pair(tmp_path, model="rank.deepfm", **extra):
    cfg = small_config(tmp_path, model=model, **{**SMALL, **extra})
    ref = jax_trainer_mod.Trainer(cfg, mesh=create_mesh(1, 1, jax.devices()[:1]))
    ref.init_state(seed=0)
    port = port_trainer_mod.Trainer(Config(cfg.to_dict()), device="cpu")
    port.init_state(seed=0)
    port.state.module.load_state_dict(
        convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params))))
    return ref, port


def _train_both(ref, port, batches):
    """The same batches through both trainers' steps.  Returns (JAX losses,
    port losses, JAX metric state, port metric state)."""
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    ref_losses, port_losses = [], []
    for batch in batches:
        want = ref.model_def.augment_batch_host(batch)
        batch = port.model_def.augment_batch_host(batch)
        assert sorted(batch) == sorted(want)
        for k, v in want.items():  # the host dedup, bit for bit
            assert batch[k].dtype == v.dtype and batch[k].tobytes() == v.tobytes(), k
        ref.state, ref_ms, loss = step(ref.state, jax.device_put(want), ref_ms)
        ref_losses.append(float(loss))
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        port_losses.append(float(loss))
    return ref_losses, port_losses, ref_ms, port_ms


# f32 table: as the dense run of test_torch_train.py (loss 1e-5, parameters
# 1e-5), and the row state held as the rules' own test holds it.  bf16 table:
# the external lookup hands out float32 vectors and the row step runs in
# float32 and rounds once, so the loss and the float32 leaves stay as tight as
# for the f32 table; a table entry can differ by one bf16 ulp where a last f32
# bit flips the rounding, and Adam's m / sqrt(v) may then carry that on, so
# the bf16 table is held to a few ulps of its entries (|p| <= 0.06: 2.4e-4 an
# ulp) with the share of entries that differ at all bounded.
def _compare(ref, port, ref_losses, port_losses, ref_ms, port_ms, dtype, rule):
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(port_losses))
    assert port.state.step == int(ref.state.step) == len(port_losses)
    ref_params = jax.tree.map(np.asarray, jax.device_get(ref.state.params))
    want = convert.from_jax_params(ref_params)
    got = port.state.module.state_dict()
    assert sorted(got) == sorted(want)  # no embedding_delta on either side now
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if v.dtype == torch.bfloat16:
            assert k == TABLE
            diff = (got[k].float() - v.float()).abs()
            assert float(diff.max()) <= 1e-3, float(diff.max())
            assert float((diff > 0).float().mean()) <= 2e-3
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert got[TABLE].dtype == getattr(torch, dtype)

    extra = convert.from_jax_sparse_state(jax.device_get(ref.state.extra))
    assert sorted(port.state.extra) == sorted(extra) == [KEY]
    state, ref_state = port.state.extra[KEY], extra[KEY]
    assert type(state) is type(ref_state)
    assert state._fields == (("acc",) if rule == "adagrad" else ("m", "v", "count"))
    for field in state._fields:
        a, b = getattr(state, field), getattr(ref_state, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if field == "count":
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=field)

    # nothing of the table's size besides the table and its row state
    table = port.state.module.embedding.embedding
    assert table.grad is None and not table.requires_grad
    assert TABLE not in port.state.params
    for moments in port.state.opt_state.values():
        assert not isinstance(moments, dict) or TABLE not in moments
    assert "embedding.embedding_delta" not in got

    ref_bundle = ref._compute_metrics(ref_ms)
    port_bundle = port._compute_metrics(port_ms)
    # the AUC buckets: equal, but for a prediction that sits on a bucket's
    # edge and falls to the neighbour (at most two of 1,280 here)
    exact = True
    for k in ("stat_pos", "stat_neg"):
        moved = port_ms["auc"][k].numpy() - np.asarray(ref_ms["auc"][k])
        assert np.abs(moved).sum() <= 4 and np.abs(np.cumsum(moved)).max() <= 1, k
        exact = exact and not moved.any()
    for k, v in ref_bundle.items():  # one of ~600 x 600 pairs reordered: 5e-5 on the AUC
        assert abs(port_bundle[k] - v) < (1e-6 if exact else 5e-5), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_twenty_sparse_steps_match_the_jax_trainer(tmp_path, rule, dtype):
    ref, port = _pair(tmp_path, **{
        "hyper_parameters.sparse_feature_dtype": dtype,
        "hyper_parameters.sparse_update_rule": rule})
    _compare(ref, port, *_train_both(ref, port, _batches(1)), dtype, rule)


def test_sparse_steps_with_the_shared_clip_match_the_jax_trainer(tmp_path):
    """``clip_by_norm`` in a sparse run: one norm over the dense leaves and
    the per-position gradients, small enough here to clip every step."""
    ref, port = _pair(tmp_path, **{"hyper_parameters.clip_by_norm": 0.05,
                                   "hyper_parameters.sparse_update_rule": "adagrad"})
    assert port.tx.clip is None  # the trainer clips, not the optimizer
    _compare(ref, port, *_train_both(ref, port, _batches(2)), "float32", "adagrad")
    unclipped_ref, unclipped = _pair(tmp_path, **{
        "hyper_parameters.sparse_update_rule": "adagrad"})
    losses = _train_both(unclipped_ref, unclipped, _batches(2))[1]
    clipped = _train_both(*_pair(tmp_path, **{
        "hyper_parameters.clip_by_norm": 0.05,
        "hyper_parameters.sparse_update_rule": "adagrad"}), _batches(2))[1]
    assert abs(losses[-1] - clipped[-1]) > 1e-4  # the clip did bite


def test_a_bare_batch_takes_the_dense_scratch_rules(tmp_path):
    """A caller who hands ``train_step`` a batch without the host dedup gets
    the sort-free rules, as in the JAX package."""
    ref, port = _pair(tmp_path, **{"hyper_parameters.sparse_update_rule": "adam"})
    step = ref._build_train_step()
    ref_ms, port_ms = ref._init_metric_state(), port._init_metric_state()
    for batch in _batches(3, steps=5):
        ref.state, ref_ms, want = step(ref.state, jax.device_put(batch), ref_ms)
        port_ms, loss = port.train_step(to_tensors(batch, CPU), port_ms)
        assert abs(float(loss) - float(want)) < 1e-5
    want = convert.from_jax_params(jax.tree.map(np.asarray, jax.device_get(ref.state.params)))
    np.testing.assert_allclose(port.state.module.state_dict()[TABLE].numpy(),
                               want[TABLE].numpy(), rtol=0, atol=1e-5)


def test_stochastic_rounding_run_stays_close_to_the_jax_run(tmp_path):
    """The two frameworks draw different noise: finite losses and an AUC
    within 1e-2 of the JAX run's."""
    ref, port = _pair(tmp_path, **{
        "hyper_parameters.sparse_feature_dtype": "bfloat16",
        "hyper_parameters.sparse_update_rule": "adagrad",
        "hyper_parameters.sparse_update_stochastic_round": True,
        "hyper_parameters.optimizer.learning_rate": 0.01})
    start = port.state.module.state_dict()[TABLE].clone()
    ref_losses, port_losses, ref_ms, port_ms = _train_both(ref, port, _batches(4))
    assert np.all(np.isfinite(port_losses))
    assert abs(port_losses[-1] - ref_losses[-1]) < 1e-2
    assert abs(port._compute_metrics(port_ms)["auc"] - ref._compute_metrics(ref_ms)["auc"]) < 1e-2
    table = port.state.module.state_dict()[TABLE]
    assert table.dtype == torch.bfloat16 and not torch.equal(table, start)
    # the same seed and steps draw the same noise: a second run is bitwise
    _, again = _pair(tmp_path, **{
        "hyper_parameters.sparse_feature_dtype": "bfloat16",
        "hyper_parameters.sparse_update_rule": "adagrad",
        "hyper_parameters.sparse_update_stochastic_round": True,
        "hyper_parameters.optimizer.learning_rate": 0.01})
    ms = again._init_metric_state()
    for batch in _batches(4):
        ms, _ = again.train_step(
            to_tensors(again.model_def.augment_batch_host(batch), CPU), ms)
    assert torch.equal(again.state.module.state_dict()[TABLE], table)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _sparse_run_config(tmp_path, **extra):
    rows = _batches(9, steps=1, rows=200)[0]
    os.makedirs(tmp_path / "bin", exist_ok=True)
    for i in range(2):
        part = slice(100 * i, 100 * (i + 1))
        write_slotbin(str(tmp_path / "bin" / f"part-{i}.bin"), rows["label"][part],
                      rows["sparse"][part].astype(np.int32), rows["dense"][part])
    return small_config(tmp_path, **{
        **SMALL, "runner.train_batch_size": 16, "runner.infer_batch_size": 16,
        "runner.train_data_dir": str(tmp_path / "bin"),
        "runner.test_data_dir": str(tmp_path / "bin"),
        "runner.model_save_path": str(tmp_path / "out"),
        "runner.infer_load_path": str(tmp_path / "out"),
        "runner.feed_superbatch": 4, "runner.wire_format": "compact",
        "runner.print_interval": 5,
        "hyper_parameters.sparse_update_rule": "adagrad", **extra}).to_dict()


def test_feed_dedups_on_the_host_and_steps_equal_plain_steps(tmp_path):
    """``Trainer.train()`` through the staged superbatch feed with the
    compact wire format: the batches carry ``sparse_uniq``/``sparse_slot``
    (int32, dedup before the encoding) and the host-side count, and the run
    equals plain steps on the same augmented batches bitwise."""
    flat = _sparse_run_config(tmp_path)
    trainer = port_trainer_mod.Trainer(Config(flat), device="cpu")
    trainer.init_state(seed=5)
    dataset = trainer.make_dataset(flat["runner.train_data_dir"], 16)
    seen = list(trainer._device_batches(dataset, allow_super=True, augment=True))
    assert len(seen) == 12
    sb, _ = seen[0]
    assert sb["sparse"].dtype == torch.uint8  # wire-encoded after the dedup
    for key in ("sparse_uniq", "sparse_slot"):
        assert sb[key].dtype == torch.int32 and sb[key].shape == (4, 16 * 26)
    assert "sparse_num_uniq" in HOST_KEYS and sb["sparse_num_uniq"].shape == (4,)
    counts = (sb["sparse_uniq"] != port_su.SENTINEL).sum(dim=1)
    assert torch.equal(counts, sb["sparse_num_uniq"])
    # evaluation feeds no dedup
    plain = next(iter(trainer._device_batches(dataset, allow_super=True)))[0]
    assert "sparse_uniq" not in plain

    metrics = trainer.train()
    assert metrics["total_ins"] == 192 and trainer.state.step == 12
    other = port_trainer_mod.Trainer(Config(flat), device="cpu")
    other.init_state(seed=5)
    ms, enc = other._init_metric_state(), WireEncoder(VOCAB)
    for batch in other.make_dataset(flat["runner.train_data_dir"], 16):
        ms, _ = other.train_step(
            to_tensors(enc(other.model_def.augment_batch_host(batch)), CPU), ms)
    for k, v in trainer.state.module.state_dict().items():
        assert torch.equal(other.state.module.state_dict()[k], v), k
    assert torch.equal(other.state.extra[KEY].acc, trainer.state.extra[KEY].acc)
    assert trainer.evaluate(epoch_tag=0)["total_ins"] == 200


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_checkpoint_carries_the_row_state_and_resumes(tmp_path, rule):
    flat = _sparse_run_config(tmp_path, **{"hyper_parameters.sparse_update_rule": rule})
    trainer = port_trainer_mod.Trainer(Config(flat), device="cpu")
    trainer.train()
    params, opt_state, extra = port_ckpt.load_model(str(tmp_path / "out"), 0)
    assert TABLE in params and TABLE not in opt_state["mu"]
    fields = ["acc"] if rule == "adagrad" else ["count", "m", "v"]
    assert sorted(extra) == [KEY] and sorted(extra[KEY]) == fields

    resumed = port_trainer_mod.Trainer(Config({
        **flat, "runner.model_init_path": str(tmp_path / "out" / "0"),
        "runner.last_epoch": 0, "runner.epochs": 2}), device="cpu")
    resumed.init_state()
    resumed.load_checkpoint(str(tmp_path / "out"), 0)
    for field in trainer.state.extra[KEY]._fields:
        a = getattr(resumed.state.extra[KEY], field)
        assert torch.equal(a, getattr(trainer.state.extra[KEY], field)), field
        assert float(a.float().abs().max()) > 0
    resumed.state = None
    resumed.train()  # one more epoch from the checkpoint
    assert resumed.state.opt_state["count"] == 24
    straight = port_trainer_mod.Trainer(Config({**flat, "runner.epochs": 2,
                                                "runner.model_save_path": None}),
                                        device="cpu")
    straight.train()
    for k, v in straight.state.module.state_dict().items():
        assert torch.equal(resumed.state.module.state_dict()[k], v), k


def test_checkpoint_without_row_state_loads_with_the_references_warning(tmp_path):
    flat = _sparse_run_config(tmp_path)
    dense = port_trainer_mod.Trainer(Config({
        **flat, "hyper_parameters.sparse_update": False}), device="cpu")
    dense.init_state(seed=1)
    state = dense.state
    sparse = port_trainer_mod.Trainer(Config(flat), device="cpu")
    sparse.init_state(seed=2)
    # a checkpoint of the sparse run's shape, written without the side state
    port_ckpt.save_model(state.module.state_dict(), sparse.state.opt_state,
                         str(tmp_path / "old"), 0)
    handler = _Capture()
    port_trainer_mod.logger.addHandler(handler)
    try:
        sparse.load_checkpoint(str(tmp_path / "old"), 0)
    finally:
        port_trainer_mod.logger.removeHandler(handler)
    assert handler.lines == ["checkpoint has no sparse-update side state; row-wise "
                             "optimizer moments start fresh"]
    assert torch.equal(sparse.state.module.state_dict()[TABLE],
                       state.module.state_dict()[TABLE])
    assert float(sparse.state.extra[KEY].acc.abs().max()) == 0.0


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_sparse_params_and_row_state_cross_bitwise(tmp_path, rule):
    ref, port = _pair(tmp_path, **{"hyper_parameters.sparse_update_rule": rule,
                                   "hyper_parameters.sparse_feature_dtype": "bfloat16"})
    _train_both(ref, port, _batches(5, steps=3))
    ref_params = jax.tree.map(np.asarray, jax.device_get(ref.state.params))
    cap = ref_params["embedding"]["embedding_delta"].shape[0]
    assert cap == 26 * BATCH
    state = convert.from_jax_params(ref_params)
    assert "embedding.embedding_delta" not in state
    back = convert.to_jax_params(state, delta_capacity=cap)
    flat, flat_back = convert.flatten_tree(ref_params), convert.flatten_tree(back)
    assert sorted(flat) == sorted(flat_back)
    for k, v in flat.items():
        assert v.dtype == flat_back[k].dtype and v.tobytes() == flat_back[k].tobytes(), k
    assert "embedding/embedding_delta" not in convert.flatten_tree(convert.to_jax_params(state))

    ref_extra = jax.device_get(ref.state.extra)
    back = convert.to_jax_sparse_state(convert.from_jax_sparse_state(ref_extra))
    cls = jax_su.RowwiseAdagradState if rule == "adagrad" else jax_su.RowwiseAdamState
    rebuilt = cls(**back[KEY])
    for field in cls._fields:
        a, b = np.asarray(getattr(ref_extra[KEY], field)), getattr(rebuilt, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    # and the port's own state goes through the same door
    own = convert.to_jax_sparse_state(port.state.extra)
    assert sorted(own[KEY]) == sorted(cls._fields)


# An artifact of a sparse run serves through the plain lookup.  f32 table:
# the plain and the external lookup read the same rows (1e-5, summation
# order).  bf16 table: the plain module's vectors are bf16 where the training
# module's were float32, a difference the JAX package has as well; against the
# JAX package's plain module it is the dense run's 1e-4.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_export_of_a_sparse_run_serves_and_matches_jax(tmp_path, dtype, atol):
    flat = _sparse_run_config(tmp_path, **{"hyper_parameters.sparse_feature_dtype": dtype})
    trainer = port_trainer_mod.Trainer(Config(flat), device="cpu")
    trainer.train()
    export_dir = str(tmp_path / "export")
    port_export.export_model(
        Config({**flat, "runner.model_init_path": str(tmp_path / "out" / "0")}), export_dir)
    model_def, module = port_export.load_exported(export_dir, device="cpu")
    assert not model_def.sparse_update_enabled()
    assert not module.embedding.external_update and module.embedding.embedding.dtype == getattr(torch, dtype)
    assert torch.equal(module.embedding.embedding, trainer.state.module.embedding.embedding)

    text = str(tmp_path / "text")
    write_criteo_sample(text, num_lines=100, num_files=1, vocab=VOCAB, seed=3)
    # (batches of 16: the training module's capacity check holds to its config)
    outputs, _ = port_predict.run_predict(export_dir, text, 16, device="cpu")
    preds = np.concatenate(outputs)
    assert preds.shape == (100,)

    jax_cfg = small_config(tmp_path, **{**SMALL, "hyper_parameters.sparse_update": False,
                                        "hyper_parameters.sparse_feature_dtype": dtype})
    jax_def = jax_model_class("rank.deepfm")(jax_cfg)
    params = convert.to_jax_params(trainer.state.module.state_dict())
    dataset = SlotDataset(list_data_files(text), schema_from_config(Config(flat)), 16,
                          drop_last=False)
    want, own = [], []
    for batch in dataset:
        keep = batch["mask"] > 0
        aux = jax_def.infer_forward(params, jax.tree.map(jax.numpy.asarray, batch))
        want.append(np.asarray(aux["predictions"])[keep])
        with torch.no_grad():  # the training module: external lookup, float32 vectors
            aux = trainer.model_def.infer_forward(trainer.state.module, to_tensors(batch, CPU))
        own.append(aux["predictions"].numpy()[keep])
    np.testing.assert_allclose(preds, np.concatenate(want), rtol=0, atol=atol)
    np.testing.assert_allclose(preds, np.concatenate(own), rtol=0, atol=atol)
