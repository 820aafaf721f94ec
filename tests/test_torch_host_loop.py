"""The port's ``HostTableTrainer`` (``train/host_loop.py``, the GPUBox pass
loop) against the JAX package's on ``tests/test_host_loop.py``'s config:
rank.dnn, 8 slots, vocab 100,000, dim 8, a 64-row cache, three files of 48
rows, batch 16.  The JAX trainer's initial dense parameters are carried
across; after one epoch the resident rows are the same ids and the host
table's values and accumulator agree within 1e-5 (both are float32 adagrad
sums in another order).  Then the cache overflow, the CLI route, the
checkpoint and ``host_table.npz`` read by either package."""

import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.train import host_loop as jax_host_loop
from paddlerec_tpu_torch import convert
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.tools import train as port_train_cli
from paddlerec_tpu_torch.train import host_loop as port_host_loop
from paddlerec_tpu_torch.train import online as port_online
from tests.test_host_loop import _config, data_dir  # noqa: F401

torch.set_num_threads(1)


def _pair(cfg):
    ref = jax_host_loop.HostTableTrainer(cfg)
    ref.trainer.init_state()
    port = port_host_loop.HostTableTrainer(Config(cfg.to_dict()), device="cpu")
    port.trainer.init_state()
    port.trainer.state.module.load_state_dict(convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.trainer.state.params))))
    return ref, port


def _agree(ref, port):
    ids_r, vals_r = ref.table.snapshot_rows()
    ids_p, vals_p = port.table.snapshot_rows()
    assert ids_p.dtype == ids_r.dtype and np.array_equal(ids_p, ids_r)
    np.testing.assert_allclose(vals_p, vals_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.host_acc, ref.host_acc, rtol=1e-5, atol=1e-5)
    assert np.array_equal(port.table._shows, ref.table._shows)
    dense_ref = convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(ref.trainer.state.params)))
    got = port.trainer.state.module.state_dict()
    for k, v in dense_ref.items():
        if k != "embedding.embedding":
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("variant", ["ram", "wire_superbatch", "spill"])
def test_one_epoch_against_the_jax_package(data_dir, tmp_path, variant):  # noqa: F811
    extra = {
        "ram": {},
        "wire_superbatch": {"runner.wire_format": "compact", "runner.feed_superbatch": 2},
        "spill": {"runner.host_table_ram_rows": 24},
    }[variant]
    if variant == "spill":
        spill = {"runner.host_table_spill_dir": str(tmp_path / "jax_spill")}
        ref, _ = _pair(_config(data_dir, **extra, **spill))
        cfg = _config(data_dir, **extra,
                      **{"runner.host_table_spill_dir": str(tmp_path / "port_spill")})
        port = port_host_loop.HostTableTrainer(Config(cfg.to_dict()), device="cpu")
        port.trainer.init_state()
        port.trainer.state.module.load_state_dict(convert.from_jax_params(
            jax.tree.map(np.asarray, jax.device_get(ref.trainer.state.params))))
    else:
        ref, port = _pair(_config(data_dir, **extra))
    m_ref, m_port = ref.train(), port.train()
    assert m_port["total_ins"] == m_ref["total_ins"] == 144.0
    assert abs(m_port["auc"] - m_ref["auc"]) < 1e-6, (m_port, m_ref)
    assert set(m_port) == set(m_ref)
    _agree(ref, port)
    # the host tier holds the union of all pass rows; the device cache never
    # exceeded 64 rows while the vocabulary is 100,000
    assert 0 < port.table.rows_resident <= 3 * 64
    assert port.trainer.state.module.embedding.embedding.shape == (64, 128)
    assert port.phys_rows >= 100000 // port.pack
    if variant == "spill":
        assert port.table.rows_in_ram <= 24 < port.table.rows_resident
        assert port.table.rows_on_disk > 0
        assert os.path.exists(tmp_path / "port_spill" / "table_spill.npy")
    assert [(r["pass"], r["rows_cached"]) for r in port.pass_log] == [(0, 24), (1, 24), (2, 24)]
    for record in port.pass_log:
        for name in ("prep_wait_s", "begin_pass_s", "upload_s", "train_s", "flush_s"):
            assert record[name] >= 0.0
    assert port.pass_log[-1]["rows_resident"] == port.table.rows_resident


def test_rows_persist_across_passes_and_epochs(data_dir):  # noqa: F811
    """Two epochs: a row's value and accumulator carry across passes, as in
    the JAX package (an adagrad accumulator only grows)."""
    ref, port = _pair(_config(data_dir, **{"runner.epochs": 2}))
    ref.train()
    port.train()
    _agree(ref, port)
    _, one = _pair(_config(data_dir))  # the same first epoch, alone
    one.train()
    trained = port.host_acc > 0
    assert trained.any() and np.all(port.host_acc[trained] >= one.host_acc[trained])
    assert np.any(port.host_acc[trained] > one.host_acc[trained])


def test_cache_overflow_raises(data_dir):  # noqa: F811
    ht = port_host_loop.HostTableTrainer(
        Config(_config(data_dir, **{"runner.host_table_cache_rows": 4}).to_dict()),
        device="cpu")
    with pytest.raises(ValueError, match="host_table_cache_rows"):
        ht.train()


def test_cli_reaches_host_table(data_dir, tmp_path):  # noqa: F811
    """runner.use_host_table routes tools/train.py to the pass loop."""
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(f"""
runner:
  model: rank.dnn
  train_data_dir: {data_dir}
  train_batch_size: 16
  epochs: 1
  use_host_table: true
  host_table_cache_rows: 64
hyper_parameters:
  sparse_inputs_slots: 9
  sparse_feature_number: 100000
  sparse_feature_dim: 8
  dense_input_dim: 4
  fc_sizes: [16, 8]
""")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train_cli.main(["-m", str(cfg_path)])
    metrics = port_train_cli.main(["-m", str(cfg_path), "--device", "cpu"])
    assert metrics["total_ins"] == 144.0
    assert "pass_prep_wait_s" in metrics


def test_checkpoint_roundtrip_and_npz_across_packages(data_dir, tmp_path):  # noqa: F811
    """The port's checkpoint restores its host tier and dense part; the
    ``host_table.npz`` either package writes loads into the other."""
    ref, port = _pair(_config(data_dir, **{"runner.model_save_path": str(tmp_path / "jax")}))
    ref.train()
    port_cfg = _config(data_dir, **{"runner.model_save_path": str(tmp_path / "port"),
                                    "runner.host_table_ram_rows": 24})
    port = port_host_loop.HostTableTrainer(Config(port_cfg.to_dict()), device="cpu")
    port.train()
    assert os.path.exists(tmp_path / "port" / "0" / "host_table.npz")

    again = port_host_loop.HostTableTrainer(Config(_config(data_dir).to_dict()), device="cpu")
    again.load(str(tmp_path / "port"), 0)
    for x, y in zip(port.table.snapshot_rows(), again.table.snapshot_rows()):
        assert np.array_equal(x, y)
    assert np.array_equal(again.host_acc, port.host_acc)
    assert np.array_equal(again.table._shows, port.table._shows)
    for k, v in port.trainer.state.module.state_dict().items():
        assert torch.equal(again.trainer.state.module.state_dict()[k], v), k

    # JAX-written npz into the port (the dense part is each package's own
    # checkpoint format, so only the host tier crosses)
    into_port = port_host_loop.HostTableTrainer(Config(_config(data_dir).to_dict()),
                                                device="cpu")
    into_port.load_host_tier(str(tmp_path / "jax" / "0" / "host_table.npz"))
    for x, y in zip(ref.table.snapshot_rows(), into_port.table.snapshot_rows()):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert into_port.host_acc.tobytes() == ref.host_acc.tobytes()
    # port-written npz into the JAX package's load
    into_jax = jax_host_loop.HostTableTrainer(_config(data_dir))
    into_jax.trainer.init_state()
    into_jax.trainer.load_checkpoint = lambda root, tag: None
    into_jax.load(str(tmp_path / "port"), 0)
    for x, y in zip(port.table.snapshot_rows(), into_jax.table.snapshot_rows()):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert into_jax.host_acc.tobytes() == port.host_acc.tobytes()
    # the legacy dense npz (pre-disk-tier) loads as the JAX package's does
    ids, vals = ref.table.snapshot_rows()
    table = np.zeros((port.phys_rows, 128), np.float32)
    table[ids] = vals
    init = np.zeros(port.phys_rows, bool)
    init[ids] = True
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, table=table, initialized=init, shows=ref.table._shows,
             acc=ref.host_acc)
    old = port_host_loop.HostTableTrainer(Config(_config(data_dir).to_dict()), device="cpu")
    old.load_host_tier(str(legacy))
    for x, y in zip(ref.table.snapshot_rows(), old.table.snapshot_rows()):
        assert x.tobytes() == y.tobytes()


def test_online_loop_still_refuses_the_host_table(data_dir, tmp_path):  # noqa: F811
    cfg = Config(_config(data_dir).to_dict())
    with pytest.raises(NotImplementedError, match="use_host_table"):
        port_online.OnlineTrainer(cfg, device="cpu")
