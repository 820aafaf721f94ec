"""CtrDnn and Wide&Deep of the port against the JAX package: the forward from
converted parameters, 20 sparse train steps against the JAX trainer, and the
three ``config_bigdata.yaml`` through the port's entry points (a small-vocab
copy on the CPU; the full width only as far as building the trainer)."""

import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import load_config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.conftest import small_config
from tests.test_torch_sparse_train import _batches, _compare, _pair, _train_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["rank.dnn", "rank.wide_deep"]
# as for DeepFM: summation order only (f32); with a bf16 table XLA may keep
# f32 between fused bf16 ops where PyTorch rounds after each
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-4}


def _models(tmp_path, model, dtype):
    cfg = small_config(tmp_path, model=model,
                       **{"hyper_parameters.sparse_feature_dtype": dtype})
    jax_def = jax_model_class(model)(cfg)
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(0)))
    port_def = port_model_class(model)(cfg)
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, params, port_def, module.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_jax(tmp_path, model, dtype):
    jax_def, params, port_def, module = _models(tmp_path, model, dtype)
    batch = jax_def.example_batch(64)
    ref = jax_def.infer_forward(params, jax.tree.map(jax.numpy.asarray, batch))
    with torch.no_grad():
        out = port_def.infer_forward(module, to_tensors(batch, torch.device("cpu")))
    assert module.embedding.embedding.dtype == getattr(torch, dtype)
    assert out["predictions"].dtype == torch.float32
    np.testing.assert_allclose(out["predictions"].numpy(), np.asarray(ref["predictions"]),
                               rtol=0, atol=TOLERANCE[dtype])
    loss, _ = port_def.train_forward(module, to_tensors(batch, torch.device("cpu")))
    want, _ = jax_def.train_forward(params, jax.tree.map(jax.numpy.asarray, batch))
    assert abs(float(loss.detach()) - float(want)) < TOLERANCE[dtype]


@pytest.mark.parametrize("model", MODELS)
def test_param_names_and_round_trip(tmp_path, model):
    _, params, port_def, module = _models(tmp_path, model, "bfloat16")
    flat, back = flatten_tree(params), flatten_tree(to_jax_params(module.state_dict()))
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        assert v.dtype == back[k].dtype and v.tobytes() == back[k].tobytes(), k
    # the table's width: E for dnn, E + 1 (the wide weight's lane) for wide_deep
    rows = module.embedding.embedding.shape[0]
    assert rows == (10000 + 15) // 16 if model == "rank.dnn" else rows == 10000 // 8
    fresh = port_def.make_module(generator=torch.Generator().manual_seed(3))
    again = port_def.make_module(generator=torch.Generator().manual_seed(3))
    for (k, a), b in zip(fresh.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("rule,dtype", [("adagrad", "bfloat16"), ("adam", "float32"),
                                        ("adagrad", "float32"), ("adam", "bfloat16")])
@pytest.mark.parametrize("model", MODELS)
def test_twenty_sparse_steps_match_the_jax_trainer(tmp_path, model, rule, dtype):
    ref, port = _pair(tmp_path, model=model, **{
        "hyper_parameters.sparse_feature_dtype": dtype,
        "hyper_parameters.sparse_update_rule": rule})
    assert port.model_def._default_pack() == 8  # E = 9 and E + 1 = 10: 16 lanes each
    _compare(ref, port, *_train_both(ref, port, _batches(6)), dtype, rule)


@pytest.mark.parametrize("model", ["deepfm", "dnn", "wide_deep"])
def test_config_bigdata_builds_and_a_small_vocab_copy_trains(tmp_path, model):
    config = os.path.join(REPO, "configs", "rank", model, "config_bigdata.yaml")
    cfg = load_config(config)
    assert cfg.hyper("sparse_update") and cfg.hyper("sparse_feature_number") == 100000001
    # the full width: the trainer builds (nothing is allocated before init_state)
    full = port_trainer_mod.Trainer(cfg, device="cpu")
    assert full.sparse and full.model_def._sparse_update_rule() == "adagrad"
    assert full.model_def.table_dtype() == torch.bfloat16

    data, save = str(tmp_path / "train"), str(tmp_path / "out")
    write_criteo_sample(data, num_lines=256, num_files=2, vocab=3001, seed=7)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.train_batch_size=32", "runner.infer_batch_size=32",
            "runner.print_interval=4", "runner.epochs=2", "runner.seed=1",
            "hyper_parameters.sparse_feature_number=3001",
            "hyper_parameters.optimizer.learning_rate=0.01",
            "hyper_parameters.fc_sizes=[32,16]"]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    assert metrics["total_ins"] == 256 and np.isfinite(metrics["auc"])
    params, opt_state, extra = port_ckpt.load_model(save, 1)
    assert params["embedding.embedding"].dtype == torch.bfloat16
    assert "embedding.embedding" not in opt_state["mu"]
    acc = extra["embedding/embedding_delta"]["acc"]
    assert acc.shape == (params["embedding.embedding"].shape[0],) and float(acc.max()) > 0
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert results[1]["auc"] >= results[0]["auc"] > 0.9  # it learned the sample
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(["-m", config, "-o", *opts])
