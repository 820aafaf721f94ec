"""Recall's deepwalk, mind, tisas, ensfm and mhcn and the graph family
through the port's entry points on the CPU: each model's own
``configs/<family>/<model>/config.yaml`` (its full widths read off a module
on the meta device) through ``tools.train``, ``tools.infer``,
``tools.export`` and ``tools.predict`` at a small size, the graph models
through the native walk engine; ``run_predict`` on an exported deepwalk,
graph.gnn, tisas and ensfm against the JAX ``run_predict`` (atol 1e-5);
mhcn trained through ``set_graph`` on a seeded graph; and the entry points'
default device."""

import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu_torch.core.config import Config, load_config
from paddlerec_tpu_torch.core.registry import load_model_def
from paddlerec_tpu_torch.data.graph_dataset import GraphChunkedDataset
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_graph_common import HYPER, MODELS, flat_config
from tests.test_torch_graph_data import WRITERS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the widths of the repo's configs, which set only the runner and Adam: each
# ModelDef's defaults, read off a module on the meta device
FULL_WIDTH = {
    "recall.deepwalk": {"node_embedding.embedding": (10312, 16)},
    "graph.gnn": {"node_embedding.embedding": (10000, 64)},
    "graph.lightgcn": {"node_embedding.embedding": (10000, 64)},
    "graph.transformer_conv": {"node_embedding.embedding": (10000, 64),
                               "conv_0.q.weight": (64, 64), "conv_0.gate.weight": (1, 192)},
    "graph.deepwalk_million": {"node_embedding.embedding": (10000, 64)},
    "recall.mind": {"item_emb.embedding": (367983, 64), "routing.bilinear_w": (64, 64),
                    "routing.routing_logits": (1, 4, 20)},
    "recall.tisas": {"item_emb.embedding": (3418, 50), "abs_pos_K_emb.embedding": (50, 50),
                     "time_matrix_V_emb.embedding": (257, 50), "att_1.q.weight": (50, 50),
                     "last_ln.scale": (50,)},
    "recall.ensfm": {"user_feature_emb.embedding": (6069, 8),
                     "all_item_feature_emb.embedding": (3954, 8),
                     "item_bias.embedding": (3953, 1), "H_s": (8, 1), "bias": (1,)},
    "recall.mhcn": {"user_embeddings": (64, 50), "item_embeddings": (64, 50),
                    "sgating3_b": (1, 50)},
}
# the aux entry run_predict writes: none for mind (logits only) and mhcn
# (losses only); ensfm's scores are a row of every item
PER_ROW = {"recall.mind": 0, "recall.mhcn": 0, "recall.ensfm": HYPER["recall.ensfm"]["num_items"]}


def _config_path(model):
    family, name = model.split(".")
    return os.path.join(REPO, "configs", family, name, "config.yaml")


def _hyper_opts(model):
    return [f"hyper_parameters.{k}={v}".replace(" ", "") for k, v in HYPER[model].items()]


@pytest.mark.parametrize("model", MODELS)
def test_config_through_every_entry_point_on_the_cpu(tmp_path, model):
    config = _config_path(model)
    cfg = load_config(config)
    assert cfg.runner("model") == model
    shapes = {k: tuple(v.shape) for k, v in
              load_model_def(cfg).make_module(device="meta").state_dict().items()}
    for key, shape in FULL_WIDTH[model].items():
        assert shapes[key] == shape, (key, shapes[key])

    data, save, exported = (str(tmp_path / d) for d in ("train", "out", "exported"))
    WRITERS[model](data, seed=5)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1",
            *_hyper_opts(model)]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    scored = load_model_def(cfg).metrics == "auc"
    assert metrics["ips"] > 0 and (not scored or np.isfinite(metrics["auc"]))
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and (not scored or np.isfinite(results[1]["auc"]))
    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, report = port_predict.run_predict(exported, data, 4, device="cpu")
    per_row = PER_ROW.get(model, 1)
    assert report["batches"] >= 1, (model, report)
    if per_row == 0:
        assert out == []
    else:
        assert np.isfinite(np.concatenate([o.reshape(-1) for o in out])).all()
    port_predict.main(["--export_dir", exported, "--data_dir", data, "--batch_size", "16",
                       "--device", "cpu"])


@pytest.fixture(scope="module", params=["recall.deepwalk", "graph.gnn", "recall.tisas",
                                        "recall.ensfm"])
def artifacts(request, tmp_path_factory):
    model = request.param
    root = tmp_path_factory.mktemp(model.split(".")[1])
    data = str(root / "data")
    WRITERS[model](data, seed=3)
    flat = flat_config(model, **{"runner.train_data_dir": data, "runner.test_data_dir": data})
    jax_dir, port_dir = str(root / "jax_export"), str(root / "port_export")
    jax_export.export_model(JaxConfig(flat), jax_dir)
    _, params = jax_export.load_exported(jax_dir)
    port_export.export_model(Config(flat), port_dir, params=jax.tree.map(np.asarray, params))
    return model, jax_dir, port_dir, data


def test_run_predict_on_an_export_matches_jax(artifacts):
    """The same predictions from the same artifact's parameters and rows
    (graph.gnn's batches from both packages' native engines)."""
    model, jax_dir, port_dir, data = artifacts
    ref, ref_report = jax_predict.run_predict(jax_dir, data, 4)
    out, report = port_predict.run_predict(port_dir, data, 4, device="cpu")
    assert [o.shape for o in out] == [r.shape for r in ref] and len(out) >= 2
    preds = np.concatenate([o.reshape(-1) for o in out])
    assert np.ptp(preds) > 0
    np.testing.assert_allclose(preds, np.concatenate([r.reshape(-1) for r in ref]),
                               rtol=0, atol=1e-5)
    assert report["batches"] == ref_report["batches"] >= 1 and report["qps"] > 0


def test_mhcn_trains_through_set_graph(tmp_path):
    """``set_graph`` on a seeded social and rating graph, then
    ``Trainer.train()`` on rows of that rating graph: the loss falls."""
    data = str(tmp_path / "data")
    rng = np.random.RandomState(0)
    h = HYPER["recall.mhcn"]
    u, i = h["num_users"], h["num_items"]
    social = (rng.rand(u, u) < 0.2).astype(np.float32)
    np.fill_diagonal(social, 0)
    rating = (rng.rand(u, i) < 0.3).astype(np.float32)
    os.makedirs(data)
    with open(os.path.join(data, "part-0"), "w") as f:
        f.writelines(f"{a} {b}\n" for a, b in zip(*np.nonzero(rating)) for _ in range(4))
    trainer = port_trainer_mod.Trainer(Config(flat_config("recall.mhcn", **{
        "hyper_parameters.demo_graph": False, "runner.train_data_dir": data,
        "runner.epochs": 3, "runner.train_batch_size": 16,
        "hyper_parameters.optimizer.learning_rate": 0.01})), device="cpu")
    trainer.init_state()
    with pytest.raises(RuntimeError, match="set_graph"):
        trainer.train()
    trainer.model_def.set_graph(social, rating)
    batch = next(iter(trainer.make_dataset(data, 64)))
    from paddlerec_tpu_torch.core.device import to_tensors

    def rec_loss():
        with torch.no_grad():
            aux = trainer.model_def.infer_forward(trainer.state.module,
                                                  to_tensors(batch, torch.device("cpu")))
        return float(aux["rec_loss"])

    before = rec_loss()
    trainer.train()
    assert rec_loss() < before and trainer.state.step > 10


def test_graph_training_uses_the_native_engine(tmp_path):
    data = str(tmp_path / "data")
    WRITERS["graph.gnn"](data, seed=1)
    trainer = port_trainer_mod.Trainer(Config(flat_config("graph.gnn", **{
        "runner.train_data_dir": data})), device="cpu")
    assert isinstance(trainer.make_dataset(data, 8), GraphChunkedDataset)


@pytest.mark.parametrize("model", MODELS)
def test_entry_points_default_to_the_card(tmp_path, model):
    """Without ``device="cpu"`` the trainer and the artifact loader ask for
    ``cuda``, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    exported = str(tmp_path / "exported")
    port_export.export_model(Config(flat_config(model)), exported)
    for call in (lambda: port_trainer_mod.Trainer(Config(flat_config(model))),
                 lambda: port_export.load_exported(exported),
                 lambda: port_predict.run_predict(exported, str(tmp_path), 32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
