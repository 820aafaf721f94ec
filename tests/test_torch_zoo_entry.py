"""Every ported rank model through the port's entry points, from the repo's
own ``configs/rank/<model>/config.yaml``: the trainer builds at full width,
and a small-vocab copy trains, checkpoints, evaluates, exports and serves on
the CPU."""

import os

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the directory under configs/rank → the name its config registers
CONFIGS = {
    "lr": "rank.lr", "logistic_regression": "rank.logistic_regression", "fm": "rank.fm",
    "slot_dnn": "rank.slot_dnn", "dcn": "rank.dcn", "dcn_v2": "rank.dcn_v2",
    "dlrm": "rank.dlrm", "xdeepfm": "rank.xdeepfm", "autoint": "rank.autoint",
    "gatenet": "rank.gatenet", "flen": "rank.flen", "deepfefm": "rank.deepfefm",
    "difm": "rank.difm", "ffm": "rank.ffm", "fat_deepffm": "rank.fat_deepffm",
    "fgcnn": "rank.fgcnn", "autofis": "rank.autofis",
}
# tables of the full-width module: name → (shape, lanes read)
TABLES = {
    "ffm": {"embedding.embedding": (1000001, 351), "first_weight.embedding": (62501, 128)},
    "fat_deepffm": {"embedding.embedding": (1000001, 351)},
    "lr": {"FMFirstOrder_0.sparse_w": (62501, 128)},
    "logistic_regression": {"FMFirstOrder_0.sparse_w": (62501, 128)},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_builds_at_full_width_and_a_small_vocab_copy_runs(tmp_path, name):
    config = os.path.join(REPO, "configs", "rank", name, "config.yaml")
    cfg = load_config(config)
    assert cfg.runner("model") == CONFIGS[name]
    # the full width: the trainer builds (nothing is allocated before init_state)
    full = port_trainer_mod.Trainer(cfg, device="cpu")
    assert full.state is None and full.model_def.vocab_size == 1000001
    shapes = {k: tuple(v.shape) for k, v in
              full.model_def.make_module(device="meta").state_dict().items()}
    tables = TABLES.get(name, {"embedding.embedding": (125001, 128)})
    for key, shape in tables.items():
        assert shapes[key] == shape, (key, shapes[key])

    data, save, exported = (str(tmp_path / d) for d in ("train", "out", "exported"))
    write_criteo_sample(data, num_lines=256, num_files=2, vocab=3001, seed=7)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.train_batch_size=32", "runner.infer_batch_size=32",
            "runner.print_interval=4", "runner.epochs=2", "runner.seed=1",
            "hyper_parameters.sparse_feature_number=3001",
            "hyper_parameters.optimizer.learning_rate=0.01",
            "hyper_parameters.fc_sizes=[32,16]", "hyper_parameters.width=32",
            "hyper_parameters.depth=2"]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    assert metrics["total_ins"] == 256 and np.isfinite(metrics["auc"])
    params, opt_state, extra = port_ckpt.load_model(save, 1)
    assert extra is None
    if name == "autofis":  # the search stage's two optimizers, each with its state
        assert sorted(opt_state) == ["dense", "gate"]
        assert opt_state["gate"]["count"] == opt_state["dense"]["count"] == 16
    else:
        assert opt_state["count"] == 16
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and results[1]["total_ins"] == 256
    # it learned the sample; dlrm's trailing ReLU (the reference's too) can
    # leave its two-unit head dead on 16 steps, with every prediction 0.5
    learns = name != "dlrm"
    assert results[1]["auc"] > 0.6 if learns else np.isfinite(results[1]["auc"])

    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, report = port_predict.run_predict(exported, data, 50, device="cpu")
    preds = np.concatenate(out)
    assert preds.shape == (256,) and np.isfinite(preds).all() and report["qps"] > 0
    assert 0 <= preds.min() and preds.max() <= 1 and (preds.std() > 0 or not learns)
    # the artifact serves what the checkpoint evaluates
    trainer = port_trainer_mod.Trainer(
        load_config(config, parse_overrides(opts)), device="cpu")
    trainer.load_checkpoint(save, 1, params_only=True)
    assert sorted(params) == sorted(trainer.state.module.state_dict())
    dataset = trainer.make_dataset(data, 50, drop_last=False)
    first = next(iter(trainer._device_batches(dataset)))
    _, aux = trainer.infer_step(first, trainer._init_metric_state())
    np.testing.assert_allclose(out[0], aux["predictions"].numpy()[:len(out[0])],
                               rtol=0, atol=1e-6)
