"""The nine multitask models through the port's entry points, from the
repo's own ``configs/multitask/<model>/config.yaml``: the module builds at
the ModelDefs' default widths (on the ``meta`` device: nothing allocated),
and a small copy trains, checkpoints, evaluates, exports and serves on the
CPU through ``tools.train``, ``tools.infer``, ``tools.export`` and
``tools.predict`` on files in the model's own format.  Without a card the
entry points refuse a multitask artifact too."""

import os

import numpy as np
import pytest
import torch

from paddlerec_tpu_torch.core.config import load_config, parse_overrides
from paddlerec_tpu_torch.serving.webserver import RecService
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_multitask_common import HYPER
from tests.test_torch_multitask_data import (
    write_aliccp, write_census, write_lookalike, write_multimnist, write_omniglot,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# model → (writer of its files, rows, the batch, leaves of the full-width
# module with their shapes)
CASES = {
    "share_bottom": (write_census, 40, 8, {"bottom.weight": (117, 499)}),
    "mmoe": (write_census, 40, 8, {"experts.weight": (16, 8, 499)}),
    "ple": (write_census, 40, 8, {"cgc_0.task_exp_0.weight": (16, 3, 499)}),
    "esmm": (write_aliccp, 40, 8, {"embedding.embedding": (92244, 128)}),
    "aitm": (write_aliccp, 40, 8, {"embedding.embedding": (92244, 128)}),
    "escm2": (write_aliccp, 40, 8, {"embedding.embedding": (92244, 128)}),
    "dselect_k": (write_multimnist, 30, 8, {"experts.conv2.weight": (160, 10, 5, 5)}),
    "maml": (lambda d, n, s: write_omniglot(d, n, s), 6, 2, {"head.weight": (5, 64)}),
    "metaheac": (write_lookalike, 2 * 8 * 2 * 3, 8,
                 {"dynamic_3.embedding": (263313, 64), "static_2.embedding": (856, 64)}),
}
# what run_predict writes a row for (maml writes nothing)
PREDICTS = {"maml": None, "metaheac": "predictions"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_builds_at_full_width_and_a_small_copy_runs(tmp_path, name):
    write, rows, batch, leaves = CASES[name]
    config = os.path.join(REPO, "configs", "multitask", name, "config.yaml")
    cfg = load_config(config)
    assert cfg.runner("model") == f"multitask.{name}"
    full = port_trainer_mod.Trainer(cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in
              full.model_def.make_module(device="meta").state_dict().items()}
    for key, shape in leaves.items():
        assert shapes[key] == shape, (key, shapes[key])

    data, save, exported = (str(tmp_path / d) for d in ("data", "out", "exported"))
    write(data, rows, 7)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            f"runner.train_batch_size={batch}", f"runner.infer_batch_size={batch}",
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1",
            "runner.episodes_per_epoch=3",
            *(f"hyper_parameters.{k}={v}".replace(" ", "")
              for k, v in HYPER[f"multitask.{name}"].items())]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    metric = "acc" if name in ("maml",) else ("acc_left" if name == "dselect_k" else "auc")
    assert np.isfinite(metrics[metric]) and metrics["ips"] > 0
    params, opt_state, _ = port_ckpt.load_model(save, 1)
    small = port_trainer_mod.Trainer(load_config(config, parse_overrides(opts)), device="cpu")
    assert opt_state["count"] > 0
    assert sorted(params) == sorted(small.model_def.make_module(device="meta").state_dict())
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and np.isfinite(results[1][metric])

    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, report = port_predict.run_predict(exported, data, batch, device="cpu")
    assert report["batches"] >= 1 and report["qps"] > 0
    if name == "maml":
        assert out == []
        return
    preds = np.concatenate(out)
    assert np.isfinite(preds).all() and 0 <= preds.min() and preds.max() <= 1
    if name == "metaheac":
        assert preds.shape == (3 * 2 * 8,)  # three groups of two tasks × 8 queries
    elif name == "dselect_k":  # the left digit's confidence; two files, tails dropped
        assert preds.shape == (rows + rows // 3,)
    else:
        assert preds.shape[0] == rows


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    config = os.path.join(REPO, "configs", "multitask", "metaheac", "config.yaml")
    exported = str(tmp_path / "exported")
    port_export.main(["-m", config, "--export_dir", exported, "-o",
                      *(f"hyper_parameters.{k}={v}".replace(" ", "")
                        for k, v in HYPER["multitask.metaheac"].items())])
    data = str(tmp_path / "data")
    write_lookalike(data, 64, 1)
    calls = [
        lambda: port_export.load_exported(exported),
        lambda: port_predict.run_predict(exported, data, 8),
        lambda: RecService(exported),
        lambda: port_trainer_mod.Trainer(load_config(config)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
