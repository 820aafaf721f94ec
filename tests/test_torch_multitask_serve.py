"""The evaluation and the served predictions of maml and metaheac, whose
inference adapts to each task by a gradient step (the entry points enable
gradients for them): ``Trainer.evaluate()`` and ``run_predict`` on the CPU
against the JAX package's, from the same parameters on the same files."""

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import predict as port_predict
from tests.test_torch_multitask_common import flat_config
from tests.test_torch_multitask_data import write_lookalike, write_omniglot
from tests.test_torch_multitask_train import _pair

torch.set_num_threads(1)


WRITERS = {"multitask.maml": lambda d: write_omniglot(d, 6, 11),
           "multitask.metaheac": lambda d: write_lookalike(d, 2 * 8 * 2 * 3, 11)}


@pytest.mark.parametrize("model", sorted(WRITERS))
def test_evaluate_and_predict_match_jax(tmp_path, model):
    """Both packages from the JAX package's initial parameters: the
    evaluation's metric, and ``run_predict``'s outputs (metaheac's query
    predictions after adaptation; maml writes none, as in the JAX tool)."""
    data = str(tmp_path / "data")
    WRITERS[model](data)
    flat = flat_config(model, **{"runner.test_data_dir": data, "runner.train_data_dir": data,
                                 "runner.episodes_per_epoch": 3})
    ref, port = _pair(flat)
    want, got = ref.evaluate(), port.evaluate()
    key = "acc" if model == "multitask.maml" else "auc"
    assert got[key] == pytest.approx(want[key], abs=1e-6), (got, want)
    assert 0 < got[key] < 1

    jax_dir, port_dir = str(tmp_path / "jax_export"), str(tmp_path / "port_export")
    jax_export.export_model(JaxConfig(flat), jax_dir)
    _, params = jax_export.load_exported(jax_dir)
    port_export.export_model(Config(flat), port_dir,
                             params=jax.tree.map(np.asarray, params))
    batch = int(flat["runner.infer_batch_size"])
    ref_out, _ = jax_predict.run_predict(jax_dir, data, batch)
    out, report = port_predict.run_predict(port_dir, data, batch, device="cpu")
    assert len(out) == len(ref_out) and report["batches"] >= 1
    if model == "multitask.maml":
        assert out == [] and ref_out == []
        return
    for o, r in zip(out, ref_out):
        np.testing.assert_allclose(o, np.asarray(r), rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(out)) > 0
