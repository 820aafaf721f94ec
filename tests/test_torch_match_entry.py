"""The match, content-understanding and recall models through the port's
entry points on the CPU: every model's own ``configs/<family>/<model>/
config.yaml`` (its full widths read off a module on the meta device) through
``tools.train``, ``tools.infer``, ``tools.export`` and ``tools.predict`` at a
small size; ``run_predict`` on an exported dssm, match_pyramid, textcnn and
kim against the JAX ``run_predict`` (atol 1e-5) and what it writes for the
models without predictions; ``cal_pos_neg`` on a served score file;
``analogy_eval`` on a word2vec checkpoint of the port against the JAX tool on
the converted one (equal accuracy); and the entry points' default device."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.tools import analogy_eval as jax_analogy
from paddlerec_tpu.tools import cal_pos_neg as jax_cal
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu.train import checkpoint as jax_ckpt
from paddlerec_tpu_torch.convert import to_jax_params
from paddlerec_tpu_torch.core.config import Config, load_config
from paddlerec_tpu_torch.core.registry import load_model_def
from paddlerec_tpu_torch.tools import analogy_eval as port_analogy
from paddlerec_tpu_torch.tools import cal_pos_neg as port_cal
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import checkpoint as port_ckpt
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_match_common import HYPER, MODELS, flat_config
from tests.test_torch_match_data import ROWS, WRITERS, write_word2vec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the widths of the repo's configs, which set only the runner and Adam: each
# ModelDef's defaults, read off a module on the meta device
FULL_WIDTH = {
    "match.dssm": {"query_tower.fc_0.weight": (300, 2900), "doc_tower.fc_2.weight": (128, 300)},
    "match.multiview_simnet": {"embedding.embedding": (89777, 128),
                               "query_proj.weight": (128, 128)},
    "match.match_pyramid": {"embedding.embedding": (193368, 50), "conv.weight": (8, 1, 2, 10),
                            "hidden.weight": (20, 6 * 50 * 8)},
    "match.kim": {"pair_model.title_word_embedding.embedding": (1891, 300),
                  "pair_model.conv.weight": (400, 300, 3),
                  "pair_model.word_attn.wq.weight": (400, 300),
                  "pair_model.pair_graph.gcat.attn.wq.weight": (100, 100)},
    "contentunderstanding.textcnn": {"embedding.embedding": (33257, 128),
                                     "conv_2.weight": (128, 128, 2),
                                     "hidden.weight": (96, 384), "head.weight": (2, 96)},
    "contentunderstanding.tagspace": {"text_emb.embedding": (75378, 10),
                                      "tag_emb.embedding": (4, 10),
                                      "conv.weight": (1000, 10, 5), "proj.weight": (10, 1000)},
    "recall.ncf": {"mf_user.embedding": (6040, 8), "mlp_item.embedding": (3706, 32),
                   "mlp_tower.fc_0.weight": (32, 64), "head.weight": (1, 16)},
    "recall.word2vec": {"in_emb.embedding": (1000, 300), "out_bias.embedding": (1000, 1)},
}
# what run_predict writes a row: predictions, or sim_pos; nothing for
# tagspace and word2vec (their aux has none of the keys it reads)
PER_ROW = {"match.kim": 2, "contentunderstanding.tagspace": 0, "recall.word2vec": 0}


def _config_path(model):
    family, name = model.split(".")
    return os.path.join(REPO, "configs", family, name, "config.yaml")


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
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1"]
    opts += [f"hyper_parameters.{k}={v}".replace(" ", "") for k, v in HYPER[model].items()]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    assert np.isfinite(metrics["auc"]) and metrics["total_ins"] > 0
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and np.isfinite(results[1]["auc"])
    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, report = port_predict.run_predict(exported, data, 32, device="cpu")
    per_row = PER_ROW.get(model, 1)
    if per_row == 0:
        assert out == [] and report["batches"] >= 1
    else:
        preds = np.concatenate(out)
        rows = ROWS if model != "recall.word2vec" else len(preds)
        assert np.isfinite(preds).all() and len(preds) >= rows * per_row
    port_predict.main(["--export_dir", exported, "--data_dir", data, "--batch_size", "32",
                       "--device", "cpu"])


@pytest.fixture(scope="module", params=["match.dssm", "match.match_pyramid",
                                        "contentunderstanding.textcnn", "match.kim"])
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
    """The same predictions (dssm's sim_pos; kim's 1 + 1 candidates a row,
    padded rows dropped), then ``cal_pos_neg`` on the score file they make:
    queries of four rows, the label of each row."""
    model, jax_dir, port_dir, data = artifacts
    ref, ref_report = jax_predict.run_predict(jax_dir, data, 32)
    out, report = port_predict.run_predict(port_dir, data, 32, device="cpu")
    assert [o.shape for o in out] == [r.shape for r in ref]
    preds = np.concatenate(out)
    # kim's mask is per row, its scores per candidate: the padded rows' stay
    assert len(preds) == (3 * 32 * 2 if model == "match.kim" else ROWS) and np.ptp(preds) > 0
    np.testing.assert_allclose(preds, np.concatenate(ref), rtol=0, atol=1e-5)
    # the same batches timed (a padded tail with a "label" counts as full)
    assert report["batches"] == ref_report["batches"] >= 1 and report["qps"] > 0
    batches = load_model_def(Config(flat_config(model))).make_dataset(data, 32)
    if model == "match.dssm":  # no label: the positive and a made-up negative
        labels = np.arange(len(preds)) % 2
    elif model == "match.kim":
        labels = np.concatenate([b["labels"].reshape(-1) for b in batches])
    else:
        labels = np.concatenate([b["label"][b["mask"] > 0] for b in batches])
    scores = os.path.join(os.path.dirname(data), "scores.txt")
    with open(scores, "w") as f:
        for i, (p, y) in enumerate(zip(preds, labels)):
            f.write(f"q{i // 4}\t{p}\t{int(y)}\n")
    got = port_cal.cal_pos_neg(scores)
    assert got == jax_cal.cal_pos_neg(scores) and got["pair_num"] > 0


def _word2vec_checkpoint(root):
    """A word2vec run of the port (two epochs) and its checkpoint in the JAX
    package's format, of the same parameters."""
    data = os.path.join(root, "data")
    write_word2vec(data, rows=40)
    save = os.path.join(root, "port_ckpt")
    flat = flat_config("recall.word2vec", **{
        "runner.train_data_dir": data, "runner.model_save_path": save,
        "runner.epochs": 2, "runner.train_batch_size": 32,
        "hyper_parameters.optimizer.learning_rate": 0.05})
    trainer = port_trainer_mod.Trainer(Config(flat), device="cpu")
    trainer.train()
    params = to_jax_params(port_ckpt.load_params_from_state(save, 1))
    jax_root = os.path.join(root, "jax_ckpt")
    jax_ckpt.save_model(params, {"count": np.zeros((), np.int32)}, jax_root, 1)
    return save, jax_root, params


def test_analogy_eval_matches_jax_on_the_converted_checkpoint(tmp_path, capsys):
    """Questions (a, b, c, d) where d is the nearest word to b - a + c in the
    trained table half of the time: the same accuracy from the port's tool
    (on its checkpoint) and the JAX tool (on the converted one); then the
    word-keyed questions through ``runner.word_id_dict_path``."""
    save, jax_root, params = _word2vec_checkpoint(str(tmp_path))
    emb = params["in_emb"]["embedding"]
    rng = np.random.RandomState(0)
    q = rng.randint(0, emb.shape[0], (60, 3))
    normed = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    dist = (emb[q[:, 1]] - emb[q[:, 0]] + emb[q[:, 2]]) @ normed.T
    for i in range(3):
        dist[np.arange(60), q[:, i]] = -np.inf
    d = np.where(rng.rand(60) < 0.5, dist.argmax(1), rng.randint(0, emb.shape[0], 60))
    qfile = str(tmp_path / "questions.txt")
    with open(qfile, "w") as f:
        f.write(": capital-common-countries\n")
        f.writelines(" ".join(map(str, row)) + "\n" for row in np.c_[q, d])
        f.write("1 2 3\n")
    config = _config_path("recall.word2vec")
    hyper = [f"hyper_parameters.{k}={v}" for k, v in HYPER["recall.word2vec"].items()]
    got = port_analogy.main(["-m", config, "--device", "cpu", "-o", *hyper,
                             f"runner.analogy_file={qfile}", f"runner.infer_load_path={save}"])
    want = jax_analogy.main(["-m", config, "-o", *hyper, f"runner.analogy_file={qfile}",
                             f"runner.infer_load_path={jax_root}"])
    assert got["questions"] == want["questions"] == 60
    assert got["analogy_acc"] == want["analogy_acc"] >= 0.5
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-2])["analogy_acc"] == got["analogy_acc"]
    # word-keyed questions: "w<id>" through the dict
    words = str(tmp_path / "words.txt")
    with open(words, "w") as f:
        f.writelines(f"w{i} {i}\n" for i in range(emb.shape[0]))
    wq = str(tmp_path / "word_questions.txt")
    with open(wq, "w") as f:
        f.writelines(" ".join(f"w{x}" for x in row) + "\n" for row in np.c_[q, d][:20])
        f.write("w1 w2 w3 unknown_word\n")
    extra = [f"runner.word_id_dict_path={words}", f"runner.analogy_file={wq}"]
    got = port_analogy.main(["-m", config, "--device", "cpu", "-o", *hyper, *extra,
                             f"runner.infer_load_path={save}", "runner.infer_epoch=1"])
    want = jax_analogy.main(["-m", config, "-o", *hyper, *extra,
                             f"runner.infer_load_path={jax_root}", "runner.infer_epoch=1"])
    assert got["questions"] == want["questions"] == 20
    assert got["analogy_acc"] == want["analogy_acc"]


@pytest.mark.parametrize("model", MODELS)
def test_entry_points_default_to_the_card(tmp_path, model):
    """Without ``device="cpu"`` the trainer, the artifact loader and the
    analogy tool ask for ``cuda``, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    exported = str(tmp_path / "exported")
    port_export.export_model(Config(flat_config(model)), exported)
    calls = [lambda: port_trainer_mod.Trainer(Config(flat_config(model))),
             lambda: port_export.load_exported(exported),
             lambda: port_predict.run_predict(exported, str(tmp_path), 32)]
    if model == "recall.word2vec":
        calls.append(lambda: port_analogy.main(["-m", _config_path(model)]))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
