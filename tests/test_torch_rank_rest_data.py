"""The last six rank models' readers and entry points in the port against
the JAX package: each dataset against its JAX class on the same written file
(bitwise, the tail batch and bert4rec's cloze masking included),
``Trainer.make_dataset`` and ``run_predict`` deferring to the model's
reader, ``run_predict`` on an exported naml and deeprec against the JAX
``run_predict`` (atol 1e-5), the registry, and every model's own
``configs/rank/<model>/config.yaml`` through ``tools.train``,
``tools.infer``, ``tools.export`` and ``tools.predict`` on the CPU at a
small size.  Writers of each format for quick fixtures live here."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.models.rank.bert4rec.model import Bert4RecDataset as JaxBert4Rec
from paddlerec_tpu.models.rank.deeprec.model import RatingVectorDataset as JaxRatings
from paddlerec_tpu.models.rank.iprec.model import IPRECDataset as JaxIPREC
from paddlerec_tpu.models.rank.naml.model import NewsDataset as JaxNews
from paddlerec_tpu.models.rank.sign.model import SIGNDataset as JaxSIGN
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu_torch.core.config import Config, load_config
from paddlerec_tpu_torch.core.registry import get_model_class, load_model_def
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.rank.bert4rec.model import Bert4RecDataset
from paddlerec_tpu_torch.models.rank.deeprec.model import RatingVectorDataset
from paddlerec_tpu_torch.models.rank.iprec.model import IPRECDataset
from paddlerec_tpu_torch.models.rank.naml.model import NewsDataset
from paddlerec_tpu_torch.models.rank.sign.model import SIGNDataset
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_rank_rest_common import HYPER, MODELS, flat_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 70  # two batches of 32 and a tail of 6


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_deeprec(data_dir, rows=ROWS, seed=0, n_items=257):
    """``idx:rating`` lines (an index out of range among them), then a file
    of ``user item rating`` triples for 10 more users."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows - 10):
        idx = rng.choice(n_items + 5, rng.randint(1, 12), replace=False)
        lines.append(" ".join(f"{i}:{rng.randint(1, 6)}" for i in idx))
    _write(os.path.join(data_dir, "part-0"), lines)
    triples = [f"{u} {rng.randint(0, n_items)} {rng.randint(1, 6)}"
               for u in range(10) for _ in range(rng.randint(1, 5))]
    _write(os.path.join(data_dir, "part-1"), triples)


def write_iprec(data_dir, rows=ROWS, seed=0):
    """JSON lines with ragged lists (some longer than the maxima) and one
    line that does not parse."""
    h, rng = HYPER["rank.iprec"], np.random.RandomState(seed)
    w = h["f_max_len"] + 2

    def ragged(hi, most):
        return [int(v) for v in rng.randint(1, hi, rng.randint(0, most + 3))]

    def packs(n):
        out = []
        for _ in range(rng.randint(0, n + 2)):
            out += [int(rng.randint(1, h["num_items"])), int(rng.randint(1, h["num_bizs"]))]
            out += ragged(h["num_users"], w - 2)[:w - 2]
            out += [0] * (len(out) % w and w - len(out) % w)
        return out

    lines = []
    for i in range(rows):
        row = {"user": int(rng.randint(0, 2 * h["num_users"])),
               "item": int(rng.randint(0, h["num_items"])),
               "biz": int(rng.randint(0, h["num_bizs"])),
               "friends": ragged(h["num_users"], h["f_max_len"]),
               "user_items": ragged(h["num_items"], h["u_max_i"]),
               "user_bizs": ragged(h["num_bizs"], h["u_max_i"]),
               "user_friends": ragged(h["num_users"], h["u_max_f"]),
               "user_packages": packs(h["u_max_pack"]),
               "pack_neighbors_b": packs(h["pack_max_nei_b"]),
               "pack_neighbors_f": packs(h["pack_max_nei_f"]),
               "label1": int(rng.rand() < 0.4), "label2": 0}
        lines.append(json.dumps(row))
        if i == 5:
            lines.append("{not json")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_news(data_dir, rows=ROWS, seed=0, model="rank.naml"):
    """``labels;cate_sample;cate_visit;sub_cate_sample;sub_cate_visit;
    title_sample;title_visit;content_sample;content_visit`` and one line
    with a group missing."""
    h, rng = HYPER[model], np.random.RandomState(seed)
    s, v = h["neg_condidate_sample_size"] + 1, h["browse_size"]
    words = h["word_dict_size"] + 1

    def ids(hi, n):
        return ",".join(map(str, rng.randint(0, hi, n)))

    lines = []
    for i in range(rows):
        labels = np.zeros(s, int)
        labels[rng.randint(0, s)] = 1
        lines.append(";".join([
            ",".join(map(str, labels)), ids(h["category_size"] + 1, s),
            ids(h["category_size"] + 1, v), ids(h["sub_category_size"] + 1, s),
            ids(h["sub_category_size"] + 1, v), ids(words, s * h["article_title_size"]),
            ids(words, v * h["article_title_size"]), ids(words, s * h["article_content_size"]),
            ids(words, v * h["article_content_size"])]))
        if i == 3:
            lines.append("1,0,0;1,2,3")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_fastformer(data_dir, rows=ROWS, seed=0):
    write_news(data_dir, rows, seed, "rank.fastformer")


def write_sign(data_dir, rows=ROWS, seed=0):
    """``label feat...`` with 1 to F+2 features (more than F are cut) and a
    line with no feature."""
    h, rng = HYPER["rank.sign"], np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        feats = rng.randint(0, h["n_feature"], rng.randint(1, h["num_nodes"] + 3))
        lines.append(" ".join([str(int(rng.rand() < 0.5))] + [str(x) for x in feats]))
        if i == 2:
            lines.append("1")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_bert4rec(data_dir, rows=ROWS, seed=0):
    """``uid item...`` with 2 to 1.5·T items (longer ones keep their last
    T), and a line of one item, which is skipped."""
    h, rng = HYPER["rank.bert4rec"], np.random.RandomState(seed)
    t = h["_max_position_seq_len"]
    lines = []
    for u in range(rows):
        items = rng.randint(1, h["_voc_size"] - 1, rng.randint(2, t * 3 // 2 + 1))
        lines.append(" ".join([str(u)] + [str(x) for x in items]))
        if u == 4:
            lines.append("99 7")
    _write(os.path.join(data_dir, "part-0"), lines)


WRITERS = {"rank.deeprec": write_deeprec, "rank.iprec": write_iprec, "rank.naml": write_news,
           "rank.fastformer": write_fastformer, "rank.sign": write_sign,
           "rank.bert4rec": write_bert4rec}


def _same_batches(port_ds, jax_ds):
    got, want = list(port_ds), list(jax_ds)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    return got


@pytest.mark.parametrize("model", MODELS)
def test_datasets_match_jax_bitwise(tmp_path, model):
    data = str(tmp_path / "data")
    WRITERS[model](data)
    files = list_data_files(data)
    h = HYPER[model]
    if model == "rank.deeprec":
        pair = (RatingVectorDataset(files, 257, 32), JaxRatings(files, 257, 32))
    elif model == "rank.iprec":
        jax_def = jax_model_class(model)(JaxConfig(flat_config(model)))
        port_def = get_model_class(model)(Config(flat_config(model)))
        pair = (IPRECDataset(port_def, files, 32), JaxIPREC(jax_def, files, 32))
    elif model in ("rank.naml", "rank.fastformer"):
        jax_def = jax_model_class(model)(JaxConfig(flat_config(model)))
        port_def = get_model_class(model)(Config(flat_config(model)))
        pair = (NewsDataset(port_def, files, 32), JaxNews(jax_def, files, 32))
    elif model == "rank.sign":
        pair = (SIGNDataset(files, h["num_nodes"], 32), JaxSIGN(files, h["num_nodes"], 32))
    else:
        args = (files, 32, h["_max_position_seq_len"], h["max_mask_per_seq"], h["_voc_size"])
        pair = (Bert4RecDataset(*args), JaxBert4Rec(*args))
    got = _same_batches(*pair)
    if model == "rank.iprec":  # the tail keeps its own size
        assert got[-1]["label"].shape[0] == ROWS - 64
    elif model == "rank.bert4rec":  # padded rows weigh nothing
        assert got[-1]["mask_weight"].shape[0] == 32
        assert (got[-1]["mask_weight"].sum(1) > 0).sum() == ROWS - 64
        assert (got[0]["src_ids"] == h["_voc_size"] - 1).sum() == got[0]["mask_weight"].sum()
    else:  # the tail is padded to the batch, the mask marks the real rows
        assert got[-1]["mask"].sum() == ROWS - 64 and got[-1]["mask"].shape == (32,)


@pytest.mark.parametrize("model", MODELS)
def test_trainer_reads_the_models_format(tmp_path, model):
    """``Trainer.make_dataset`` defers to the model's reader, for training and
    evaluation alike; deeprec runs no streaming metric, bert4rec counts its
    accuracy, the others their AUC."""
    data = str(tmp_path / "train")
    WRITERS[model](data)
    trainer = port_trainer_mod.Trainer(Config(flat_config(model, **{
        "runner.train_batch_size": 32, "runner.infer_batch_size": 32,
        "runner.train_data_dir": data, "runner.test_data_dir": data})), device="cpu")
    reader = type(trainer.model_def.make_dataset(data, 32))
    for drop_last in (True, False):
        assert type(trainer.make_dataset(data, 32, drop_last=drop_last)) is reader
    metrics = trainer.train()
    evaluated = trainer.evaluate()
    assert trainer.state.step == 3 and metrics["ips"] > 0 and evaluated["ips"] > 0
    if model == "rank.deeprec":
        assert sorted(metrics) == ["epoch_time", "ips"] and sorted(evaluated) == ["ips"]
    elif model == "rank.bert4rec":
        assert 0 <= metrics["acc"] <= 1 and 0 <= evaluated["acc"] <= 1
    else:
        candidates = HYPER[model].get("neg_condidate_sample_size", 0) + 1
        assert metrics["total_ins"] == ROWS * candidates and np.isfinite(metrics["auc"])
        assert evaluated["total_ins"] == metrics["total_ins"]


@pytest.fixture(scope="module", params=["rank.naml", "rank.deeprec"])
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
    """naml's predictions (1 + 2 negatives a row, not cut by the row mask)
    and deeprec's reconstructions (its ``outputs``, the padded rows
    dropped)."""
    model, jax_dir, port_dir, data = artifacts
    ref, _ = jax_predict.run_predict(jax_dir, data, 32)
    out, report = port_predict.run_predict(port_dir, data, 32, device="cpu")
    assert [o.shape for o in out] == [r.shape for r in ref]
    per_row = 3 if model == "rank.naml" else 1
    assert sum(len(o) for o in out) == (96 if per_row == 3 else ROWS) * per_row
    np.testing.assert_allclose(np.concatenate(out), np.concatenate(ref), rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(out)) > 0
    # the first batch warms up; the padded tail is not a full batch
    assert report["batches"] == 1 and report["qps"] > 0


def test_the_six_names_resolve():
    for model in MODELS:
        cls = get_model_class(model)
        assert cls.registry_name == model
        assert cls.__module__ == f"paddlerec_tpu_torch.models.{model}.model"
    assert get_model_class("rank.sign").stochastic
    assert get_model_class("rank.bert4rec").metrics == "acc"
    assert get_model_class("rank.deeprec").metrics == "none"


# the widths of the repo's configs, which set only the runner and Adam: each
# ModelDef's defaults, read off a module on the meta device
FULL_WIDTH = {
    "deeprec": {"encoder_0.weight": (512, 17769), "decoder_2.weight": (17769, 512)},
    "iprec": {"user_emb.embedding": (554238, 64), "biz_emb.embedding": (166466, 64),
              "intra_3_w.weight": (1, 128)},
    "naml": {"news_encoder.word2vec_embedding.embedding": (102, 30),
             "news_encoder.conv_title.weight": (400, 30, 3),
             "news_encoder.conv_content_bias": (400,)},
    "fastformer": {"news_encoder.title_attention.position_emb.embedding": (256, 400),
                   "news_encoder.content_attention.layer_1.inter.weight": (256, 400),
                   "news_encoder.conv_title.bias": (400,), "user_pos_emb": (1, 10, 400)},
    "sign": {"feature_emb.embedding": (1000, 8), "lp_fc1.weight": (32, 8)},
    "bert4rec": {"word_embedding.embedding": (54546, 64), "mask_lm_out_bias": (54546,),
                 "encoder_layer_1.ffn1.weight": (256, 64)},
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_config_through_every_entry_point_on_the_cpu(tmp_path, name):
    model = f"rank.{name}"
    config = os.path.join(REPO, "configs", "rank", name, "config.yaml")
    cfg = load_config(config)
    assert cfg.runner("model") == model
    shapes = {k: tuple(v.shape) for k, v in
              load_model_def(cfg).make_module(device="meta").state_dict().items()}
    for key, shape in FULL_WIDTH[name].items():
        assert shapes[key] == shape, (key, shapes[key])

    data, save, exported = (str(tmp_path / d) for d in ("train", "out", "exported"))
    WRITERS[model](data, seed=5)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1"]
    opts += [f"hyper_parameters.{k}={v}".replace(" ", "") for k, v in HYPER[model].items()]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    key = {"deeprec": "ips", "bert4rec": "acc"}.get(name, "auc")
    assert np.isfinite(metrics[key])
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and np.isfinite(results[1][key])
    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, report = port_predict.run_predict(exported, data, 32, device="cpu")
    if name == "bert4rec":  # no prediction key: batches only timed
        assert out == [] and report["batches"] >= 1
    else:
        preds = np.concatenate(out)
        assert np.isfinite(preds).all() and len(preds) >= ROWS
    port_predict.main(["--export_dir", exported, "--data_dir", data, "--batch_size", "32",
                       "--device", "cpu"])


@pytest.mark.parametrize("model", MODELS)
def test_entry_points_default_to_the_card(tmp_path, model):
    """Without ``device="cpu"`` the trainer and the artifact loader ask for
    ``cuda``, and raise where there is none: no path moves to the CPU on its
    own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    exported = str(tmp_path / "exported")
    port_export.export_model(Config(flat_config(model)), exported)
    for call in (lambda: port_trainer_mod.Trainer(Config(flat_config(model))),
                 lambda: port_export.load_exported(exported),
                 lambda: port_predict.run_predict(exported, str(tmp_path), 32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
