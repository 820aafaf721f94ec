"""The sequence models' readers and entry points in the port against the JAX
package: each dataset against its JAX class on the same written file
(bitwise, the tail batch included), ``Trainer.make_dataset`` and
``run_predict`` deferring to the model's reader, ``run_predict`` on an
exported din against the JAX ``run_predict`` (atol 1e-5), the registry, and
every model's own ``configs/rank/<model>/config.yaml`` through
``tools.train``, ``tools.infer``, ``tools.export`` and ``tools.predict`` on
the CPU at a small size."""

import os

import jax
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.models.rank.din.model import DINDataset as JaxDIN
from paddlerec_tpu.models.rank.dmr.model import DMRDataset as JaxDMR
from paddlerec_tpu.models.rank.dpin.model import DPINDataset as JaxDPIN
from paddlerec_tpu.models.rank.dsin.model import DSINDataset as JaxDSIN
from paddlerec_tpu.tools import export as jax_export
from paddlerec_tpu.tools import predict as jax_predict
from paddlerec_tpu_torch.core.config import Config, load_config
from paddlerec_tpu_torch.core.registry import get_model_class, load_model_def
from paddlerec_tpu_torch.data.slot_reader import list_data_files
from paddlerec_tpu_torch.models.rank.din.model import DINDataset
from paddlerec_tpu_torch.models.rank.dmr.model import DMRDataset
from paddlerec_tpu_torch.models.rank.dpin.model import DPINDataset
from paddlerec_tpu_torch.models.rank.dsin.model import DSINDataset
from paddlerec_tpu_torch.tools import export as port_export
from paddlerec_tpu_torch.tools import infer as port_infer
from paddlerec_tpu_torch.tools import predict as port_predict
from paddlerec_tpu_torch.tools import train as port_train
from paddlerec_tpu_torch.train import trainer as port_trainer_mod
from tests.test_torch_seq_common import HYPER, MODELS, flat_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 70  # two batches of 32 and a tail of 6


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_din(data_dir, rows=ROWS, seed=0, t=8, items=300, cats=40):
    """``hist_items;hist_cats;item;cat;label``: histories of 0 to 1.5·t
    events (longer ones are cut to their last t), one malformed line."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        n = rng.randint(0, t * 3 // 2 + 1)
        lines.append(";".join([
            " ".join(map(str, rng.randint(1, items, n))),
            " ".join(map(str, rng.randint(1, cats, n))),
            str(rng.randint(0, items)), str(rng.randint(0, cats)),
            str(int(rng.rand() < 0.4))]))
        if i == 5:
            lines.append("1 2;3")
    _write(os.path.join(data_dir, "part-0"), lines[:40])
    _write(os.path.join(data_dir, "part-1"), lines[40:])


def write_dsin(data_dir, rows=ROWS, seed=0, s=3, length=4):
    """``label;15 ids;price;2S·L session ids;sess_length``, some rows with
    fewer fields or fewer session ids (zero-padded by the reader)."""
    h = HYPER["rank.dsin"]
    vocab = [v for k, v in h.items() if k.endswith("_size")]
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        sparse = [rng.randint(0, v) for v in vocab][: 15 if i % 9 else 13]
        ids = rng.randint(0, 120, 2 * s * length - (3 if i % 7 == 0 else 0))
        lines.append(";".join([str(int(rng.rand() < 0.4)), ",".join(map(str, sparse)),
                               f"{rng.rand():.6f}", ",".join(map(str, ids)),
                               str(rng.randint(0, s + 1))]))
    lines.insert(3, "0;1,2;0.5")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_dmr(data_dir, rows=ROWS, seed=0, t=6):
    """5·T history columns (btag, cate, brand, mask, match_mask), 16 ids,
    the price at column 5·T + 14, the label last."""
    h = HYPER["rank.dmr"]
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        n = rng.randint(0, t + 1)
        mask = (np.arange(t) >= t - n).astype(int)
        cols = [rng.randint(0, h["btag_size"], t), rng.randint(0, h["cate_size"], t),
                rng.randint(0, h["brand_size"], t), mask, mask]
        scalars = [rng.randint(0, h["user_size"])] + [rng.randint(0, 3) for _ in range(8)]
        scalars += [rng.randint(0, h["adgroup_id_size"]), rng.randint(0, h["cate_size"]),
                    rng.randint(0, h["campaign_id_size"]), rng.randint(0, h["customer_size"]),
                    rng.randint(0, h["brand_size"])]
        vals = [str(v) for c in cols for v in c] + [str(v) for v in scalars]
        vals += [f"{rng.rand():.6f}", str(rng.randint(0, 2)), str(int(rng.rand() < 0.4))]
        lines.append(",".join(vals))
    lines.insert(2, "1,2,3")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_dpin(data_dir, rows=ROWS, seed=0, k=3, length=4):
    """``target_item,target_cat;K·L items;K·L cats;K labels``."""
    h = HYPER["rank.dpin"]
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        lines.append(";".join([
            f"{rng.randint(0, h['max_item'])},{rng.randint(0, h['max_context'])}",
            ",".join(map(str, rng.randint(0, h["max_item"], k * length))),
            ",".join(map(str, rng.randint(0, h["max_context"], k * length))),
            ",".join(str(int(v)) for v in rng.rand(k) < 0.3)]))
    lines.insert(4, "1,2;3")
    _write(os.path.join(data_dir, "part-0"), lines)


WRITERS = {"rank.din": write_din, "rank.dien": write_din, "rank.bst": write_din,
           "rank.dsin": write_dsin, "rank.dmr": write_dmr, "rank.dpin": write_dpin}


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    return got


@pytest.mark.parametrize("name", ["din", "dsin", "dmr", "dpin"])
def test_datasets_match_jax_bitwise(tmp_path, name):
    data = str(tmp_path / name)
    WRITERS[f"rank.{name}"](data)
    files = list_data_files(data)
    pairs = {
        "din": (DINDataset(files, 8, 32), JaxDIN(files, 8, 32)),
        "dsin": (DSINDataset(files, 32, 3, 4), JaxDSIN(files, 32, 3, 4)),
        "dmr": (DMRDataset(files, 32, 6), JaxDMR(files, 32, 6)),
        "dpin": (DPINDataset(files, 32, 3, 4), JaxDPIN(files, 32, 3, 4)),
    }
    got = _same_batches(*pairs[name])
    if name == "dpin":  # no mask: the tail keeps its own size
        assert got[-1]["label"].shape[0] == ROWS - 64
    else:  # the tail is padded to the batch, the mask marks the real rows
        assert got[-1]["mask"].sum() == ROWS - 64 and got[-1]["mask"].shape == (32,)


@pytest.mark.parametrize("model", MODELS)
def test_trainer_and_predict_read_the_models_format(tmp_path, model):
    """``Trainer.make_dataset`` defers to the model's reader (its datasets
    take no ``drop_last``: the ``TypeError`` fallback), for training and
    evaluation alike."""
    data = str(tmp_path / "train")
    WRITERS[model](data)
    trainer = port_trainer_mod.Trainer(Config(flat_config(
        model, tmp_path, **{"runner.train_batch_size": 32, "runner.infer_batch_size": 32})),
        device="cpu")
    reader = type(trainer.model_def.make_dataset(data, 32))
    for drop_last in (True, False):
        assert type(trainer.make_dataset(data, 32, drop_last=drop_last)) is reader
    metrics = trainer.train()
    assert metrics["total_ins"] == (ROWS * HYPER[model].get("K", 1)) and np.isfinite(
        metrics["auc"])
    assert trainer.state.step == 3
    evaluated = trainer.evaluate()
    assert evaluated["total_ins"] == metrics["total_ins"]


@pytest.fixture(scope="module")
def din_artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("din")
    data = str(root / "data")
    write_din(data, seed=3)
    flat = flat_config("rank.din", **{"runner.train_data_dir": data,
                                      "runner.test_data_dir": data})
    jax_dir, port_dir = str(root / "jax_export"), str(root / "port_export")
    jax_export.export_model(JaxConfig(flat), jax_dir)
    _, params = jax_export.load_exported(jax_dir)
    port_export.export_model(Config(flat), port_dir, params=jax.tree.map(np.asarray, params))
    return jax_dir, port_dir, data


def test_run_predict_on_an_exported_din_matches_jax(din_artifacts):
    jax_dir, port_dir, data = din_artifacts
    ref, _ = jax_predict.run_predict(jax_dir, data, 32)
    out, report = port_predict.run_predict(port_dir, data, 32, device="cpu")
    assert [len(o) for o in out] == [len(r) for r in ref] == [32, 32, 6]
    np.testing.assert_allclose(np.concatenate(out), np.concatenate(ref), rtol=0, atol=1e-5)
    assert np.ptp(np.concatenate(out)) > 0
    # the first batch warms up; the padded tail is a full batch and counts
    assert report["batches"] == 2 and report["qps"] > 0


def test_the_six_names_resolve():
    for model in MODELS:
        cls = get_model_class(model)
        assert cls.registry_name == model
        assert cls.__module__ == f"paddlerec_tpu_torch.models.{model}.model"


# the widths of the repo's configs, which set only the runner and Adam: each
# ModelDef's defaults, read off a module on the meta device
FULL_WIDTH = {
    "din": {"item_emb.embedding": (63001, 64), "cat_emb.embedding": (801, 64),
            "item_b.embedding": (63001, 1)},
    "dien": {"extract_gru.wh.weight": (384, 128), "tower.fc_1.weight": (80, 200)},
    "bst": {"pos_emb.embedding": (256, 128), "block_0.ffn1.weight": (128, 128)},
    "dsin": {"adgroup_emb.embedding": (512431, 4), "bilstm.bwd_1.wi.weight": (32, 16)},
    "dmr": {"uid_emb.embedding": (1141730, 32), "inp_norm.scale": (459,),
            "dm_prelu.alpha": (1, 50, 1)},
    "dpin": {"item_feat_emb.embedding": (100000, 32), "transformer_11.q.weight": (64, 64)},
}
SMALL_OPTS = {
    "din": HYPER["rank.din"], "dien": HYPER["rank.dien"], "bst": HYPER["rank.bst"],
    "dsin": HYPER["rank.dsin"], "dmr": HYPER["rank.dmr"], "dpin": HYPER["rank.dpin"],
}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH))
def test_config_through_every_entry_point_on_the_cpu(tmp_path, name):
    config = os.path.join(REPO, "configs", "rank", name, "config.yaml")
    cfg = load_config(config)
    assert cfg.runner("model") == f"rank.{name}"
    shapes = {k: tuple(v.shape) for k, v in
              load_model_def(cfg).make_module(device="meta").state_dict().items()}
    for key, shape in FULL_WIDTH[name].items():
        assert shapes[key] == shape, (key, shapes[key])

    data, save, exported = (str(tmp_path / d) for d in ("train", "out", "exported"))
    WRITERS[f"rank.{name}"](data, seed=5)
    opts = [f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
            f"runner.model_save_path={save}", f"runner.infer_load_path={save}",
            "runner.print_interval=2", "runner.epochs=2", "runner.seed=1"]
    opts += [f"hyper_parameters.{k}={v}".replace(" ", "") for k, v in SMALL_OPTS[name].items()]
    metrics = port_train.main(["-m", config, "--device", "cpu", "-o", *opts])
    assert np.isfinite(metrics["auc"])
    results = port_infer.main(["-m", config, "--device", "cpu", "-o", *opts,
                               "runner.infer_end_epoch=2"])
    assert sorted(results) == [0, 1] and np.isfinite(results[1]["auc"])
    port_export.main(["-m", config, "--export_dir", exported, "--epoch", "1", "-o", *opts])
    out, _ = port_predict.run_predict(exported, data, 32, device="cpu")
    preds = np.concatenate(out)
    assert preds.shape == (ROWS * SMALL_OPTS[name].get("K", 1),)
    assert np.isfinite(preds).all() and 0 <= preds.min() and preds.max() <= 1
    port_predict.main(["--export_dir", exported, "--data_dir", data, "--batch_size", "32",
                       "--device", "cpu"])
