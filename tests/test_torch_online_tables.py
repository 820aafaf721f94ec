"""Per-table bookkeeping of the port's online loop on the models with
several independent tables (din: item, category and item-bias tables;
dien: item and category): their ``touched_tables`` hooks against the JAX
package's (bitwise), the deltas that cover every table, and a shrink that
acts on one table only."""

import json
import os

import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import load_model_def as jax_model_def
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import load_model_def
from paddlerec_tpu_torch.train.online import OnlineTrainer

torch.set_num_threads(1)

DAY = "20240101"
ITEMS, CATS = 200, 40
TABLES = {"rank.din": {"item_emb/embedding", "cat_emb/embedding", "item_b/embedding"},
          "rank.dien": {"item_emb/embedding", "cat_emb/embedding"}}


def _write_din_data(path, n_lines=64, seed=0):
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(path, "part-0.txt"), "w") as f:
        for _ in range(n_lines):
            hlen = rng.randint(1, 6)
            hist_i = " ".join(str(rng.randint(1, ITEMS)) for _ in range(hlen))
            hist_c = " ".join(str(rng.randint(1, CATS)) for _ in range(hlen))
            f.write(f"{hist_i};{hist_c};{rng.randint(1, ITEMS)};"
                    f"{rng.randint(1, CATS)};{rng.randint(0, 2)}\n")


def _flat(model, tmp_path):
    return {
        "runner.model": model,
        "runner.train_data_dir": str(tmp_path / "data"),
        "runner.model_save_path": str(tmp_path / "out"),
        "runner.train_batch_size": 16,
        "runner.split_interval": 720,  # 2 passes a day; only the first has data
        "runner.split_per_pass": 1,
        "runner.checkpoint_per_pass": 1,
        "runner.save_delta_frequency": 1,
        "runner.start_day": DAY,
        "runner.end_day": DAY,
        "runner.infer_first": False,
        "hyper_parameters.item_count": ITEMS,
        "hyper_parameters.cat_count": CATS,
        "hyper_parameters.item_emb_size": 8,
        "hyper_parameters.cat_emb_size": 8,
        "hyper_parameters.gru_hidden": 8,
        "hyper_parameters.fc_sizes": [16, 8],
        "hyper_parameters.attention_sizes": [8],
        "hyper_parameters.optimizer.class": "adam",
        "hyper_parameters.optimizer.learning_rate": 0.001,
    }


@pytest.mark.parametrize("model", sorted(TABLES))
def test_touched_tables_match_jax(model, tmp_path):
    _write_din_data(str(tmp_path / "data"), n_lines=40)
    flat = _flat(model, tmp_path)
    port, ref = load_model_def(Config(dict(flat))), jax_model_def(JaxConfig(dict(flat)))
    batches = list(port.make_dataset(str(tmp_path / "data"), 16))
    assert len(batches) == 3 and batches[-1]["mask"].sum() == 8  # a padded tail
    for batch in batches:
        got, want = port.touched_tables(batch), ref.touched_tables(batch)
        assert set(got) == set(want) == TABLES[model]
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    # bst reads din's rows but keeps the default mapping, as in the JAX package
    bst = dict(flat, **{"runner.model": "rank.bst"})
    assert load_model_def(Config(bst)).touched_tables(batches[0]) is None
    assert jax_model_def(JaxConfig(bst)).touched_tables(batches[0]) is None


@pytest.mark.parametrize("model", sorted(TABLES))
def test_delta_covers_every_table(model, tmp_path):
    _write_din_data(str(tmp_path / "data" / DAY / "0000"))
    flat = _flat(model, tmp_path)
    trainer = OnlineTrainer(Config(flat), device="cpu")
    trainer.run()
    delta_dir = tmp_path / "out" / f"delta_{DAY}_0"
    meta = json.loads((delta_dir / "delta_meta.json").read_text())
    names = {n.replace("/", "_") for n in TABLES[model]}
    assert {t["name"] for t in meta["tables"]} == names
    # the touched rows of each table: its hook's rows over the pass's batches
    hooked = {}
    for batch in trainer.make_dataset(str(tmp_path / "data" / DAY / "0000"), 16):
        for name, rows in jax_model_def(JaxConfig(dict(flat))).touched_tables(batch).items():
            hooked.setdefault(name, []).append(rows)
    state = trainer.state.module.state_dict()
    for name in TABLES[model]:
        npz = np.load(delta_dir / f"{name.replace('/', '_')}_delta.npz")
        np.testing.assert_array_equal(npz["rows"], np.unique(np.concatenate(hooked[name])))
        # no row was evicted at the day's end: the values are the table's
        table = state[name.replace("/", ".")]
        np.testing.assert_array_equal(npz["values"], table[npz["rows"]].numpy())
        assert npz["values"].shape[1] == table.shape[1]
    assert meta["rows_touched"] == sum(len(np.unique(np.concatenate(r)))
                                       for r in hooked.values())
    assert set(trainer.stats) == TABLES[model]


def test_dien_shrink_is_per_table(tmp_path):
    _write_din_data(str(tmp_path / "data" / DAY / "0000"))
    trainer = OnlineTrainer(Config(_flat("rank.dien", tmp_path)), device="cpu")
    trainer.run()
    # evict everything seen in the category table only
    cat = trainer.stats["cat_emb/embedding"]
    cat.decay, cat.delete_threshold = 0.0, 10.0
    keep = trainer.stats["item_emb/embedding"]
    keep.delete_threshold, keep.delete_after_unseen_days = -1.0, 10**6
    seen = np.nonzero(cat.seen)[0]
    items_before = trainer.state.module.item_emb.embedding.detach().clone()
    mu = trainer.state.opt_state["mu"]
    assert trainer.shrink() == len(seen) > 0
    cat_table = trainer.state.module.cat_emb.embedding.detach()
    assert not cat_table[seen].any() and not mu["cat_emb.embedding"][seen].any()
    assert not trainer.state.opt_state["nu"]["cat_emb.embedding"][seen].any()
    unseen = np.setdiff1d(np.arange(CATS), seen)
    assert cat_table[unseen].abs().sum(dim=1).gt(0).all()
    assert torch.equal(trainer.state.module.item_emb.embedding.detach(), items_before)
