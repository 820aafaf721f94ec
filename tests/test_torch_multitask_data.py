"""The multitask family's five readers against the JAX package's, bitwise,
through each ``ModelDef.make_dataset`` on files in each format: Census CSV
(labels reordered to (income, marital), short rows zero-padded, the padded
tail), Ali-CCP slot lines (ids beyond ``max_len`` per field dropped, unknown
fields skipped, the padded tail), MultiMNIST pickles (the masked tail),
Omniglot ``.npy`` trees (the episodes of ``RandomState(12345)``) and
Lookalike pickles of an ``np.ndarray`` (task-major support/query pairs)."""

import os
import pickle

import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.models.multitask.base import ALI_CCP_FIELDS
from tests.test_torch_multitask_common import FEATURES, MAX_IDXS, flat_config

torch.set_num_threads(1)


def write_census(d, rows, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(rows):
        n = FEATURES if i % 4 else rng.randint(1, FEATURES)  # short rows too
        vals = [int(rng.rand() < 0.5), int(rng.rand() < 0.3)]
        vals += [round(float(v), 4) for v in rng.rand(n)]
        lines.append(",".join(str(v) for v in vals))
    lines.insert(3, "1,0")  # fewer than three values: skipped
    with open(os.path.join(d, "part-0"), "w") as f:
        f.write("\n".join(lines[:rows // 2]) + "\n")
    with open(os.path.join(d, "part-1"), "w") as f:
        f.write("\n".join(lines[rows // 2:]) + "\n")


def write_aliccp(d, rows, seed, vocab=300):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(rows):
        click = int(rng.rand() < 0.4)
        feats = []
        for f in ALI_CCP_FIELDS + ["999"]:  # an unknown field too
            for _ in range(rng.randint(0, 5)):  # up to 4 ids: beyond max_len 3
                feats.append(f"{f}:{rng.randint(0, 3 * vocab)}")
        rng.shuffle(feats)
        lines.append(",".join([str(i), str(click), str(click * int(rng.rand() < 0.5)), "7"]
                              + feats))
    lines.insert(2, "1,0,0,3")  # fewer than five parts: skipped
    with open(os.path.join(d, "part-0"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_multimnist(d, rows, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for i, n in enumerate((rows, rows // 3)):
        x = rng.randint(0, 256, (n, 36 * 36)).astype(np.uint8)
        y = rng.randint(0, 10, (n, 2))
        with open(os.path.join(d, f"part-{i}.pickle"), "wb") as f:
            pickle.dump((x, y), f)
    with open(os.path.join(d, "README"), "w") as f:  # not a pickle: ignored
        f.write("multimnist\n")


def write_omniglot(d, chars, seed, side=16, per_char=5):
    rng = np.random.RandomState(seed)
    for c in range(chars):
        sub = os.path.join(d, f"alphabet_{c % 2}", f"character{c:02d}")
        os.makedirs(sub, exist_ok=True)
        for j in range(per_char):
            np.save(os.path.join(sub, f"{j:02d}.npy"), rng.rand(side, side).astype(np.float32))


def write_lookalike(d, rows, seed):
    """Rows of 72 columns: label, aid, 7 static, 50 dynamic ids, 7 lengths, 6 ad."""
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    static, dynamic, ad = MAX_IDXS
    cols = [(rng.rand(rows) < 0.4).astype(np.int64), np.arange(rows) // 10]
    cols += [rng.randint(0, v + 1, rows) for v in static]
    cols += [rng.randint(0, v + 1, rows) for v, w in zip(dynamic, (10, 10, 10, 5, 5, 5, 5))
             for _ in range(w)]
    cols += [rng.randint(1, w + 1, rows) for w in (10, 10, 10, 5, 5, 5, 5)]
    cols += [rng.randint(0, v + 1, rows) for v in ad]
    table = np.stack(cols, -1)
    assert table.shape == (rows, 72)
    with open(os.path.join(d, "train.pkl"), "wb") as f:
        pickle.dump(table, f)


CASES = {
    "multitask.mmoe": (write_census, 37),
    "multitask.esmm": (write_aliccp, 21),
    "multitask.dselect_k": (write_multimnist, 19),
    "multitask.maml": (lambda d, n, s: write_omniglot(d, n, s), 6),
    "multitask.metaheac": (write_lookalike, 2 * 8 * 2 * 2 + 5),  # 2 steps and a rest
}


@pytest.mark.parametrize("model", sorted(CASES))
def test_reader_matches_jax(tmp_path, model):
    write, rows = CASES[model]
    data = str(tmp_path / "data")
    write(data, rows, 3)
    flat = flat_config(model, **{"runner.episodes_per_epoch": 3})
    batch = int(flat["runner.train_batch_size"])
    jax_batches = list(jax_model_class(model)(JaxConfig(flat)).make_dataset(data, batch))
    port_batches = list(port_model_class(model)(Config(flat)).make_dataset(data, batch))
    assert len(port_batches) == len(jax_batches) >= 2
    for got, want in zip(port_batches, jax_batches):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
    if "mask" in jax_batches[-1]:  # a padded tail, its rows kept and masked
        assert 0 < jax_batches[-1]["mask"].sum() < batch


def test_census_labels_come_out_income_first(tmp_path):
    d = str(tmp_path / "census")
    os.makedirs(d)
    with open(os.path.join(d, "part-0"), "w") as f:
        f.write("1,0,0.5,0.25\n0,1,0.75\n")
    md = port_model_class("multitask.mmoe")(Config(flat_config("multitask.mmoe")))
    (batch,) = list(md.make_dataset(d, 4))
    np.testing.assert_array_equal(batch["labels"][:2], [[0.0, 1.0], [1.0, 0.0]])
    np.testing.assert_array_equal(batch["dense"][1, :2], [0.75, 0.0])
    np.testing.assert_array_equal(batch["mask"], [1, 1, 0, 0])


def test_aliccp_drops_ids_beyond_max_len_per_field(tmp_path):
    d = str(tmp_path / "aliccp")
    os.makedirs(d)
    with open(os.path.join(d, "part-0"), "w") as f:
        f.write("0,1,0,3,101:5,101:6,205:9,101:7,101:8,999:1\n")
    md = port_model_class("multitask.esmm")(Config(flat_config("multitask.esmm")))
    (batch,) = list(md.make_dataset(d, 2))
    np.testing.assert_array_equal(batch["sparse"][0, 0], [5, 6, 7])
    np.testing.assert_array_equal(batch["sparse"][0, ALI_CCP_FIELDS.index("205")], [9, 0, 0])
    assert batch["sparse_mask"][0].sum() == 4 and batch["mask"].tolist() == [1, 0]


def test_lookalike_pairs_support_and_query_of_one_task(tmp_path):
    """Each task's support and query are its 2·batch consecutive rows."""
    d = str(tmp_path / "lookalike")
    write_lookalike(d, 2 * 8 * 2, 5)
    with open(os.path.join(d, "train.pkl"), "rb") as f:
        rows = pickle.load(f)
    md = port_model_class("multitask.metaheac")(Config(flat_config("multitask.metaheac")))
    (batch,) = list(md.make_dataset(d, 8))
    for t in range(2):
        np.testing.assert_array_equal(batch["spt_static"][t], rows[16 * t:16 * t + 8, 2:9])
        np.testing.assert_array_equal(batch["qry_static"][t], rows[16 * t + 8:16 * t + 16, 2:9])
