"""The readers of the match, content-understanding and recall models, the
word2vec negative sampler, the ranking metrics and ``cal_pos_neg`` in the
port against the JAX package: each dataset against its JAX class on the same
written files, bitwise (the tail batch, the padding and the random draws of
tagspace's negatives and word2vec's windows and negatives included);
``AliasSampler``'s tables and draws, the count readers, the ranking metrics
and ``cal_pos_neg``'s counts equal.  Writers of each format for quick
fixtures live here (``WRITERS``)."""

import os

import numpy as np
import pytest

from paddlerec_tpu.core import metrics as jax_metrics
from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.data import alias as jax_alias
from paddlerec_tpu.tools import cal_pos_neg as jax_cal
from paddlerec_tpu_torch.core import metrics as port_metrics
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.registry import get_model_class
from paddlerec_tpu_torch.data import alias as port_alias
from paddlerec_tpu_torch.tools import cal_pos_neg as port_cal
from tests.test_torch_match_common import ENT_DIM, HYPER, MODELS, flat_config

ROWS = 70  # two batches of 32 and a tail of 6


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_dssm(data_dir, rows=ROWS, seed=0):
    """``query<TAB>pos<TAB>neg...`` comma vectors, some short (zero-padded),
    some long (cut), and a line with too few columns."""
    h, rng = HYPER["match.dssm"], np.random.RandomState(seed)
    d, n = h["trigram_d"], h["neg_num"]

    def vec():
        return ",".join(str(int(v)) for v in rng.rand(rng.randint(d - 5, d + 5)) < 0.3)

    lines = []
    for i in range(rows):
        lines.append("\t".join(vec() for _ in range(2 + n)))
        if i == 4:
            lines.append(vec() + "\t" + vec())
    _write(os.path.join(data_dir, "part-0"), lines)


def write_multiview(data_dir, rows=ROWS, seed=0):
    """``q_slot;q_slot<TAB>t_slot`` of space-separated tokens, some longer than
    ``max_len``, a missing slot, and a line without a tab."""
    h, rng = HYPER["match.multiview_simnet"], np.random.RandomState(seed)

    def slot():
        return " ".join(map(str, rng.randint(0, h["sparse_feature_number"],
                                             rng.randint(1, h["max_len"] + 3))))

    lines = []
    for i in range(rows):
        q = ";".join(slot() for _ in range(h["query_slots"] - (i == 3)))
        lines.append(q + "\t" + ";".join(slot() for _ in range(h["title_slots"])))
        if i == 5:
            lines.append(slot())
    _write(os.path.join(data_dir, "part-0"), lines)


def write_match_pyramid(data_dir, rows=ROWS, seed=0):
    """``left<TAB>right[<TAB>label]`` comma lists, some too long, some
    without a label, and a line of one column."""
    h, rng = HYPER["match.match_pyramid"], np.random.RandomState(seed)

    def ids(size):
        return ",".join(map(str, rng.randint(0, h["vocab_size"], rng.randint(1, size + 4))))

    lines = []
    for i in range(rows):
        cols = [ids(h["sentence_left_size"]), ids(h["sentence_right_size"])]
        if i % 7:
            cols.append(str(int(rng.rand() < 0.5)))
        lines.append("\t".join(cols))
        if i == 2:
            lines.append(ids(3))
    _write(os.path.join(data_dir, "part-0"), lines)


def write_kim(data_dir, rows=ROWS, seed=0, news=40, entities=30, md=None):
    """``news.tsv``, ``graph.tsv``, ``entity_emb.npy`` and ``behaviors.tsv``
    at the widths of ``md`` (the small ``HYPER`` by default): titles and
    entity lists of ragged length, entities without neighbours, and
    behavior rows naming unknown news or no negative, which are skipped."""
    rng = np.random.RandomState(seed)
    if md is None:
        h = HYPER["match.kim"]
        vocab, w, e = h["vocab_size"], h["max_sentence"], h["max_entity_num"]
        s = h["max_sents"]
    else:
        vocab, w, e, s = md.vocab_size, md.max_sentence, md.max_entity, md.max_sents
    os.makedirs(data_dir, exist_ok=True)
    np.save(os.path.join(data_dir, "entity_emb.npy"),
            (rng.randn(entities, ENT_DIM) * 0.1).astype(np.float32))
    _write(os.path.join(data_dir, "news.tsv"), [
        f"N{i}\t{' '.join(map(str, rng.randint(0, 2 * vocab, rng.randint(1, w + 3))))}\t"
        f"{' '.join(map(str, rng.randint(0, entities, rng.randint(0, e + 2))))}"
        for i in range(news)])
    _write(os.path.join(data_dir, "graph.tsv"), [
        " ".join(map(str, [i] + list(rng.randint(0, entities, rng.randint(1, e + 3)))))
        for i in range(0, entities, 2)])
    lines = []
    for i in range(rows):
        clicked = ",".join(f"N{x}" for x in rng.randint(0, news, rng.randint(1, s + 3)))
        negs = ",".join(f"N{x}" for x in rng.randint(0, news, rng.randint(1, 4)))
        lines.append(f"{clicked}\tN{rng.randint(0, news)}\t{negs}")
        if i == 3:
            lines.append(f"{clicked}\tN{news + 7}\t{negs}")  # unknown positive
        if i == 4:
            lines.append(f"{clicked}\tN1\tN{news + 9}")  # no known negative
    _write(os.path.join(data_dir, "behaviors.tsv"), lines)


def write_textcnn(data_dir, rows=ROWS, seed=0, md=None):
    """``tok ... seq_len label`` senta lines, some longer than ``max_len``,
    and a line of two fields."""
    if md is None:
        h = HYPER["contentunderstanding.textcnn"]
        vocab, t = h["dict_dim"], h["max_len"]
    else:
        vocab, t = md.dict_dim, md.max_len
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        n = rng.randint(1, t + 4)
        toks = rng.randint(0, vocab, n)
        lines.append(" ".join(map(str, list(toks) + [n, int(rng.rand() < 0.5)])))
        if i == 1:
            lines.append("3 1")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_tagspace(data_dir, rows=ROWS, seed=0):
    """``tok tok ...<TAB>tag`` lines, some longer than ``max_len``, and a line
    without a tab."""
    h, rng = HYPER["contentunderstanding.tagspace"], np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        toks = rng.randint(0, h["vocab_text_size"], rng.randint(1, h["max_len"] + 4))
        lines.append(" ".join(map(str, toks)) + f"\t{rng.randint(0, 4)}")
        if i == 6:
            lines.append("1 2 3")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_ncf(data_dir, rows=ROWS, seed=0):
    """``user,item,label`` lines and a line of two fields."""
    h, rng = HYPER["recall.ncf"], np.random.RandomState(seed)
    lines = [f"{rng.randint(0, h['num_users'])},{rng.randint(0, h['num_items'])},"
             f"{int(rng.rand() < 0.4)}" for _ in range(rows)]
    lines.insert(3, "1,2")
    _write(os.path.join(data_dir, "part-0"), lines)


def write_word2vec(data_dir, rows=12, seed=0):
    """Token-id sentences of 2 to 9 words, skewed to low ids (a unigram
    distribution to sample negatives from), and an empty line."""
    h, rng = HYPER["recall.word2vec"], np.random.RandomState(seed)
    v = h["sparse_feature_number"]
    lines = [" ".join(map(str, np.minimum(rng.zipf(1.5, rng.randint(2, 10)), v) - 1))
             for _ in range(rows)]
    lines.insert(2, "")
    _write(os.path.join(data_dir, "part-0"), lines)


WRITERS = {"match.dssm": write_dssm, "match.multiview_simnet": write_multiview,
           "match.match_pyramid": write_match_pyramid, "match.kim": write_kim,
           "contentunderstanding.textcnn": write_textcnn,
           "contentunderstanding.tagspace": write_tagspace, "recall.ncf": write_ncf,
           "recall.word2vec": write_word2vec}


def _same_batches(port_ds, jax_ds):
    got, want = list(port_ds), list(jax_ds)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    return got


@pytest.mark.parametrize("model", MODELS)
def test_datasets_match_jax_bitwise(tmp_path, model):
    """Each model's ``make_dataset`` against the JAX ModelDef's on the same
    files, twice over (a second epoch continues the random draws)."""
    data = str(tmp_path / "data")
    WRITERS[model](data)
    jax_def = jax_model_class(model)(JaxConfig(flat_config(model)))
    port_def = get_model_class(model)(Config(flat_config(model)))
    port_ds, jax_ds = port_def.make_dataset(data, 32), jax_def.make_dataset(data, 32)
    for _ in range(2):
        got = _same_batches(port_ds, jax_ds)
    if model == "recall.word2vec":
        assert got[-1]["mask"].shape == (32,) and 0 < got[-1]["mask"].sum() < 32
    else:
        assert got[-1]["mask"].shape == (32,) and got[-1]["mask"].sum() == ROWS - 64


def test_word2vec_negatives_from_a_count_dict_and_uniform(tmp_path):
    """``runner.word_count_dict_path`` (a word-keyed dict among its lines)
    and ``neg_sampling: uniform``: the same batches as JAX's."""
    data = str(tmp_path / "data")
    write_word2vec(data)
    counts = np.arange(HYPER["recall.word2vec"]["sparse_feature_number"])[::-1] + 1.0
    dict_path = str(tmp_path / "dict.txt")
    port_alias.write_word_count_dict(dict_path, counts)
    with open(dict_path, "a") as f:
        f.write("some_word 5\n")
    for extra in ({"runner.word_count_dict_path": dict_path},
                  {"hyper_parameters.neg_sampling": "uniform"}):
        flat = flat_config("recall.word2vec", **extra)
        jax_ds = jax_model_class("recall.word2vec")(JaxConfig(flat)).make_dataset(data, 32)
        port_ds = get_model_class("recall.word2vec")(Config(flat)).make_dataset(data, 32)
        _same_batches(port_ds, jax_ds)
        assert (port_ds.neg_sampler is None) == ("hyper_parameters.neg_sampling" in extra)


def test_alias_sampler_tables_draws_and_counts(tmp_path):
    rng = np.random.RandomState(0)
    weights = rng.randint(1, 1000, 500).astype(np.float64)
    weights[[3, 7]] = 0.0  # ids that are never drawn
    for power in (0.75, 1.0):
        port = port_alias.AliasSampler(weights, power=power, seed=5)
        ref = jax_alias.AliasSampler(weights, power=power, seed=5)
        np.testing.assert_array_equal(port.prob, ref.prob)
        np.testing.assert_array_equal(port.alias, ref.alias)
        for shape in ((32, 5), (7,), ()):
            got, want = port.sample(shape), ref.sample(shape)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    draws = port_alias.AliasSampler(weights, seed=1).sample((200000,))
    assert not np.isin(draws, [3, 7]).any()
    # the unigram^0.75 distribution, each id within five standard deviations
    want = weights ** 0.75 / (weights ** 0.75).sum()
    freq = np.bincount(draws, minlength=500) / len(draws)
    assert np.all(np.abs(freq - want) <= 5 * np.sqrt(want / len(draws)) + 1e-12)
    for bad in (np.array([1.0, -1.0]), np.zeros(3)):
        for mod in (port_alias, jax_alias):
            with pytest.raises(ValueError):
                mod.build_alias(bad)
    corpus = str(tmp_path / "corpus")
    _write(corpus, ["1 2 2 3", "", "9 2 999 -1"])
    np.testing.assert_array_equal(port_alias.counts_from_corpus([corpus], 10),
                                  jax_alias.counts_from_corpus([corpus], 10))
    path = str(tmp_path / "dict")
    _write(path, ["3 7", "the 4", "", "12 5", "1"])
    np.testing.assert_array_equal(port_alias.counts_from_dict_file(path, 10),
                                  jax_alias.counts_from_dict_file(path, 10))


def test_ranking_metrics_equal_jax():
    rng = np.random.RandomState(0)
    pos, neg = rng.rand(40), rng.rand(60)
    neg[:5] = pos[:5]  # ties count half
    ranks = rng.randint(1, 30, 50)
    for name, args in (("positive_order_ratio", (pos, neg)),
                       ("positive_order_ratio", (pos, [])),
                       ("hit_ratio_at_k", (ranks, 10)), ("hit_ratio_at_k", ([], 10)),
                       ("ndcg_at_k", (ranks, 10)), ("ndcg_at_k", ([], 10)),
                       ("recall_at_k", (7, 20)), ("recall_at_k", (0, 0))):
        got = getattr(port_metrics, name)(*args)
        want = getattr(jax_metrics, name)(*args)
        assert type(got) is type(want) and got == want, name


def test_cal_pos_neg_counts_equal_jax(tmp_path, capsys):
    """Blocks of queries with ties (after the rounding to six decimals), a
    query of one label only and malformed lines."""
    rng = np.random.RandomState(0)
    lines = []
    for q in range(30):
        for _ in range(rng.randint(1, 8)):
            score = round(rng.rand(), 3) if q % 3 else 0.5 + rng.rand() * 1e-8
            label = 1 if q == 4 else int(rng.rand() < 0.5)
            lines.append(f"q{q}\t{score}\t{label}")
    lines.insert(5, "broken line")
    path = str(tmp_path / "scores.txt")
    _write(path, lines)
    got, want = port_cal.cal_pos_neg(path), jax_cal.cal_pos_neg(path)
    assert got == want and got["equal_num"] > 0 and got["query_num"] == 30
    assert port_cal.main([path]) == jax_cal.main([path]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:] and out[0].startswith("pnr:")
    assert port_cal.main([]) == 2
