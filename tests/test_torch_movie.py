"""The movie demo in the port against the JAX package: ``TwoTower`` (its
``towers``, ``user_vector`` and ``movie_vector``) and ``RankDNN`` with every
gradient, ``ann_topk``, ``VectorIndex`` in its three metrics with its files
read both ways, and the five services of ``serving/movie_recommender.py``
(um, cm, recall, rank, as) with the HTTP front door, from the same
parameters.

Tolerances: outputs, losses and every gradient 1e-5; scores 1e-5 and ids
equal, in order, ties included (``top_k`` orders ties as ``jax.lax.top_k``);
the services' ordered movie ids equal and scores 1e-5; the HTTP answers equal
to ``recommend()`` and the error answers (404, 400) equal to the JAX
server's."""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlerec_tpu.core.config import Config as JaxConfig
from paddlerec_tpu.core.registry import get_model_class as jax_model_class
from paddlerec_tpu.models.demo.movie_recommand import model as jax_movie
from paddlerec_tpu.serving import movie_recommender as jax_rec
from paddlerec_tpu.serving.vector_index import VectorIndex as JaxIndex
from paddlerec_tpu_torch.convert import from_jax_params, to_jax_params
from paddlerec_tpu_torch.core.config import Config
from paddlerec_tpu_torch.core.device import to_tensors
from paddlerec_tpu_torch.core.registry import get_model_class as port_model_class
from paddlerec_tpu_torch.models.demo.movie_recommand import model as port_movie
from paddlerec_tpu_torch.serving import movie_recommender as port_rec
from paddlerec_tpu_torch.serving.vector_index import VectorIndex as PortIndex

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = {"hyper_parameters.sparse_feature_number": 5000,
         "hyper_parameters.fc_sizes": [64, 32]}
MODELS = ("demo.movie_recall", "demo.movie_rank")


def _build(name, seed=0):
    jax_def = jax_model_class(name)(JaxConfig(SMALL))
    port_def = port_model_class(name)(Config(SMALL))
    params = jax.tree.map(np.asarray, jax_def.init_params(jax.random.PRNGKey(seed)))
    module = port_def.make_module(device="cpu")
    module.load_state_dict(from_jax_params(params))
    return jax_def, params, port_def, module


def _batch(md, rows, seed):
    b = md.example_batch(rows)
    rng = np.random.RandomState(seed)
    for k in ("user_sparse", "title", "genres"):
        b[k] = rng.randint(1, md.vocab, b[k].shape).astype(np.int64)
    b["movie_id"] = rng.randint(1, md.vocab, rows).astype(np.int64)
    b["title_mask"] = (rng.rand(*b["title"].shape) < 0.6).astype(np.float32)
    b["genre_mask"] = (rng.rand(*b["genres"].shape) < 0.5).astype(np.float32)
    b["title_mask"][0] = 0.0  # an empty title: a zero bag
    b["title"][1, :3] = b["title"][1, 3]  # a word repeated in one bag
    b["user_sparse"][:, 1] = 1 + rng.randint(0, 2, rows)  # gender: two ids, many adds
    b["label"] = rng.randint(1, 6, rows).astype(np.float32)
    return b


@pytest.mark.parametrize("name", MODELS)
def test_forward_loss_and_every_gradient_match_flax(name):
    jax_def, params, port_def, module = _build(name)
    batch = _batch(port_def, 12, 1)
    (want, aux), grads = jax.value_and_grad(jax_def.train_forward, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch))
    loss, port_aux = port_def.train_forward(module, to_tensors(batch, CPU))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port_aux["predictions"].detach().numpy(),
                               np.asarray(aux["predictions"]), rtol=0, atol=1e-5)
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    table = got["SparseFeatFactors.embedding"].grad
    assert float(table[1:3].abs().sum()) > 0  # the gender rows took their adds


def test_towers_and_vectors_match_flax():
    jax_def, params, port_def, module = _build("demo.movie_recall")
    batch = _batch(port_def, 9, 2)
    jb, pb = jax.tree.map(jnp.asarray, batch), to_tensors(batch, CPU)
    want_u, want_m = jax_def.module.apply({"params": params}, *jax_def.model_inputs(jb),
                                          method=jax_movie.TwoTower.towers)
    got_u, got_m = module.towers(*port_def.model_inputs(pb))
    for got, want in ((got_u, want_u), (got_m, want_m),
                      (port_def.user_vector(module, pb), jax_def.user_vector(params, jb)),
                      (port_def.movie_vector(module, pb), jax_def.movie_vector(params, jb))):
        assert got.shape == want.shape == (9, 32)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the gradient of a weighted user vector reaches the table and the user tower
    w = np.random.RandomState(3).randn(9, 32).astype(np.float32)
    grads = jax.grad(lambda p: (jax_def.user_vector(p, jb) * w).sum())(params)
    (port_def.user_vector(module, pb) * torch.from_numpy(w)).sum().backward()
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    for k, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_names_and_round_trip_match_flax(name):
    _, params, _, module = _build(name)
    assert sorted(module.state_dict()) == sorted(from_jax_params(params))
    back = to_jax_params(from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    towers = {"user_fc0", "user_fc1", "movie_fc0", "movie_fc1"}
    assert set(params) == ({"SparseFeatFactors"} | (
        towers if name == "demo.movie_recall" else {"fc0", "fc1", "out"}))


def _catalogue(rows=60, dim=16, seed=0):
    """Vectors with exact ties: repeated rows, a copy scaled by a power of 2
    (equal cosine, bit for bit), and zero rows."""
    v = np.random.RandomState(seed).randn(rows, dim).astype(np.float32)
    v[10] = v[3]
    v[11] = v[3]
    v[20] = 4.0 * v[4]
    v[30:33] = 0.0
    return v


def test_ann_topk_matches_jax_with_ties():
    movies = _catalogue()
    users = np.concatenate([movies[[3, 4, 30]], np.random.RandomState(1).randn(5, 16)]
                           ).astype(np.float32)
    for k in (1, 7, 60, 100):
        want_v, want_i = jax_movie.ann_topk(users, movies, k)
        got_v, got_i = port_movie.ann_topk(users, movies, k, device="cpu")
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    assert list(got_i[0, :3]) == [3, 10, 11]  # the tie, lower index first


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
def test_vector_index_matches_jax_and_reads_its_files(metric, tmp_path):
    vecs = _catalogue()
    ids = list(range(1000, 1060))
    jax_idx, port_idx = JaxIndex(metric), PortIndex(metric, device="cpu")
    for idx in (jax_idx, port_idx):
        idx.insert(vecs[:40], ids=ids[:40])
        idx.search(vecs[:2], topk=3)  # caches the device copy
        idx.insert(vecs[40:])  # ids continue from the count; the copy is reset
    assert len(port_idx) == len(jax_idx) == 60
    queries = np.concatenate([vecs[[3, 4, 30, 45]], np.random.RandomState(2).randn(4, 16)]
                             ).astype(np.float32)
    for k in (5, 60, 80):
        want_s, want_ids = jax_idx.search(queries, topk=k)
        got_s, got_ids = port_idx.search(queries, topk=k)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5 * max(1, np.abs(want_s).max()))
    port_idx.save(str(tmp_path / "port"))
    jax_idx.save(str(tmp_path / "jax"))
    for loaded, ref in ((JaxIndex.load(str(tmp_path / "port")), port_idx),
                        (PortIndex.load(str(tmp_path / "jax.npz"), device="cpu"), jax_idx)):
        assert loaded.metric == metric and len(loaded) == 60
        np.testing.assert_array_equal(loaded.search(queries, 5)[1], ref.search(queries, 5)[1])


def _services(pkg, index_cls, recall, rank, rows, users, **index_kw):
    """um, cm, recall and rank services over ``rows`` (an example batch of
    movies) and the first ``users`` rows' user fields, behind an
    ApplicationServer; recall and rank are (model_def, params or module)."""
    (recall_def, recall_p), (rank_def, rank_p) = recall, rank
    is_jax = index_cls is JaxIndex
    feed = jax.tree.map(jnp.asarray, rows) if is_jax else to_tensors(rows, CPU)
    movie_vecs = np.asarray(recall_def.movie_vector(recall_p, feed).detach()
                            if not is_jax else recall_def.movie_vector(recall_p, feed))
    user_vecs = np.asarray(recall_def.user_vector(recall_p, feed).detach()
                           if not is_jax else recall_def.user_vector(recall_p, feed))
    um, cm = pkg.UserModelService(), pkg.ContentModelService()
    index = index_cls("cosine", **index_kw)
    mids = [int(m) for m in rows["movie_id"]]
    index.insert(movie_vecs, ids=mids)
    for j, mid in enumerate(mids):
        cm.put(mid, {k: rows[k][j] if k != "movie_id" else mid
                     for k in ("movie_id", "title", "genres", "title_mask", "genre_mask")})
    store = {}
    for u in range(users):
        um.put(u, {"user_sparse": rows["user_sparse"][u]})
        store[u] = user_vecs[u]
    return pkg.ApplicationServer(um, cm, pkg.RecallService(index, store),
                                 pkg.RankService(rank_def, rank_p))


def _apps():
    recall_j, recall_params, recall_p, recall_m = _build("demo.movie_recall", 0)
    rank_j, rank_params, rank_p, rank_m = _build("demo.movie_rank", 1)
    rows = _batch(recall_p, 90, 4)
    rows["title_mask"][:, 0] = 1.0
    rows["movie_id"][7] = rows["movie_id"][8]  # a movie listed twice: one entry in cm
    jax_app = _services(jax_rec, JaxIndex, (recall_j, recall_params), (rank_j, rank_params),
                        rows, 6)
    port_app = _services(port_rec, PortIndex, (recall_p, recall_m), (rank_p, rank_m),
                         rows, 6, device="cpu")
    return jax_app, port_app


def test_the_five_services_answer_as_jax():
    jax_app, port_app = _apps()
    for uid in range(6):
        for topk, recall_k in ((5, 20), (10, 50), (100, 70)):
            want = jax_app.recommend(uid, topk=topk, recall_k=recall_k)
            got = port_app.recommend(uid, topk=topk, recall_k=recall_k)
            assert [r["movie_id"] for r in got] == [r["movie_id"] for r in want], uid
            np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                       rtol=0, atol=1e-5)
            scores = [r["score"] for r in got]
            assert scores == sorted(scores, reverse=True) and 0 < len(got) <= topk
    # the rank service pads to 64: 70 candidates take two padded rows of 64
    assert port_app.rank.pad == jax_app.rank.pad == 64
    with pytest.raises(KeyError, match="unknown uid"):
        port_app.recommend(99)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body.startswith(b"{") else None


def test_http_front_door_answers_as_recommend_and_as_jax():
    jax_app, port_app = _apps()
    servers = [app.serve_http(port=0) for app in (jax_app, port_app)]
    try:
        ports = [s.server_address[1] for s in servers]
        status, data = _get(ports[1], "/as/recommend?uid=2&topk=4")
        assert status == 200 and data == {"uid": 2, "items": port_app.recommend(2, 4)}
        status, data = _get(ports[1], "/as/recommend/?uid=3")  # default topk 10
        assert status == 200 and len(data["items"]) == 10
        for path in ("/as/recommend?uid=999", "/as/recommend?uid=abc", "/as/recommend",
                     "/as/recommend?uid=1&topk=x", "/nothing"):
            want, got = _get(ports[0], path), _get(ports[1], path)
            assert got == want, path
            assert got[0] == (404 if path == "/nothing" else 400)
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
