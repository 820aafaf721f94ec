"""Movie-recommender microservice demo: um / cm / recall / rank / as.

Counterpart of ``paddlerec_tpu/serving/movie_recommender.py``.  Parity
target of the original: reference recserving/movie_recommender/ — five gRPC
services: **um** (user model, redis-backed profile store), **cm** (content
model, redis-backed movie store), **recall** (Milvus ANN over exported
user/movie vectors), **rank** (the rank model), and **as** (application
server orchestrating um → recall → cm → rank,
recserving/movie_recommender/as.py:38-123).

The five services stay separable components with the same call graph;
stores are pluggable dicts, the ANN is the exact ``VectorIndex``, and rank
scores all candidates of a request in one forward on the rank module's
device, padded to a multiple of ``RankService.PAD`` rows as the JAX package
pads them (so that both score the same rows).  ``serve_http`` exposes the
orchestrator as one HTTP endpoint, ``GET /as/recommend?uid=&topk=``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlerec_tpu_torch.serving.vector_index import VectorIndex


class UserModelService:
    """um.py analog: uid → user profile features."""

    def __init__(self, store: Optional[Dict[int, Dict]] = None):
        self.store = store if store is not None else {}

    def put(self, uid: int, profile: Dict):
        self.store[int(uid)] = profile

    def get(self, uid: int) -> Dict:
        if int(uid) not in self.store:
            raise KeyError(f"unknown uid {uid}")
        return self.store[int(uid)]


class ContentModelService:
    """cm.py analog: movie id → movie features."""

    def __init__(self, store: Optional[Dict[int, Dict]] = None):
        self.store = store if store is not None else {}

    def put(self, mid: int, info: Dict):
        self.store[int(mid)] = info

    def get_many(self, mids: List[int]) -> List[Dict]:
        return [self.store[int(m)] for m in mids if int(m) in self.store]


class RecallService:
    """recall.py analog: user vector → candidate movie ids."""

    def __init__(self, index: VectorIndex, user_vectors: Dict[int, np.ndarray]):
        self.index = index
        self.user_vectors = user_vectors

    def recall(self, uid: int, topk: int = 50) -> List[int]:
        uv = self.user_vectors[int(uid)]
        _scores, ids = self.index.search(uv[None, :], topk)
        return [int(i) for i in ids[0]]


class RankService:
    """rank.py analog: score (user, candidates) with the rank model's
    ``module`` on its device."""

    # one padded batch size per request, as the JAX package pads (there to
    # keep one compiled shape, since cm.get_many drops missing ids and
    # candidate counts vary per uid)
    PAD = 64

    def __init__(self, model_def, module, pad: int = PAD):
        self.model_def = model_def
        self.module = module
        self.pad = pad
        self.device = next(module.parameters()).device

    def rank(self, user_feed: Dict, movie_feeds: List[Dict]) -> List[float]:
        n = len(movie_feeds)
        p = ((n + self.pad - 1) // self.pad) * self.pad

        def arr(key, dtype=None, fill=0):
            a = np.asarray([m[key] for m in movie_feeds])
            out = np.full((p,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            out = out if dtype is None else out.astype(dtype)
            return torch.from_numpy(out).to(self.device)

        batch = {
            "user_sparse": torch.from_numpy(np.tile(
                np.asarray(user_feed["user_sparse"])[None], (p, 1)
            )).to(self.device),
            "movie_id": arr("movie_id"),
            "title": arr("title"),
            "genres": arr("genres"),
            "title_mask": arr("title_mask", np.float32),
            "genre_mask": arr("genre_mask", np.float32),
            "label": torch.zeros((p,), dtype=torch.float32, device=self.device),
        }
        with self.model_def.infer_context(torch.inference_mode):
            aux = self.model_def.infer_forward(self.module, batch)
        return [float(x) for x in aux["predictions"][:n].cpu().numpy()]


class ApplicationServer:
    """as.py analog: uid → um → recall → cm → rank → ordered movies."""

    def __init__(self, um: UserModelService, cm: ContentModelService,
                 recall: RecallService, rank: RankService):
        self.um = um
        self.cm = cm
        self.recall = recall
        self.rank = rank

    def recommend(self, uid: int, topk: int = 10,
                  recall_k: int = 50) -> List[Dict]:
        user = self.um.get(uid)  # as.py:38-44 get_ums
        cand_ids = self.recall.recall(uid, recall_k)  # as.py:46-52
        movies = self.cm.get_many(cand_ids)  # as.py:54-62
        if not movies:
            return []
        scores = self.rank.rank(user, movies)  # as.py:64-69
        order = np.argsort(scores)[::-1][:topk]
        return [
            {"movie_id": int(movies[i]["movie_id"]),
             "score": float(scores[i])}
            for i in order
        ]

    # -- HTTP front door --------------------------------------------------------
    def serve_http(self, port: int = 0, host: str = "127.0.0.1",
                   background: bool = True):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                if u.path.rstrip("/") != "/as/recommend":
                    self.send_error(404)
                    return
                try:
                    q = parse_qs(u.query)
                    uid = int(q["uid"][0])
                    topk = int(q.get("topk", ["10"])[0])
                    body = json.dumps(
                        {"uid": uid, "items": app.recommend(uid, topk)}
                    ).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 - answered as a 400
                    body = json.dumps({"error": repr(e)}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer((host, port), Handler)
        if background:
            threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
