"""HTTP prediction web service + client.

Counterpart of ``paddlerec_tpu/serving/webserver.py``: the standard
library's HTTP server wraps an exported artifact, ``POST /<name>/prediction``
with a JSON feed answers with the JSON fetch map.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from paddlerec_tpu_torch.core.device import resolve_device, to_tensors


class RecService:
    """Load an exported artifact onto the device and serve predictions."""

    def __init__(self, export_dir: str, name: str = "rec",
                 warmup: bool = True, device=None):
        from paddlerec_tpu_torch.tools.export import load_exported

        self.name = name
        self.device = resolve_device(device)
        self.model_def, self.module = load_exported(export_dir, self.device)
        if warmup:
            # build the kernels and warm the libraries before the first request
            self.predict(self.model_def.example_batch(1))

    # pre/post-process hooks (tools/webserver.py:29-40) — overridable
    def preprocess(self, feed: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return to_tensors({k: np.asarray(v) for k, v in feed.items()},
                          self.device)

    def postprocess(self, fetch_map: Dict[str, Any]) -> Dict[str, Any]:
        return {
            k: v.cpu().tolist()
            for k, v in fetch_map.items()
            if isinstance(v, torch.Tensor)
        }

    def predict(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        batch = self.preprocess(feed)
        with self.model_def.infer_context(torch.inference_mode):
            aux = self.model_def.infer_forward(self.module, batch)
        return self.postprocess(aux)

    # -- HTTP plumbing -----------------------------------------------------
    def make_server(self, port: int = 0, host: str = "127.0.0.1"):
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                if self.path.rstrip("/") != f"/{service.name}/prediction":
                    self.send_error(404, "unknown endpoint")
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    feed = payload.get("feed", payload)
                    if isinstance(feed, list):
                        feed = feed[0]
                    result = service.predict(feed)
                    body = json.dumps({"result": result}).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 - serving returns errors
                    body = json.dumps({"error": repr(e)}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return ThreadingHTTPServer((host, port), Handler)

    def run_web_service(self, port: int = 8866, background: bool = False):
        """Serve on 127.0.0.1:``port``.  With ``background`` the server runs
        in a daemon thread and is returned; stop it with ``shutdown()`` and
        ``server_close()``."""
        server = self.make_server(port)
        if background:
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            return server
        server.serve_forever()


class RecClient:
    """HTTP client (tools/rec_client.py analog)."""

    def __init__(self, host: str, port: int, name: str = "rec"):
        self.url = f"http://{host}:{port}/{name}/prediction"

    def predict(self, feed: Dict[str, Any],
                timeout: float = 10.0) -> Dict[str, Any]:
        import urllib.request

        req = urllib.request.Request(
            self.url,
            data=json.dumps({"feed": feed}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def predict_batches(self, dataset, limit: Optional[int] = None):
        """Replay reader batches against the service
        (rec_client.py:60-105)."""
        out = []
        for i, batch in enumerate(dataset):
            if limit is not None and i >= limit:
                break
            feed = {
                k: np.asarray(v).tolist() for k, v in batch.items()
            }
            out.append(self.predict(feed))
        return out
