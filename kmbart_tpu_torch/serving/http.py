"""Minimal HTTP front end for the generation engines.

Counterpart of kmbart_tpu/serving/http.py, the same routes and payloads:

POST /generate  {"text": "..."} or {"texts": [...]} or
                {"input_ids": [[...]], "image_features": [[[...]]]}
             -> {"generations": [[str, ...], ...]} (or {"token_ids": ...}
                when no tokenizer is attached)
GET  /health -> {"status": "ok"}

A threaded stdlib server: each request blocks on its engine future while the
engine batches concurrent requests on the device.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if "text" in req or "texts" in req:
                    if engine.tokenizer is None:
                        raise ValueError("no tokenizer attached to the engine")
                    texts = req.get("texts", [req.get("text")])
                    self._send(200, {"generations": [engine.generate_text(t) for t in texts]})
                    return
                if "input_ids" not in req:
                    raise ValueError('request must contain "text", "texts", or '
                                     f'"input_ids"; got keys {sorted(req)}')
                ids = np.asarray(req["input_ids"], np.int32)
                feats = (np.asarray(req["image_features"], np.float32)
                         if req.get("image_features") is not None else None)
                out = engine.submit(ids, image_features=feats).result()
                if engine.tokenizer is not None:
                    gens = [engine.tokenizer.decode(r, skip_special_tokens=True) for r in out]
                    self._send(200, {"generations": gens})
                else:
                    self._send(200, {"token_ids": out.tolist()})
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine, host="127.0.0.1", port=8000, block=True):
    """Start the HTTP server and return it (with ``block=False`` it runs on
    a daemon thread; ``server.shutdown()`` stops it)."""
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
