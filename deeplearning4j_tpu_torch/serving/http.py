"""HTTP surface of the port's serving tier (counterpart of
`deeplearning4j_tpu/serving/http.py`, generation subset). JSON routes:

- `GET  /healthz`    readiness: `{"status": "ready", "models": {name: status}}`
- `GET  /v1/models`  one row per hosted model
- `POST /generate`   `{"prompt_ids": [...], "n_steps": N, "temperature"?,
                       "top_k"?, "top_p"?, "seed"?, "eos_id"?, "model"?,
                       "timeout_ms"?}` -> `{"ids": [...]}`, the prompt
                       included (the reference's schema)

Handler threads only parse, validate and wait: the scheduler's decode
thread is the only one that touches device tensors. Failures map by the
typed errors of `serving/errors.py`; plain `TimeoutError` is a 504,
malformed payloads a 400."""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler

from deeplearning4j_tpu_torch.serving.errors import ServingError


def make_handler(server):
    """Build the request-handler class bound to one `InferenceServer`."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, e: Exception):
            if isinstance(e, ServingError):
                headers = ({"Retry-After": str(e.retry_after)}
                           if e.retry_after is not None else None)
                return self._json(e.payload(), e.status, headers=headers)
            if isinstance(e, TimeoutError):
                return self._json({"error": str(e)}, 504)
            if isinstance(e, (KeyError, ValueError, TypeError,
                              json.JSONDecodeError)):
                return self._json({"error": f"bad request: {e}"}, 400)
            return self._json({"error": str(e)}, 500)

        def do_GET(self):
            if self.path == "/healthz":
                rows = server.snapshot()
                self._json({"status": "ready",
                            "models": {r["name"]: r["status"] for r in rows}})
            elif self.path == "/v1/models":
                self._json({"models": server.snapshot()})
            else:
                self._json({"error": "not found",
                            "routes": ["/healthz", "/v1/models",
                                       "/generate"]}, 404)

        def do_POST(self):
            if self.path != "/generate":
                return self._json({"error": "not found"}, 404)
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                sampling = {k: payload[k] for k in
                            ("temperature", "top_k", "top_p", "seed",
                             "eos_id") if k in payload}
                ms = payload.get("timeout_ms")
                kw = {} if ms is None else {"timeout_s": float(ms) / 1000.0}
                ids = server.generate(payload["prompt_ids"],
                                      int(payload["n_steps"]),
                                      model=payload.get("model"), **kw,
                                      **sampling)
            except Exception as e:  # the HTTP boundary answers every failure
                return self._error(e)
            self._json({"ids": [int(t) for t in ids]})

    return Handler
