"""HTTP surface of the port's serving tier (counterpart of
`deeplearning4j_tpu/serving/http.py`). JSON routes:

- `GET  /health`     liveness: `{"status": "ok", "model", "models"}`
- `GET  /healthz`    readiness: `{"status": "warming" | "ready" |
                     "failed", "models": {name: status}}`
- `GET  /metrics`    Prometheus scrape (`?format=json` for the snapshot,
                     `?names=a,b` to narrow it to those families)
- `GET  /v1/models`  one row per hosted model
- `POST /predict`    `{"data": [[...]], "model"?, "timeout_ms"?}` ->
                     `{"predictions": [...]}`
- `POST /generate`   `{"prompt_ids": [...], "n_steps": N, "temperature"?,
                       "top_k"?, "top_p"?, "seed"?, "eos_id"?, "model"?,
                       "timeout_ms"?}` -> `{"ids": [...]}`, the prompt
                       included (the reference's schema)

While the server or the model is warming, `/predict` and `/generate`
answer 503 with `Retry-After: 1`; a model whose warmup failed answers 503
without it (the server's ModelNotReadyError, which in-process callers get
too). Handler threads only parse, validate and wait: the batcher's and
the scheduler's threads run the forwards. Failures map by the typed
errors of `serving/errors.py`; plain `TimeoutError` is a 504, malformed
payloads a 400. `/v1/tenants` and `/admin/flight-dump` come with the
request ledger and the flight recorder (ROADMAP A.14), `/api/trace` with
the tracer (A.14), `/admin/drain` and `/admin/reload` with fleets (A.13).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.serving.errors import ServingError

ROUTES = ["/health", "/healthz", "/metrics", "/v1/models", "/predict",
          "/generate"]


def make_handler(server):
    """Build the request-handler class bound to one `InferenceServer`."""
    from deeplearning4j_tpu_torch.serving.server import _UNSET

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

        # ------------------------------------------------------------- GET

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                try:
                    model = type(server.net).__name__
                except Exception:
                    model = None
                self._json({"status": "ok", "model": model,
                            "models": [r["name"]
                                       for r in server.snapshot()]})
            elif url.path == "/healthz":
                rows = server.snapshot()
                self._json({"status": server._status,
                            "models": {r["name"]: r["status"]
                                       for r in rows}})
            elif url.path == "/metrics":
                q = parse_qs(url.query)
                fmt = (q.get("format") or ["prometheus"])[0]
                names = (q["names"][0].split(",") if q.get("names")
                         else None)
                body, ctype = _obs.prometheus_payload(fmt, names=names)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/v1/models":
                self._json({"models": server.snapshot()})
            else:
                self._json({"error": "not found", "routes": ROUTES}, 404)

        # ------------------------------------------------------------ POST

        def _payload(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length))

        def _timeout_s(self, payload: dict):
            ms = payload.get("timeout_ms")
            return _UNSET if ms is None else float(ms) / 1000.0

        def do_POST(self):
            if self.path == "/predict":
                return self._post_predict()
            if self.path == "/generate":
                return self._post_generate()
            return self._json({"error": "not found", "routes": ROUTES}, 404)

        def _post_predict(self):
            try:
                payload = self._payload()
                name = payload.get("model")
                preds = server.predict(payload["data"], model=name,
                                       timeout_s=self._timeout_s(payload))
            except Exception as e:  # the HTTP boundary answers every failure
                return self._error(e)
            self._json({"predictions": preds.tolist()})

        def _post_generate(self):
            try:
                payload = self._payload()
                name = payload.get("model")
                sampling = {k: payload[k] for k in
                            ("temperature", "top_k", "top_p", "seed",
                             "eos_id") if k in payload}
                ids = server.generate(payload["prompt_ids"],
                                      int(payload["n_steps"]), model=name,
                                      timeout_s=self._timeout_s(payload),
                                      **sampling)
            except Exception as e:  # the HTTP boundary answers every failure
                return self._error(e)
            self._json({"ids": [int(t) for t in ids]})

    return Handler
