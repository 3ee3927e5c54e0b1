"""HTTP surface of the port's serving tier (counterpart of
`deeplearning4j_tpu/serving/http.py`). JSON routes:

- `GET  /health`     liveness: `{"status": "ok", "model", "models"}`
- `GET  /healthz`    readiness: `{"status": "warming" | "ready" |
                     "failed", "models": {name: status}}`
- `GET  /metrics`    Prometheus scrape (`?format=json` for the snapshot,
                     `?names=a,b` to narrow it to those families)
- `GET  /api/trace`  the tracer's ring as a Chrome trace (`?since=SEQ`:
                     only the events after an earlier export's `seq`);
                     save it and open it in ui.perfetto.dev
- `GET  /v1/models`  one row per hosted model
- `GET  /v1/tenants` the request ledger's per-(model, adapter) rows
- `POST /admin/flight-dump`  `{"reason"?}` -> `{"path": bundle or null}`:
                     a flight bundle, rate-limited per reason (a second
                     dump within the limit answers `"path": null`)
- `POST /predict`    `{"data": [[...]], "model"?, "adapter"?,
                       "timeout_ms"?}` -> `{"predictions": [...]}`
- `POST /generate`   `{"prompt_ids": [...], "n_steps": N, "temperature"?,
                       "top_k"?, "top_p"?, "seed"?, "eos_id"?, "model"?,
                       "adapter"?, "timeout_ms"?}` -> `{"ids": [...]}`,
                       the prompt included (the reference's schema)

`"adapter"` names a LoRA adapter loaded beside the model
(`InferenceServer.load_adapter`); an unknown one is a 400.

While the server or the model is warming, `/predict` and `/generate`
answer 503 with `Retry-After: 1`; a model whose warmup failed answers 503
without it (the server's ModelNotReadyError, which in-process callers get
too). Handler threads only parse, validate and wait: the batcher's and
the scheduler's threads run the forwards. Failures map by the typed
errors of `serving/errors.py`; plain `TimeoutError` is a 504, malformed
payloads a 400. `/predict` and `/generate` run in a `replica.<route>`
span, the child of the context an inbound `X-DL4J-Trace` header carries
(`observability/propagate.py`), which the handler binds to its thread,
so the request's queue item, ledger record and serving spans carry its
trace id. `/admin/drain` and `/admin/reload` come with fleets (ROADMAP
A.13).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.observability import propagate as _prop
from deeplearning4j_tpu_torch.serving.errors import ServingError

ROUTES = ["/health", "/healthz", "/metrics", "/api/trace", "/v1/models",
          "/v1/tenants", "/predict", "/generate", "/admin/flight-dump"]


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
            elif url.path == "/api/trace":
                q = parse_qs(url.query)
                try:
                    since = int(q["since"][0]) if q.get("since") else None
                except ValueError as e:
                    return self._error(e)
                self._json(_obs.tracer.export_chrome(since=since))
            elif url.path == "/v1/models":
                self._json({"models": server.snapshot()})
            elif url.path == "/v1/tenants":
                try:
                    self._json({"tenants": server.tenant_snapshot()})
                except Exception as e:  # the boundary answers every failure
                    self._error(e)
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
            if self.path == "/admin/flight-dump":
                return self._post_flight_dump()
            return self._json({"error": "not found", "routes": ROUTES}, 404)

        def _trace_span(self, route: str):
            """The request's `replica.<route>` span, the child of the
            context of an inbound `X-DL4J-Trace` header."""
            rctx = _prop.parse(self.headers.get(_prop.TRACE_HEADER))
            return _obs.tracer.span(f"replica.{route}", cat="serving",
                                    parent_ctx=rctx, route=route)

        def _post_predict(self):
            with self._trace_span("predict") as sp, _prop.bound(sp.ctx()):
                try:
                    payload = self._payload()
                    name = payload.get("model")
                    preds = server.predict(
                        payload["data"], model=name,
                        timeout_s=self._timeout_s(payload),
                        adapter=payload.get("adapter"))
                except Exception as e:  # the boundary answers every failure
                    return self._error(e)
                self._json({"predictions": preds.tolist()})

        def _post_generate(self):
            with self._trace_span("generate") as sp, _prop.bound(sp.ctx()):
                try:
                    payload = self._payload()
                    name = payload.get("model")
                    sampling = {k: payload[k] for k in
                                ("temperature", "top_k", "top_p", "seed",
                                 "eos_id") if k in payload}
                    ids = server.generate(
                        payload["prompt_ids"], int(payload["n_steps"]),
                        model=name, timeout_s=self._timeout_s(payload),
                        adapter=payload.get("adapter"), **sampling)
                except Exception as e:  # the boundary answers every failure
                    return self._error(e)
                self._json({"ids": [int(t) for t in ids]})

        def _post_flight_dump(self):
            """A flight bundle on demand (an SLO page's evidence hook). It
            rides the recorder's per-reason rate limit: a second dump
            within it answers `"path": null`."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = (json.loads(self.rfile.read(length))
                           if length else {})
                reason = str(payload.get("reason") or "admin")
                path = _obs.flight.dump(reason=reason, force=False)
            except Exception as e:  # the boundary answers every failure
                return self._error(e)
            self._json({"path": None if path is None else str(path)})

    return Handler
