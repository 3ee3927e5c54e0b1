"""The serving facade (counterpart of `deeplearning4j_tpu/serving/server.py`),
generation subset: `InferenceServer` hosts one or more `transformer_lm`
graphs, each behind its own continuous-batching `GenerationScheduler`, and
answers `POST /generate`, `GET /healthz` and `GET /v1/models` over HTTP.

The server runs on the card (`device="cuda"`, the default) unless the
caller asks for the CPU; every hosted graph must live on the server's
device. On the card, `start()` builds the kernel library before it opens
the port, so no request pays for `nvcc`. `/predict` with its batcher,
`/metrics`, the request ledger, adapters, draft models, tensor
parallelism and fleets are not in the port yet.
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer
from typing import Dict, Optional, Sequence

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import EmbeddingLayer
from deeplearning4j_tpu_torch.serving.errors import (
    InputValidationError,
    ModelNotFoundError,
)
from deeplearning4j_tpu_torch.serving.scheduler import GenerationScheduler

_UNSET = object()


class ServedModel:
    def __init__(self, name: str, net, scheduler: GenerationScheduler):
        self.name = name
        self.net = net
        self.scheduler = scheduler
        # Prompt ids are checked against the ids embedding's table on the
        # host: an out-of-range index on the card is a device-side assert
        # that takes the whole process's CUDA context down with it.
        ins = set(net.conf.network_inputs)
        tables = [v.layer.n_in for n, v in net.layer_vertices.items()
                  if isinstance(v.layer, EmbeddingLayer)
                  and ins & set(net.conf.vertex_inputs[n])]
        self.vocab = min(tables) if tables else None

    def row(self) -> dict:
        s = self.scheduler
        return {"name": self.name, "status": "ready", "lm": True,
                "device": str(self.net.device),
                "dtype": self.net.dtype_policy.name, "kv_cache": s.kv,
                "decode_slots": s.slots, "capacity": s.capacity}


class InferenceServer:
    """HTTP generation server over the port's `ComputationGraph`s (see
    module docstring). Scheduler knobs set here are each model's defaults;
    `add_model` overrides them per model."""

    def __init__(self, net=None, port: int = 0, host: str = "127.0.0.1", *,
                 device="cuda",
                 predict_timeout_s: Optional[float] = 300.0,
                 decode_slots: int = 4,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 generate_queue_depth: int = 64,
                 kv_cache: str = "dense",
                 kv_page_size: int = 64,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 default_model: str = "default"):
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        # How long a generate call waits; None waits indefinitely.
        self.predict_timeout_s = predict_timeout_s
        self._defaults = dict(
            slots=int(decode_slots), prompt_buckets=prompt_buckets,
            queue_depth=int(generate_queue_depth), kv=kv_cache,
            page_size=int(kv_page_size), kv_pages=kv_pages,
            prefix_cache=prefix_cache)
        self.default_model = default_model
        self.models: Dict[str, ServedModel] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        if net is not None:
            self.add_model(default_model, net)

    def add_model(self, name: str, net, *,
                  decode_slots: Optional[int] = None,
                  prompt_buckets: object = _UNSET,
                  generate_queue_depth: Optional[int] = None,
                  kv_cache: Optional[str] = None,
                  kv_page_size: Optional[int] = None,
                  kv_pages: object = _UNSET,
                  prefix_cache: object = _UNSET) -> ServedModel:
        """Host `net` (a port `ComputationGraph` on this server's device with
        a KV-cached decode path) and start its decode loop."""
        if net.device != self.device:
            raise ValueError(f"model {name!r} lives on {net.device}; this "
                             f"server runs on {self.device}")
        opts = dict(self._defaults)
        for key, val in (("slots", decode_slots),
                         ("queue_depth", generate_queue_depth),
                         ("kv", kv_cache), ("page_size", kv_page_size)):
            if val is not None:
                opts[key] = val
        for key, val in (("prompt_buckets", prompt_buckets),
                         ("kv_pages", kv_pages),
                         ("prefix_cache", prefix_cache)):
            if val is not _UNSET:
                opts[key] = val
        served = ServedModel(name, net,
                             GenerationScheduler(net, model_name=name,
                                                 **opts).start())
        with self._lock:
            old = self.models.get(name)
            self.models[name] = served
        if old is not None:
            old.scheduler.stop()
        return served

    def get(self, name: Optional[str]) -> ServedModel:
        name = self.default_model if name is None else name
        with self._lock:
            served = self.models.get(name)
        if served is None:
            raise ModelNotFoundError(f"no model named {name!r}")
        return served

    def snapshot(self) -> list:
        """`GET /v1/models` payload."""
        with self._lock:
            return [m.row() for m in self.models.values()]

    def generate(self, prompt_ids, n_steps: int,
                 model: Optional[str] = None,
                 timeout_s: object = _UNSET, **sampling):
        """Continuously batched generation: returns prompt + generated
        ids, equal to `generate_lm(use_cache=True)` for the same seed and
        sampling knobs."""
        if not isinstance(prompt_ids, (list, tuple)) or not all(
                isinstance(i, int) and not isinstance(i, bool)
                for i in prompt_ids):
            raise InputValidationError("prompt_ids must be a list of ints")
        served = self.get(model)
        if served.vocab is not None and any(not 0 <= i < served.vocab
                                            for i in prompt_ids):
            raise InputValidationError(
                f"prompt_ids must lie in [0, {served.vocab})")
        timeout = (self.predict_timeout_s if timeout_s is _UNSET
                   else timeout_s)
        return served.scheduler.generate(prompt_ids, n_steps,
                                         timeout_s=timeout, **sampling)

    # ---------------------------------------------------------------- http

    def start(self) -> "InferenceServer":
        from deeplearning4j_tpu_torch.serving.http import make_handler

        if self.device.type == "cuda":
            from deeplearning4j_tpu_torch.kernels import _build

            _build.load()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          make_handler(self))
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="dl4j-http", daemon=True)
        self._serve_thread.start()
        self._ready.set()
        return self

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until `start()` has built the kernels and opened the port
        (True), or `timeout` seconds pass (False). The port has no compile
        step to warm up, so a started server is ready."""
        return self._ready.wait(timeout)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._ready.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
            self._serve_thread = None
        with self._lock:
            models = list(self.models.values())
        for m in models:
            m.scheduler.stop()
