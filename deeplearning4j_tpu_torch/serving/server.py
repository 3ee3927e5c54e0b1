"""The serving facade (counterpart of `deeplearning4j_tpu/serving/server.py`):
`InferenceServer` hosts one or more models, each behind its own
`ShapeBucketBatcher` (`POST /predict`) and, for a `transformer_lm` with a
KV-cached decode path, a continuous-batching `GenerationScheduler`
(`POST /generate`), and answers `/health`, `/healthz`, `/metrics` and
`/v1/models` over HTTP.

- Models come as live nets or from disk: `from_checkpoint(path)` and
  `add_model(name, path=...)` load a sharded checkpoint, a
  `CheckpointManager` root (its newest committed step) or a model zip
  through `checkpoint.legacy.load_any`, onto the server's device.
- With `warmup=True`, `start()` opens the port at once and warms every
  model on a thread (each batch bucket's forward; each prompt bucket's
  prefill, the decode step and the verify widths); `/healthz` reads
  "warming" and `predict` and `generate` (in process or over HTTP) raise
  ModelNotReadyError, HTTP 503, until it is done.
  A warmup failure is kept: the model's status becomes "failed" and
  `wait_ready()` raises it (the reference warns and serves anyway; on the
  card such a failure is a kernel that did not build or launch, which the
  first request would meet too).

The server runs on the card (`device="cuda"`, the default) unless the
caller asks for the CPU; every hosted net must live on the server's
device. On the card, `start()` builds the kernel library before it opens
the port, so no request pays for `nvcc`.

Still to come: multi-model hosting under a memory budget
(`hbm_budget_bytes`, `serving/host.py`) and LoRA adapters (ROADMAP A.12);
tensor-parallel serving (`model_parallel`), fleets and the router (A.13);
the request ledger, tenants, `/api/trace` and `/admin/*` (A.14). The knobs
that name them raise NotImplementedError.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import (
    EmbeddingLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.serving import metrics as _m
from deeplearning4j_tpu_torch.serving.batcher import (
    ShapeBucketBatcher,
    canonicalize_features,
)
from deeplearning4j_tpu_torch.serving.errors import (
    InputValidationError,
    ModelNotFoundError,
    ModelNotReadyError,
    RequestTimeoutError,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.scheduler import GenerationScheduler

_UNSET = object()


def _not_yet(what: str, item: int):
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP A.{item})")


def serves_generation(net) -> bool:
    """`lm="auto"`: a graph serves `/generate` when one of its
    SelfAttentionLayers has a `decode_cache_length`."""
    vertices = getattr(net, "layer_vertices", None) or {}
    return any(isinstance(v.layer, SelfAttentionLayer)
               and v.layer.decode_cache_length
               for v in vertices.values())


def model_dtype(net) -> str:
    """The serving dtype: "int8" when a param has a `__scale` companion,
    else the first floating param's dtype (reference `host.model_dtype`)."""
    first = None
    for lp in (getattr(net, "params_tree", None) or {}).values():
        for k, a in lp.items():
            if not a.is_floating_point():
                if k + "__scale" in lp:
                    return "int8"
            elif first is None:
                first = str(a.dtype).replace("torch.", "")
    return first or "float32"


class ServedModel:
    """One hosted model: its net, batcher, optional scheduler and status
    ("ready", "warming" or "failed", with the warmup's error)."""

    def __init__(self, name: str, net, batcher: ShapeBucketBatcher,
                 scheduler: Optional[GenerationScheduler],
                 path: Optional[str] = None):
        self.name = name
        self.net = net
        self.batcher = batcher
        self.scheduler = scheduler
        self.path = path
        self.status = "ready"
        self.error: Optional[BaseException] = None
        self.dtype = model_dtype(net)
        self.vocab = None
        if scheduler is not None:
            # Prompt ids are checked against the ids embedding's table on
            # the host: an out-of-range index on the card is a device-side
            # assert that takes the process's CUDA context down with it.
            ins = set(net.conf.network_inputs)
            tables = [v.layer.n_in for n, v in net.layer_vertices.items()
                      if isinstance(v.layer, EmbeddingLayer)
                      and ins & set(net.conf.vertex_inputs[n])]
            self.vocab = min(tables) if tables else None

    def stop(self) -> None:
        self.batcher.stop()
        if self.scheduler is not None:
            self.scheduler.stop()

    def row(self) -> dict:
        row = {"name": self.name, "status": self.status,
               "lm": self.scheduler is not None,
               "device": str(getattr(self.net, "device", "cpu")),
               "dtype": self.dtype, "path": self.path,
               "batch_buckets": list(self.batcher.buckets)}
        s = self.scheduler
        if s is not None:
            row.update(kv_cache=s.kv, decode_slots=s.slots,
                       capacity=s.capacity, scheduler_mode=s.mode,
                       speculative=s._draft_stepper is not None)
        if self.error is not None:
            row["error"] = f"{type(self.error).__name__}: {self.error}"
        return row


class InferenceServer:
    """HTTP predict/generate server over the port's engines (see module
    docstring). The knobs set here are each model's defaults; `add_model`
    overrides them per model.

    `max_batch_size` is the largest padded batch; requests pad to the
    smallest bucket of `batch_buckets` (powers of two up to
    `max_batch_size` by default); `max_delay_ms` is the coalescing window
    and `queue_depth` the batcher's bound. The decode knobs
    (`decode_slots`, `prompt_buckets`, `generate_queue_depth`,
    `scheduler_mode`, `kv_cache`, `kv_page_size`, `kv_pages`,
    `prefix_cache`, `draft`, `spec_k`) go to each LM's scheduler."""

    def __init__(self, net=None, port: int = 0, host: str = "127.0.0.1", *,
                 device="cuda",
                 max_batch_size: int = 32, max_delay_ms: float = 5.0,
                 predict_timeout_s: Optional[float] = 300.0,
                 warmup: bool = False,
                 warmup_shape: Optional[Tuple[int, ...]] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 queue_depth: int = 256,
                 hbm_budget_bytes: Optional[int] = None,
                 decode_slots: int = 4,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 generate_queue_depth: int = 64,
                 scheduler_mode: str = "continuous",
                 kv_cache: str = "dense",
                 kv_page_size: int = 64,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft=None, spec_k: int = 4,
                 model_parallel: int = 1,
                 default_model: str = "default"):
        if hbm_budget_bytes is not None:
            raise _not_yet("hosting under hbm_budget_bytes (model eviction, "
                           "serving/host.py)", 12)
        if int(model_parallel) > 1:
            raise _not_yet(f"model_parallel={model_parallel} "
                           "(tensor-parallel serving)", 13)
        self.device = resolve_device(device)
        self.host = host
        self.port = port
        # How long a predict or generate call waits; None waits forever.
        self.predict_timeout_s = predict_timeout_s
        self.warmup = bool(warmup)
        self._defaults = dict(
            max_batch_size=int(max_batch_size),
            max_delay_s=float(max_delay_ms) / 1000.0,
            batch_buckets=batch_buckets, queue_depth=int(queue_depth),
            warmup_shape=None if warmup_shape is None else tuple(
                warmup_shape),
            slots=int(decode_slots), prompt_buckets=prompt_buckets,
            generate_queue_depth=int(generate_queue_depth),
            mode=scheduler_mode, kv=kv_cache, page_size=int(kv_page_size),
            kv_pages=kv_pages, prefix_cache=prefix_cache, draft=draft,
            spec_k=int(spec_k))
        self.default_model = default_model
        self.models: Dict[str, ServedModel] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._warmup_thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        if net is not None:
            self.add_model(default_model, net)

    @classmethod
    def from_checkpoint(cls, path, **kwargs) -> "InferenceServer":
        """Serve the default model straight from a checkpoint on disk: a
        committed sharded step, a `CheckpointManager` root (its newest
        committed step) or a model zip."""
        server = cls(None, **kwargs)
        server.add_model(server.default_model, path=path)
        return server

    # --------------------------------------------------------------- models

    @property
    def net(self):
        """The default model's engine."""
        return self.get(None).net

    def add_model(self, name: str, net=None, path=None, *,
                  lm: object = "auto",
                  max_batch_size: Optional[int] = None,
                  batch_buckets: object = _UNSET,
                  max_delay_ms: Optional[float] = None,
                  queue_depth: Optional[int] = None,
                  warmup_shape: object = _UNSET,
                  decode_slots: Optional[int] = None,
                  prompt_buckets: object = _UNSET,
                  generate_queue_depth: Optional[int] = None,
                  scheduler_mode: Optional[str] = None,
                  kv_cache: Optional[str] = None,
                  kv_page_size: Optional[int] = None,
                  kv_pages: object = _UNSET,
                  prefix_cache: object = _UNSET,
                  draft: object = _UNSET,
                  spec_k: Optional[int] = None,
                  model_parallel: Optional[int] = None,
                  hbm_budget_bytes: Optional[int] = None) -> ServedModel:
        """Host `net`, or the checkpoint at `path` loaded onto this
        server's device, and start its batcher (and, when `lm` says so, its
        decode loop). `lm="auto"` serves generation when the graph has a
        KV-cached attention layer (`serves_generation`); True requires it,
        False never. Models added before `start()` are warmed by it when
        the server has `warmup=True`."""
        if hbm_budget_bytes is not None:
            raise _not_yet("hosting under hbm_budget_bytes", 12)
        if model_parallel is not None and int(model_parallel) > 1:
            raise _not_yet(f"model_parallel={model_parallel}", 13)
        if net is None:
            if path is None:
                raise ValueError("add_model needs a net or a path")
            from deeplearning4j_tpu_torch.checkpoint.legacy import load_any

            net = load_any(path, device=self.device)
        net_dev = getattr(net, "device", None)
        if net_dev is not None and net_dev != self.device:
            raise ValueError(f"model {name!r} lives on {net_dev}; this "
                             f"server runs on {self.device}")
        opts = dict(self._defaults)
        for key, val in (("max_batch_size", max_batch_size),
                         ("queue_depth", queue_depth),
                         ("slots", decode_slots),
                         ("generate_queue_depth", generate_queue_depth),
                         ("mode", scheduler_mode), ("kv", kv_cache),
                         ("page_size", kv_page_size), ("spec_k", spec_k)):
            if val is not None:
                opts[key] = val
        if max_delay_ms is not None:
            opts["max_delay_s"] = float(max_delay_ms) / 1000.0
        for key, val in (("batch_buckets", batch_buckets),
                         ("warmup_shape", warmup_shape),
                         ("prompt_buckets", prompt_buckets),
                         ("kv_pages", kv_pages),
                         ("prefix_cache", prefix_cache), ("draft", draft)):
            if val is not _UNSET:
                opts[key] = val
        scheduler = None
        if lm is True or (lm == "auto" and serves_generation(net)):
            d = opts["draft"]
            if d is not None and d.device != self.device:
                raise ValueError(f"the draft of {name!r} lives on "
                                 f"{d.device}; this server runs on "
                                 f"{self.device}")
            scheduler = GenerationScheduler(
                net, model_name=name, slots=opts["slots"],
                prompt_buckets=opts["prompt_buckets"],
                queue_depth=opts["generate_queue_depth"], mode=opts["mode"],
                kv=opts["kv"], page_size=opts["page_size"],
                kv_pages=opts["kv_pages"], prefix_cache=opts["prefix_cache"],
                draft=d, spec_k=opts["spec_k"])
        batcher = ShapeBucketBatcher(
            net, model_name=name, max_batch_size=opts["max_batch_size"],
            buckets=opts["batch_buckets"], max_delay_s=opts["max_delay_s"],
            queue_depth=opts["queue_depth"],
            warmup_shape=opts["warmup_shape"])
        served = ServedModel(name, net, batcher, scheduler,
                             None if path is None else str(path))
        _m.MODEL_DTYPE.labels(model=name, dtype=served.dtype).set(1)
        with self._lock:
            old = self.models.get(name)
            self.models[name] = served
        if old is not None:
            old.stop()
        batcher.start()
        if scheduler is not None:
            scheduler.start()
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
            models = list(self.models.values())
        return [m.row() for m in models]

    # -------------------------------------------------------------- warmup

    @property
    def _status(self) -> str:
        """"warming" until `start()` (and its warmup) is done; then
        "failed" if a model's warmup failed, else "ready"."""
        if not self._ready.is_set():
            return "warming"
        with self._lock:
            models = list(self.models.values())
        return ("failed" if any(m.status == "failed" for m in models)
                else "ready")

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until `start()` has built the kernels, opened the port and
        warmed every model (True), or `timeout` seconds pass (False).
        Raises the error of a model whose warmup failed."""
        if not self._ready.wait(timeout):
            return False
        with self._lock:
            failed = [m for m in self.models.values() if m.status == "failed"]
        if failed:
            raise failed[0].error
        return True

    def _check_ready(self, served: ServedModel) -> None:
        """Raise ModelNotReadyError unless `served` may take traffic: the
        server is warming (its models are warmed one after another), the
        model is warming, or its warmup failed."""
        if served.status == "failed":
            raise ModelNotReadyError(
                f"model {served.name!r} failed its warmup: {served.error}",
                "failed")
        if served.status == "warming" or (
                self._warmup_thread is not None
                and not self._ready.is_set()):
            raise ModelNotReadyError(f"model {served.name!r} is warming")

    def _warmup_run(self, models) -> None:
        """Drive each model's batch buckets, and an LM's prompt buckets,
        decode step and verify widths, once. A failure stays with its
        model ("failed", and `wait_ready` raises it); nothing falls back."""
        try:
            for model in models:
                try:
                    model.batcher.warm()
                    if model.scheduler is not None:
                        model.scheduler.warmup()
                    model.status = "ready"
                except Exception as e:
                    model.error = e
                    model.status = "failed"
        finally:
            self._ready.set()

    # ------------------------------------------------------------- predict

    def predict(self, data, model: Optional[str] = None,
                timeout_s: object = _UNSET,
                adapter: Optional[str] = None) -> np.ndarray:
        """Batched inference through the model's bucket batcher (the HTTP
        handler calls this too). A request larger than the largest bucket
        splits into chunks of it."""
        if adapter is not None:
            raise _not_yet("adapter= (LoRA adapter serving)", 12)
        name = self.default_model if model is None else model
        timeout = (self.predict_timeout_s if timeout_s is _UNSET
                   else timeout_s)
        t0 = time.perf_counter()
        try:
            served = self.get(name)
            self._check_ready(served)
            arr = canonicalize_features(served.net, data)
            result = self._predict_rows(served, arr, timeout)
        except Exception as e:
            _m.REQUESTS_LEGACY.labels(outcome="error").inc()
            _m.REQUESTS.labels(model=name, route="predict",
                               outcome=self._outcome(e)).inc()
            raise
        _m.REQUESTS_LEGACY.labels(outcome="ok").inc()
        _m.REQUESTS.labels(model=name, route="predict", outcome="ok").inc()
        dt = time.perf_counter() - t0
        _m.REQ_LATENCY.observe(dt)
        _m.REQUEST_SECONDS.labels(model=name, route="predict").observe(dt)
        return result

    @staticmethod
    def _outcome(e: Exception) -> str:
        if isinstance(e, ServerOverloadedError):
            return "shed"
        if isinstance(e, (InputValidationError, ModelNotReadyError)):
            return "invalid"
        # A dropped request was already counted "timeout" by the batcher
        # or the scheduler.
        return "error"

    def _predict_rows(self, served: ServedModel, arr: np.ndarray,
                      timeout: Optional[float]) -> np.ndarray:
        deadline = None if timeout is None else time.monotonic() + timeout
        size = served.batcher.max_batch_size
        # All chunks are queued up front so that they coalesce into
        # consecutive batches.
        chunks = ([arr[i:i + size] for i in range(0, arr.shape[0], size)]
                  or [arr])
        pendings = [served.batcher.submit(c, deadline) for c in chunks]
        results = []
        for p in pendings:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            p.event.wait(timeout=remaining)
            if not p.event.is_set():
                for q in pendings:
                    q.cancelled = True  # the batcher drops and counts them
                raise TimeoutError(
                    f"prediction timed out after {timeout}s (raise "
                    "predict_timeout_s or pass None to wait indefinitely)")
            if p.error == "__deadline__":
                for q in pendings:
                    q.cancelled = True
                raise RequestTimeoutError(
                    f"prediction deadline ({timeout}s) expired in the "
                    "batch queue")
            if p.error is not None:
                raise RuntimeError(p.error)
            results.append(p.result)
        if len(results) == 1:
            return results[0]
        return np.concatenate(results, axis=0)

    # ------------------------------------------------------------ generate

    def generate(self, prompt_ids, n_steps: int,
                 model: Optional[str] = None,
                 timeout_s: object = _UNSET,
                 adapter: Optional[str] = None, **sampling):
        """Continuously batched generation: returns prompt + generated
        ids, equal to `generate_lm(use_cache=True)` for the same seed and
        sampling knobs."""
        if adapter is not None:
            raise _not_yet("adapter= (LoRA adapter serving)", 12)
        name = self.default_model if model is None else model
        timeout = (self.predict_timeout_s if timeout_s is _UNSET
                   else timeout_s)
        t0 = time.perf_counter()
        try:
            if not isinstance(prompt_ids, (list, tuple)) or not all(
                    isinstance(i, int) and not isinstance(i, bool)
                    for i in prompt_ids):
                raise InputValidationError(
                    "prompt_ids must be a list of ints")
            served = self.get(name)
            self._check_ready(served)
            if served.scheduler is None:
                raise InputValidationError(
                    f"model {name!r} does not serve generation (no "
                    "KV-cached decode path)")
            if served.vocab is not None and any(
                    not 0 <= i < served.vocab for i in prompt_ids):
                raise InputValidationError(
                    f"prompt_ids must lie in [0, {served.vocab})")
            ids = served.scheduler.generate(prompt_ids, n_steps,
                                            timeout_s=timeout, **sampling)
        except Exception as e:
            _m.REQUESTS.labels(model=name, route="generate",
                               outcome=self._outcome(e)).inc()
            raise
        _m.REQUESTS.labels(model=name, route="generate", outcome="ok").inc()
        _m.REQUEST_SECONDS.labels(model=name, route="generate").observe(
            time.perf_counter() - t0)
        return ids

    # ---------------------------------------------------------------- http

    def start(self) -> "InferenceServer":
        """Build the kernels (on the card), open the port, and warm the
        hosted models on a thread when the server has `warmup=True`."""
        from deeplearning4j_tpu_torch.serving.http import make_handler

        if self.device.type == "cuda":
            from deeplearning4j_tpu_torch.kernels import _build

            _build.load()
        _m.QUEUE_DEPTH.set_function(self._total_queue_depth)
        with self._lock:
            models = list(self.models.values())
        if self.warmup:
            for m in models:
                m.status = "warming"
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          make_handler(self))
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="dl4j-http", daemon=True)
        self._serve_thread.start()
        if self.warmup:
            # The port is open and /healthz answers "warming" meanwhile.
            self._warmup_thread = threading.Thread(
                target=self._warmup_run, args=(models,),
                name="dl4j-serving-warmup", daemon=True)
            self._warmup_thread.start()
        else:
            self._ready.set()
        return self

    def _total_queue_depth(self) -> int:
        with self._lock:
            models = list(self.models.values())
        return sum(m.batcher.qsize() for m in models)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        _m.QUEUE_DEPTH.set_function(None)
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout=600.0)
            self._warmup_thread = None
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
            m.stop()
