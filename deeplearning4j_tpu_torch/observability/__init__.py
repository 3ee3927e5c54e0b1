"""Observability: metrics, tracing, step profiling, memory accounting, the
flight recorder, the request ledger and SLOs (counterpart of
`deeplearning4j_tpu/observability/`; federation, fleet and elastic follow
the fleets of ROADMAP A.13).

- `metrics`  the process-global `MetricsRegistry` (Prometheus text, JSON)
- `tracer`   the process-global `Tracer` (a Chrome trace-event ring)
- `StepProfiler`  build / execute / transfer / FLOPs split of one engine
- `memory`   device bytes by program and by owner (`memory.py`)
- `flight`   the always-on `FlightRecorder` instance; a bundle reads
             with `python -m deeplearning4j_tpu_torch.observability.flight
             <bundle>`
- `request_ledger`  the `RequestLedger` instance (`/v1/tenants`)
- `slo`      burn-rate alerting over an exposition

Scrape points: the serving tier serves `/metrics`, `/api/trace`,
`/v1/tenants` and `POST /admin/flight-dump`.

Nothing here waits for the device: spans, counters and the flight ring
read host clocks, and a loss is kept as the device tensor until a dump
reads it.

Env knobs (read once at import):

- `DL4J_TPU_OBS`              "0" / "false" / "off" disables the default
                              registry and tracer (mutators become one
                              bool check, spans a shared no-op)
- `DL4J_TPU_OBS_SAMPLE_EVERY` record every Nth iteration span (default 1;
                              metrics are never sampled)
- `DL4J_TPU_TRACE_BUFFER`     the trace ring's capacity (default 16384)
- `DL4J_TPU_FLIGHT*`          the flight recorder's (`flight.py`)
- `DL4J_TPU_LEDGER*`          the request ledger's (`ledger.py`)
- `DL4J_TPU_PEAK_FLOPS`, `DL4J_TPU_PEAK_HBM_BW`  the profiler's peaks
                              (`profiler.py`)

None of them selects a kernel or a plain path.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.observability import propagate
from deeplearning4j_tpu_torch.observability.metrics import (
    DEFAULT_BUCKETS,
    WIDE_BUCKETS,
    MetricsRegistry,
    install_builtin_collectors,
)
from deeplearning4j_tpu_torch.observability.tracing import NOOP_SPAN, Tracer

__all__ = [
    "metrics", "tracer", "config", "StepProfiler", "MetricsRegistry",
    "Tracer", "DEFAULT_BUCKETS", "WIDE_BUCKETS", "enable", "disable",
    "iteration_span", "host_nbytes", "install_compile_hook",
    "bench_snapshot", "prometheus_payload", "chip_peak_flops",
    "chip_peak_hbm_bw", "estimate_step_cost", "estimate_step_flops",
    "flight", "FlightRecorder", "memory", "propagate",
    "install_build_info", "request_ledger", "RequestLedger", "slo",
]

OBS_ENABLED = os.environ.get("DL4J_TPU_OBS", "1").lower() not in (
    "0", "false", "off")


class _Config:
    """Runtime knobs, their defaults from the environment."""

    def __init__(self):
        try:
            self.sample_every = max(
                1, int(os.environ.get("DL4J_TPU_OBS_SAMPLE_EVERY", "1")))
        except ValueError:
            self.sample_every = 1


config = _Config()

# The process-global instruments. Hot-loop call sites resolve their labeled
# children once at import; `enable()` / `disable()` flip both at run time.
metrics = MetricsRegistry(enabled=OBS_ENABLED)
install_builtin_collectors(metrics)
tracer = Tracer(enabled=OBS_ENABLED)


def install_build_info(registry: Optional[MetricsRegistry] = None) -> None:
    """Register `dl4j_build_info{version,jax,backend,device_kind}` (value
    1), the reference's four labels so one scrape schema serves both
    packages: `jax` reads "unloaded" (the port never imports it),
    `backend` "cuda" or "cpu", `device_kind` `torch.cuda.get_device_name()`
    ("cpu" without a card). The labels resolve at scrape time."""
    reg = registry or metrics
    fam = reg.gauge(
        "dl4j_build_info",
        "Build/runtime identity of this process (value is always 1); "
        "compare worker_id series in a federated scrape to detect "
        "mixed-version fleets during rolling updates",
        label_names=("version", "jax", "backend", "device_kind"))
    state: Dict[str, Any] = {}

    def collect(_reg: MetricsRegistry) -> None:
        import torch

        import deeplearning4j_tpu_torch as _pkg

        cuda = torch.cuda.is_available()
        labels = {"version": getattr(_pkg, "__version__", "unknown"),
                  "jax": "unloaded", "backend": "cuda" if cuda else "cpu",
                  "device_kind": (torch.cuda.get_device_name() if cuda
                                  else "cpu")}
        key = tuple(labels.values())
        if state.get("key") != key:
            prev = state.get("child")
            if prev is not None:
                prev.set(0.0)
            state["key"] = key
            state["child"] = fam.labels(**labels)
        state["child"].set(1.0)

    reg.register_collector(collect)


install_build_info(metrics)


def enable() -> None:
    metrics.enable()
    tracer.enabled = True


def disable() -> None:
    metrics.disable()
    tracer.enabled = False


def iteration_span(engine: str, iteration: int, **args):
    """The span of one training iteration, honouring `config.sample_every`:
    the shared no-op for a sampled-out iteration, so the loop allocates
    nothing for it."""
    if not tracer.enabled or iteration % config.sample_every:
        return NOOP_SPAN
    return tracer.span(f"{engine}.iteration", cat="train", engine=engine,
                       iteration=iteration, **args)


def host_nbytes(*parts, device=None) -> int:
    """Bytes of the host-resident arrays among `parts` (arrays or tensors,
    lists or tuples of them, or None): what staging them to the device
    moves. A numpy array counts; a CPU tensor counts unless `device` (the
    batch's device) is the CPU; a tensor already on `device` counts 0, as
    a device-resident jax array counts 0 in the reference."""
    import numpy as np
    import torch

    on_cpu = device is not None and torch.device(device).type == "cpu"
    total = 0
    for part in parts:
        if part is None:
            continue
        arrays = part if isinstance(part, (list, tuple)) else [part]
        for a in arrays:
            if isinstance(a, np.ndarray):
                total += a.nbytes
            elif (isinstance(a, torch.Tensor) and a.device.type == "cpu"
                  and not on_cpu):
                total += a.numel() * a.element_size()
    return total


# ------------------------------------------------------------ compile hook

_hook_lock = threading.Lock()
_hook_installed = False
_hook_registries: list = []


def _register_hook_families(reg: MetricsRegistry) -> None:
    reg.counter("dl4j_xla_compiles_total",
                "XLA backend compiles observed via jax.monitoring "
                "(persistent-cache hits excluded)")
    reg.counter("dl4j_xla_compile_seconds_total",
                "Seconds in jax compile pipeline phases",
                label_names=("phase",))
    reg.counter("dl4j_compile_cache_hits_total",
                "Compile-cache hits by layer (aot = framework executable "
                "store, persistent = jax/XLA persistent compilation cache)",
                label_names=("source",))
    reg.counter("dl4j_compile_cache_misses_total",
                "Compile-cache misses by layer (see "
                "dl4j_compile_cache_hits_total)",
                label_names=("source",))
    # The default ladder: the reference's compilation store registers this
    # family first, so its scrapes carry that one.
    reg.histogram("dl4j_compile_seconds",
                  "Seconds to make one program runnable, by source (trace = "
                  "full lowering + backend compile, persistent = XLA cache "
                  "retrieval, aot = executable deserialization)",
                  label_names=("source",))


def _on_kernel_build(source: str, seconds: float) -> None:
    """One build of the kernel library (`kernels/_build.py`): an nvcc run
    (`source="trace"`) or a load of a cached build (`"persistent"`)."""
    for r in list(_hook_registries):
        if source == "trace":
            r.counter("dl4j_xla_compiles_total").inc()
            r.counter("dl4j_xla_compile_seconds_total",
                      label_names=("phase",)).labels(phase="nvcc").inc(
                          seconds)
            r.counter("dl4j_compile_cache_misses_total",
                      label_names=("source",)).labels(
                          source="persistent").inc()
        else:
            r.counter("dl4j_compile_cache_hits_total",
                      label_names=("source",)).labels(
                          source="persistent").inc()
        r.histogram("dl4j_compile_seconds", label_names=("source",)).labels(
            source=source).observe(seconds)


def install_compile_hook(registry: Optional[MetricsRegistry] = None) -> bool:
    """Feed the port's builds into the reference's compile families:

    - `dl4j_xla_compiles_total`: nvcc builds of the kernel library;
    - `dl4j_xla_compile_seconds_total{phase="nvcc"}`: their seconds;
    - `dl4j_compile_cache_hits_total` / `_misses_total{source=
      "persistent"}`: a load of a cached build from `build/kernels/` is a
      hit, an nvcc run a miss;
    - `dl4j_compile_seconds{source="trace" | "persistent"}`.

    A superstep's CUDA-graph capture is the engines' jit-cache miss and a
    replay a hit (`dl4j_jit_cache_*_total{engine}`, `nn/superstep.py`).
    The listener is installed once a process; a registry passed later is
    fanned out to. Returns True."""
    global _hook_installed
    reg = registry or metrics
    with _hook_lock:
        if reg not in _hook_registries:
            _hook_registries.append(reg)
            _register_hook_families(reg)
        if not _hook_installed:
            from deeplearning4j_tpu_torch.kernels import _build

            _build.build_listeners.append(_on_kernel_build)
            _hook_installed = True
    return True


# -------------------------------------------------------------- exposition


def prometheus_payload(fmt: str = "prometheus",
                       registry: Optional[MetricsRegistry] = None,
                       names: Optional[Any] = None):
    """One scrape body, `(body_bytes, content_type)`: Prometheus text
    0.0.4, or the JSON snapshot for `fmt="json"`. `names` (from
    `?names=a,b`) narrows the body to those families."""
    reg = registry or metrics
    if fmt == "json":
        return (json.dumps(reg.to_json(names=names)).encode(),
                "application/json")
    return (reg.to_prometheus(names=names).encode(),
            "text/plain; version=0.0.4")


# --------------------------------------------------------------- snapshot


def bench_snapshot(registry: Optional[MetricsRegistry] = None
                   ) -> Dict[str, Any]:
    """A compact summary of what was recorded: latency histogram summaries,
    build totals, MFU, jit-cache hits and misses, transfer and checkpoint
    bytes. Safe to call with nothing recorded."""
    reg = registry or metrics
    out: Dict[str, Any] = {}

    def family_values(name):
        fam = reg.get_family(name)
        if fam is None:
            return None
        vals = {}
        for child in fam.children():
            key = ",".join(f"{k}={v}" for k, v in child.labels.items()) or "_"
            vals[key] = child.get()
        return vals or None

    for hist in ("dl4j_step_latency_seconds", "dl4j_step_dispatch_seconds",
                 "dl4j_infer_latency_seconds", "dl4j_request_latency_seconds",
                 "dl4j_serving_request_seconds", "dl4j_serving_ttft_seconds",
                 "dl4j_serving_itl_seconds",
                 "dl4j_serving_decode_step_seconds", "dl4j_compile_seconds",
                 "dl4j_input_wait_seconds"):
        fam = reg.get_family(hist)
        if fam is None:
            continue
        for child in fam.children():
            summary = child.summarize()
            if not summary.get("count"):
                continue
            key = ",".join(f"{k}={v}" for k, v in child.labels.items())
            out.setdefault(hist, {})[key or "_"] = summary
    for name in ("dl4j_xla_compiles_total", "dl4j_xla_compile_seconds_total",
                 "dl4j_compile_cache_hits_total",
                 "dl4j_compile_cache_misses_total",
                 "dl4j_requests_total",
                 "dl4j_serving_generated_tokens_total",
                 "dl4j_serving_evictions_total",
                 "dl4j_tenant_device_seconds_total",
                 "dl4j_tenant_tokens_total",
                 "dl4j_jit_cache_hits_total", "dl4j_jit_cache_misses_total",
                 "dl4j_host_to_device_bytes_total",
                 "dl4j_checkpoint_bytes_written_total",
                 "dl4j_program_hbm_bytes", "dl4j_flight_dumps_total",
                 "dl4j_profiler_compile_seconds",
                 "dl4j_profiler_execute_seconds_median",
                 "dl4j_train_flops_per_step", "dl4j_train_mfu"):
        vals = family_values(name)
        if vals:
            out[name] = vals
    return out


# ---------------------------------------------------- the instrument tier
# Imported last: each resolves its families from `metrics` above.
# `flight` is the recorder INSTANCE (`observability.flight.dump()`); the
# module stays importable as `deeplearning4j_tpu_torch.observability.flight`
# (and runnable with -m). `request_ledger` is the ledger instance.

from deeplearning4j_tpu_torch.observability.profiler import (  # noqa: E402
    StepProfiler,
    chip_peak_flops,
    chip_peak_hbm_bw,
    estimate_step_cost,
    estimate_step_flops,
)
from deeplearning4j_tpu_torch.observability import memory  # noqa: E402,F401
from deeplearning4j_tpu_torch.observability.flight import (  # noqa: E402
    FlightRecorder,
    recorder as flight,
)
from deeplearning4j_tpu_torch.observability.ledger import (  # noqa: E402
    RequestLedger,
    ledger as request_ledger,
)
from deeplearning4j_tpu_torch.observability import slo  # noqa: E402,F401
