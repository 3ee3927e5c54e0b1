"""Serving-tier instruments on the process-global registry (a copy of the
families of `deeplearning4j_tpu/serving/metrics.py:20-175` that the port's
serving tier feeds, with the reference's names, help, kinds, buckets and
label names in its order).

- The unlabeled families (`dl4j_serving_requests_total{outcome}`,
  `dl4j_request_latency_seconds`, `dl4j_serving_batch_size`,
  `dl4j_serving_queue_depth`) keep the reference's older shapes.
- The SLO families are labeled per model and route.
- The paged-decode families: KV pages, prefix-cache hits and misses,
  speculative proposals.
- The hosting and adapter families (`HOSTING_FAMILIES`): a model's HBM
  bytes, the models resident, evictions, the adapters resident and the
  requests through each adapter. They appear in a scrape once a server
  has hosted, evicted or served through an adapter.
- The accounting families (`ACCOUNTING_FAMILIES`, reference :122-147):
  the dispatch seconds measured at the two dispatch points, and their
  split by tenant with the tenants' tokens (`observability/ledger.py`).

Families still to come: the sharding gauge and the fleet and router
families with A.13.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch import observability as _obs

# ---------------------------------------------------------------- legacy
REQUESTS_LEGACY = _obs.metrics.counter(
    "dl4j_serving_requests_total", "predict() requests",
    label_names=("outcome",))
REQ_LATENCY = _obs.metrics.histogram(
    "dl4j_request_latency_seconds",
    "End-to-end predict() latency (queue wait + batch + forward)",
    buckets=_obs.WIDE_BUCKETS)
BATCH_SIZE = _obs.metrics.histogram(
    "dl4j_serving_batch_size",
    "Real (pre-padding) rows per coalesced inference batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
QUEUE_DEPTH = _obs.metrics.gauge(
    "dl4j_serving_queue_depth",
    "Requests waiting in the batcher queue (scrape-time)")

# ------------------------------------------------------------------- SLO
REQUESTS = _obs.metrics.counter(
    "dl4j_requests_total",
    "Serving requests by model, route and outcome (ok / timeout / shed / "
    "invalid / error)",
    label_names=("model", "route", "outcome"))
REQUEST_SECONDS = _obs.metrics.histogram(
    "dl4j_serving_request_seconds",
    "Per-model end-to-end request latency (SLO histogram: p50/p99 via "
    "bucket interpolation)",
    label_names=("model", "route"), buckets=_obs.WIDE_BUCKETS)
TTFT_SECONDS = _obs.metrics.histogram(
    "dl4j_serving_ttft_seconds",
    "Generation time-to-first-token: submit -> first sampled token",
    label_names=("model",), buckets=_obs.WIDE_BUCKETS)
DECODE_STEP_SECONDS = _obs.metrics.histogram(
    "dl4j_serving_decode_step_seconds",
    "One continuous-batching decode step (all slots, one dispatch)",
    label_names=("model",))
ITL_SECONDS = _obs.metrics.histogram(
    "dl4j_serving_itl_seconds",
    "Inter-token latency: wall-clock gap between consecutive sampled "
    "tokens of ONE request (the per-request token-gap distribution the "
    "SLO engine's itl_p99 objective reads; TTFT covers the first token)",
    label_names=("model",), buckets=_obs.WIDE_BUCKETS)
GENERATED_TOKENS = _obs.metrics.counter(
    "dl4j_serving_generated_tokens_total",
    "Tokens sampled by the generation scheduler",
    label_names=("model",))
MODEL_QUEUE_DEPTH = _obs.metrics.gauge(
    "dl4j_serving_model_queue_depth",
    "Queued requests per model and route (scrape-time)",
    label_names=("model", "route"))
MODEL_HBM_BYTES = _obs.metrics.gauge(
    "dl4j_serving_model_hbm_bytes",
    "Estimated device-resident bytes per hosted model (params + state; "
    "checkpoint manifest size before load)",
    label_names=("model",))
MODEL_DTYPE = _obs.metrics.gauge(
    "dl4j_serving_model_dtype",
    "Info gauge (value 1): the serving dtype of each hosted model — "
    "'int8' for post-training-quantized weights, else the param dtype "
    "(float32/bfloat16/...). Join on {model} with "
    "dl4j_serving_model_hbm_bytes to attribute HBM by precision",
    label_names=("model", "dtype"))
MODELS_RESIDENT = _obs.metrics.gauge(
    "dl4j_serving_models_resident",
    "Hosted models currently resident (loaded) in this process")
EVICTIONS = _obs.metrics.counter(
    "dl4j_serving_evictions_total",
    "LRU evictions of cold models from the multi-model host",
    label_names=("model",))
DECODE_SLOTS_BUSY = _obs.metrics.gauge(
    "dl4j_serving_decode_slots_busy",
    "Generation scheduler slots currently holding an active sequence",
    label_names=("model",))

# ------------------------------------------------------------- paged decode
KV_PAGES = _obs.metrics.gauge(
    "dl4j_kv_pages",
    "KV page-pool pages by state: free (allocatable), used (refcount 1), "
    "shared (refcount >= 2 — prefix pages resident once for N readers). "
    "The reserved zero page is none of them",
    label_names=("model", "state"))
PREFIX_CACHE_HITS = _obs.metrics.counter(
    "dl4j_prefix_cache_hits_total",
    "Generation admissions that reused a cached prompt prefix (prefill "
    "skipped entirely; TTFT ~ one decode step)",
    label_names=("model",))
PREFIX_CACHE_MISSES = _obs.metrics.counter(
    "dl4j_prefix_cache_misses_total",
    "Generation admissions that prefilled from scratch (prompt not in the "
    "prefix cache)",
    label_names=("model",))
SPECULATIVE_TOKENS = _obs.metrics.counter(
    "dl4j_speculative_tokens_total",
    "Draft-model speculative proposals by outcome: accepted (target's "
    "greedy argmax agreed — token emitted without its own target step) or "
    "rejected (disagreed — rewound). accepted/(accepted+rejected) is the "
    "measured accept rate alpha in PERF.md §23",
    label_names=("model", "outcome"))

# ----------------------------------------------------------- multi-tenant
# LoRA adapter serving (nn/lora.py, checkpoint/adapters.py): rank-r deltas
# resident next to one base model, selected per request.
ADAPTERS_RESIDENT = _obs.metrics.gauge(
    "dl4j_adapters_resident",
    "LoRA adapters loaded next to each hosted base model (each is a "
    "rank-r delta, typically <1% of the base's HBM — see /v1/models for "
    "per-adapter bytes)",
    label_names=("model",))
ADAPTER_REQUESTS = _obs.metrics.counter(
    "dl4j_adapter_requests_total",
    "Requests served through a named LoRA adapter over a shared base, by "
    "outcome (ok / timeout / shed / failed) — per-tenant error rates "
    "without joining the ledger (adapter='' rows would be the base "
    "itself; those count only under dl4j_requests_total)",
    label_names=("model", "adapter", "outcome"))

# ------------------------------------------------------------- accounting
# Per-tenant cost attribution (observability/ledger.py): each batched
# dispatch's wall time is split across the requests it served at the two
# dispatch points (batcher._run_group, the scheduler's decode rounds) and
# summed by (model, adapter). adapter='' is the base model's traffic.
DISPATCH_SECONDS = _obs.metrics.counter(
    "dl4j_serving_dispatch_seconds_total",
    "Total measured dispatch wall seconds at the serving choke points, "
    "UNSPLIT (phase: forward = batcher sub-batch, prefill = prompt "
    "install, decode = one decode/speculative round). The per-tenant "
    "split of the same durations lands in "
    "dl4j_tenant_device_seconds_total; across tenants the two must "
    "reconcile",
    label_names=("model", "phase"))
TENANT_DEVICE_SECONDS = _obs.metrics.counter(
    "dl4j_tenant_device_seconds_total",
    "Attributed device-seconds per tenant: each dispatch's wall time "
    "split across co-batched requests (by row share in the batcher, "
    "evenly across active slots in the decode loop). Sums to total "
    "measured dispatch seconds across tenants",
    label_names=("model", "adapter"))
TENANT_TOKENS = _obs.metrics.counter(
    "dl4j_tenant_tokens_total",
    "Tokens in/out per tenant (direction: in = prompt tokens admitted, "
    "out = tokens sampled). Predict rows count as 'in' per input row",
    label_names=("model", "adapter", "direction"))

# The families above but the hosting ones, by name (what a scrape of any
# serving tier carries).
FAMILIES = tuple(f.name for f in (
    REQUESTS_LEGACY, REQ_LATENCY, BATCH_SIZE, QUEUE_DEPTH, REQUESTS,
    REQUEST_SECONDS, TTFT_SECONDS, DECODE_STEP_SECONDS, ITL_SECONDS,
    GENERATED_TOKENS, MODEL_QUEUE_DEPTH, MODEL_DTYPE, DECODE_SLOTS_BUSY,
    KV_PAGES, PREFIX_CACHE_HITS, PREFIX_CACHE_MISSES, SPECULATIVE_TOKENS))
# The hosting and adapter families (children once a server hosts, evicts
# or serves through an adapter).
HOSTING_FAMILIES = tuple(f.name for f in (
    MODEL_HBM_BYTES, MODELS_RESIDENT, EVICTIONS, ADAPTERS_RESIDENT,
    ADAPTER_REQUESTS))
# The accounting families (children once a model dispatches; the tenant
# ones once a request closes in the ledger).
ACCOUNTING_FAMILIES = tuple(f.name for f in (
    DISPATCH_SECONDS, TENANT_DEVICE_SECONDS, TENANT_TOKENS))
