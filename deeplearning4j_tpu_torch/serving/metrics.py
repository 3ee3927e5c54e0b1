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

Families still to come: HBM bytes and residency, evictions and the
adapter families with A.12 (multi-model hosting, LoRA); the sharding
gauge and the fleet and router families with A.13; dispatch seconds and
the per-tenant families with A.14 (the request ledger).
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
MODEL_DTYPE = _obs.metrics.gauge(
    "dl4j_serving_model_dtype",
    "Info gauge (value 1): the serving dtype of each hosted model — "
    "'int8' for post-training-quantized weights, else the param dtype "
    "(float32/bfloat16/...). Join on {model} with "
    "dl4j_serving_model_hbm_bytes to attribute HBM by precision",
    label_names=("model", "dtype"))
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

# The families above, by name (what a scrape of this tier carries).
FAMILIES = tuple(f.name for f in (
    REQUESTS_LEGACY, REQ_LATENCY, BATCH_SIZE, QUEUE_DEPTH, REQUESTS,
    REQUEST_SECONDS, TTFT_SECONDS, DECODE_STEP_SECONDS, ITL_SECONDS,
    GENERATED_TOKENS, MODEL_QUEUE_DEPTH, MODEL_DTYPE, DECODE_SLOTS_BUSY,
    KV_PAGES, PREFIX_CACHE_HITS, PREFIX_CACHE_MISSES, SPECULATIVE_TOKENS))
