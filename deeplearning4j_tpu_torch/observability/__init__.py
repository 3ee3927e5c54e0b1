"""The metrics registry that the serving tier's `GET /metrics` serves
(counterpart of `deeplearning4j_tpu/observability/`, its registry and
`prometheus_payload` only).

`metrics` is the process-global `MetricsRegistry`; `prometheus_payload`
renders one scrape body. The tracer, the step profiler, the flight
recorder, memory accounting, the request ledger and the SLO engine come
with ROADMAP A.14.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from deeplearning4j_tpu_torch.observability.metrics import (
    DEFAULT_BUCKETS,
    WIDE_BUCKETS,
    MetricsRegistry,
    install_builtin_collectors,
)

__all__ = ["metrics", "MetricsRegistry", "DEFAULT_BUCKETS", "WIDE_BUCKETS",
           "prometheus_payload"]

metrics = MetricsRegistry()
install_builtin_collectors(metrics)


def prometheus_payload(fmt: str = "prometheus",
                       names: Optional[Any] = None):
    """One scrape body of the process-global registry, `(body_bytes,
    content_type)`: Prometheus text 0.0.4, or the JSON snapshot for
    `fmt="json"`. `names` (from `?names=a,b`) narrows the body to those
    families."""
    if fmt == "json":
        return (json.dumps(metrics.to_json(names=names)).encode(),
                "application/json")
    return (metrics.to_prometheus(names=names).encode(),
            "text/plain; version=0.0.4")
