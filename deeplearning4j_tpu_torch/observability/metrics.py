"""Thread-safe metrics registry: labeled counters, gauges and histograms
(a copy of `deeplearning4j_tpu/observability/metrics.py:1-380`, with a
plain `threading.RLock` where the reference takes a traced lock).

- Callers resolve `.labels(...)` children once; `inc()` / `observe()` on a
  child is one lock and one float operation. (The reference's switch that
  turns every mutator into a no-op is not ported: nothing here turns it.)
- Exposition is the Prometheus text format 0.0.4 (label escaping,
  cumulative `_bucket` / `_sum` / `_count` for histograms), or a JSON
  snapshot.

Collectors run at scrape time only. The process RSS gauge is here; the
reference's live jax-buffer gauges are not (they read jax).
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets (seconds).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# For families whose observations run to seconds or minutes (a request
# behind a long prefill): the default ladder would clamp their p99 into
# `+Inf`.
WIDE_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Dict[str, str],
               extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in items) + "}"


class _Child:
    """One labeled series."""

    __slots__ = ("_reg", "labels", "_value", "_sum", "_count",
                 "_bucket_counts", "_buckets", "_fn")

    def __init__(self, reg: "MetricsRegistry", labels: Dict[str, str],
                 buckets: Optional[Sequence[float]] = None):
        self._reg = reg
        self.labels = labels
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._buckets = None if buckets is None else tuple(buckets)
        if self._buckets is not None:
            self._bucket_counts = [0] * (len(self._buckets) + 1)  # + +Inf
            self._sum = 0.0
            self._count = 0

    # counter / gauge
    def inc(self, v: float = 1.0) -> None:
        with self._reg._lock:
            self._value += v

    def set(self, v: float) -> None:
        with self._reg._lock:
            self._value = float(v)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Scrape-time gauge: `fn()` is called at exposition (queue
        depths, page counts: things with a current value)."""
        self._fn = fn

    def get(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    # histogram
    def observe(self, v: float) -> None:
        with self._reg._lock:
            self._bucket_counts[bisect.bisect_left(self._buckets, v)] += 1
            self._sum += v
            self._count += 1

    def histogram_state(self):
        """(buckets, cumulative counts with +Inf, sum, count)."""
        with self._reg._lock:
            raw = list(self._bucket_counts)
            s, c = self._sum, self._count
        cum, running = [], 0
        for n in raw:
            running += n
            cum.append(running)
        return self._buckets, cum, s, c

    def summarize(self, quantiles=(0.5, 0.9, 0.99)) -> Dict[str, float]:
        """Bucket-interpolated quantiles, with count, sum and mean."""
        buckets, cum, s, c = self.histogram_state()
        out: Dict[str, float] = {"count": c, "sum": s}
        if not c:
            return out
        out["mean"] = s / c
        edges = list(buckets) + [float("inf")]
        for q in quantiles:
            target = q * c
            prev_cum, lo = 0, 0.0
            val = edges[-2] if len(edges) > 1 else 0.0
            for i, cm in enumerate(cum):
                if cm >= target:
                    hi = edges[i]
                    if hi == float("inf"):
                        hi = edges[i - 1] if i else 0.0
                    inbucket = cm - prev_cum
                    frac = ((target - prev_cum) / inbucket) if inbucket \
                        else 1.0
                    val = lo + (hi - lo) * frac
                    break
                prev_cum, lo = cm, edges[i]
            out[f"p{int(q * 100)}"] = val
        return out


class _Family:
    __slots__ = ("_reg", "name", "help", "kind", "label_names", "_children",
                 "_buckets", "_default")

    def __init__(self, reg, name, help_, kind, label_names, buckets=None):
        self._reg = reg
        self.name = name
        self.help = help_
        self.kind = kind
        self.label_names = tuple(label_names)
        self._buckets = buckets
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._default = None if self.label_names else self.labels()

    def labels(self, **kv: str) -> _Child:
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._reg._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self._reg, dict(zip(self.label_names, key)),
                               buckets=self._buckets)
                self._children[key] = child
        return child

    # An unlabeled family acts as its own single child.
    def _only(self) -> _Child:
        if self._default is None:
            raise ValueError(f"{self.name} is labeled; call .labels(...)")
        return self._default

    def inc(self, v: float = 1.0) -> None:
        self._only().inc(v)

    def set(self, v: float) -> None:
        self._only().set(v)

    def set_function(self, fn) -> None:
        self._only().set_function(fn)

    def get(self) -> float:
        return self._only().get()

    def observe(self, v: float) -> None:
        self._only().observe(v)

    def summarize(self, **kw):
        return self._only().summarize(**kw)

    def children(self) -> List[_Child]:
        with self._reg._lock:
            return list(self._children.values())


class MetricsRegistry:
    """See module docstring. `deeplearning4j_tpu_torch.observability
    .metrics` is the process-global one; tests may build their own."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _family(self, name, help_, kind, label_names, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name} already registered as {fam.kind}"
                        f"{fam.label_names}, cannot re-register as {kind}"
                        f"{tuple(label_names)}")
                return fam
            fam = _Family(self, name, help_, kind, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> _Family:
        return self._family(name, help, "counter", label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> _Family:
        return self._family(name, help, "gauge", label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, help, "histogram", label_names,
                            buckets=tuple(sorted(buckets)))

    def register_collector(self,
                           fn: Callable[["MetricsRegistry"], None]) -> None:
        """`fn(registry)` runs at every full scrape; a failing collector
        is skipped and never takes the scrape down."""
        self._collectors.append(fn)

    def get_family(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def _run_collectors(self) -> None:
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                pass

    def to_prometheus(self, names: Optional[Sequence[str]] = None) -> str:
        """Prometheus text format 0.0.4. `names` narrows the exposition to
        the listed families and skips the collectors."""
        if names is None:
            self._run_collectors()
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        if names is not None:
            wanted = frozenset(names)
            fams = [f for f in fams if f.name in wanted]
        for fam in fams:
            children = fam.children()
            if not children:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_label(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in children:
                if fam.kind == "histogram":
                    buckets, cum, s, c = child.histogram_state()
                    for le, cm in zip(buckets, cum[:-1]):
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_label_str(child.labels, ('le', _fmt(le)))}"
                            f" {cm}")
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_label_str(child.labels, ('le', '+Inf'))} {c}")
                    lines.append(f"{fam.name}_sum"
                                 f"{_label_str(child.labels)} "
                                 f"{repr(float(s))}")
                    lines.append(
                        f"{fam.name}_count{_label_str(child.labels)} {c}")
                else:
                    lines.append(
                        f"{fam.name}{_label_str(child.labels)} "
                        f"{_fmt(child.get())}")
        return "\n".join(lines) + "\n"

    def to_json(self, names: Optional[Sequence[str]] = None
                ) -> Dict[str, Any]:
        """Structured snapshot (`/metrics?format=json`); `names` narrows it
        as in `to_prometheus`."""
        if names is None:
            self._run_collectors()
        out: Dict[str, Any] = {}
        with self._lock:
            fams = list(self._families.values())
        if names is not None:
            wanted = frozenset(names)
            fams = [f for f in fams if f.name in wanted]
        for fam in fams:
            series = []
            for child in fam.children():
                if fam.kind == "histogram":
                    buckets, cum, s, c = child.histogram_state()
                    series.append({
                        "labels": child.labels,
                        "count": c, "sum": s,
                        "buckets": {_fmt(le): cm
                                    for le, cm in zip(buckets, cum[:-1])},
                        "summary": child.summarize(),
                    })
                else:
                    series.append({"labels": child.labels,
                                   "value": child.get()})
            if series:
                out[fam.name] = {"type": fam.kind, "help": fam.help,
                                 "series": series}
        return out


def _host_rss_bytes() -> Optional[float]:
    try:
        import os

        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        return None


def install_builtin_collectors(reg: MetricsRegistry) -> None:
    """The process RSS, sampled at scrape time."""
    rss = reg.gauge("dl4j_process_resident_memory_bytes",
                    "Resident set size of this process")

    def collect(_reg: MetricsRegistry) -> None:
        v = _host_rss_bytes()
        if v is not None:
            rss.set(v)

    reg.register_collector(collect)
