"""Declarative SLOs with multi-window burn-rate alerting (counterpart of
`deeplearning4j_tpu/observability/slo.py`, with a plain `threading.Lock`
where the reference takes a traced lock).

An SLO is a statement such as "99.9% of requests succeed" or "99% of
TTFTs land under 1 s", declared once (`Objective`) and evaluated against
the counters the serving tier already exports: no new instrumentation,
arithmetic over exposition deltas.

- **availability** objectives read `dl4j_requests_total{outcome}`: every
  outcome but ok is a bad event;
- **latency** objectives read a histogram (`dl4j_serving_ttft_seconds`,
  `dl4j_serving_itl_seconds`, `dl4j_serving_request_seconds{route=
  "predict"}`): a bad event is an observation above the threshold,
  counted exactly from the cumulative buckets (thresholds snap to bucket
  bounds).

Alerting follows the multi-window burn-rate recipe (Google SRE workbook,
ch. 5): burn = (bad / total) / error budget over a window, and an alert
fires only when both windows of a pair exceed the threshold (the short
one proves the burn is current, the long one that it is sustained):

    page:   burn > 14.4 over both  5m and 1h
    ticket: burn > 6    over both 30m and 6h

`window_scale` shrinks every window by one factor, so a test exercises
the multi-window logic in seconds.

The engine is pull-based: each `ingest()` parses one exposition (a
single process's, or a federated one whose samples carry ``worker_id``)
and appends one cumulative snapshot per worker; `evaluate()` differences
the snapshots at the window edges. `on_page(objective, workers)` fires
once when an objective starts paging (a server's `POST
/admin/flight-dump` is the evidence hook).
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


#: (severity, short_window_s, long_window_s, burn_threshold) — an alert
#: fires when burn exceeds the threshold over BOTH windows.
BURN_WINDOWS: Tuple[Tuple[str, float, float, float], ...] = (
    ("page", 300.0, 3600.0, 14.4),
    ("ticket", 1800.0, 21600.0, 6.0),
)

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[str, Dict[str, str],
                                                        float]]]:
    """Parse a (federated) Prometheus text exposition into per-worker
    samples: ``{worker_id: [(name, labels, value), ...]}``. Samples
    without a ``worker_id`` label (a plain single-process scrape) land
    under ``""``."""
    out: Dict[str, List[Tuple[str, Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = ({k: v for k, v in _LABEL_RE.findall(raw_labels)}
                  if raw_labels else {})
        wid = labels.pop("worker_id", "")
        out.setdefault(wid, []).append((name, labels, value))
    return out


class Objective:
    """One declarative SLO.

    `kind="availability"`: `target` is the success-ratio goal (0.999),
    bad events are `family{outcome != "ok"}` increments.

    `kind="latency"`: `target` is the quantile goal (0.99 for a p99
    objective), `threshold_s` the latency bound; bad events are
    histogram observations above the threshold. Pick thresholds on
    WIDE_BUCKETS bounds — the ladder counts them exactly.

    `labels` filters samples (e.g. ``{"route": "predict"}``); label
    keys absent from a sample don't match.
    """

    def __init__(self, name: str, kind: str, family: str, target: float,
                 threshold_s: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None,
                 description: str = ""):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown objective kind {kind!r}")
        if kind == "latency" and threshold_s is None:
            raise ValueError("latency objectives need threshold_s")
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        self.name = name
        self.kind = kind
        self.family = family
        self.target = float(target)
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.labels = dict(labels or {})
        self.description = description

    @property
    def budget(self) -> float:
        """Error budget: the tolerated bad-event fraction."""
        return 1.0 - self.target

    def _match(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.labels.items())

    def counts(self, samples: List[Tuple[str, Dict[str, str], float]]
               ) -> Tuple[float, float]:
        """(bad, total) cumulative event counts from one worker's
        samples."""
        bad = total = 0.0
        if self.kind == "availability":
            for name, labels, value in samples:
                if name != self.family or not self._match(labels):
                    continue
                total += value
                if labels.get("outcome") != "ok":
                    bad += value
            return bad, total
        # latency: cumulative bucket ladder. good = count(le <= threshold)
        # at the LARGEST such bound; total = the +Inf bucket.
        bucket_name = self.family + "_bucket"
        good_le = -1.0
        good = 0.0
        for name, labels, value in samples:
            if name != bucket_name or not self._match(labels):
                continue
            le = labels.get("le", "")
            if le in ("+Inf", "inf", "Inf"):
                total += value
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            if bound <= self.threshold_s and bound >= good_le:
                if bound > good_le:
                    good_le, good = bound, 0.0
                good += value
        return max(0.0, total - good), total

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "family": self.family, "target": self.target,
                "threshold_s": self.threshold_s, "labels": self.labels,
                "description": self.description}


def default_objectives() -> List[Objective]:
    """The stock SLOs: availability plus the three latency surfaces a
    generation service pages on. Thresholds sit
    on WIDE_BUCKETS bounds so the bucket math is exact."""
    return [
        Objective("availability", "availability", "dl4j_requests_total",
                  target=0.999,
                  description="99.9% of requests end ok (any route)"),
        Objective("ttft_p99", "latency", "dl4j_serving_ttft_seconds",
                  target=0.99, threshold_s=1.0,
                  description="99% of first tokens within 1s"),
        Objective("itl_p99", "latency", "dl4j_serving_itl_seconds",
                  target=0.99, threshold_s=0.25,
                  description="99% of inter-token gaps within 250ms"),
        Objective("predict_p99", "latency", "dl4j_serving_request_seconds",
                  target=0.99, threshold_s=1.0,
                  labels={"route": "predict"},
                  description="99% of predicts within 1s"),
    ]


class BurnRateEngine:
    """Ingest federated expositions, evaluate burn rates, raise alerts.

    `window_scale` multiplies every burn window (1.0 = production
    5m/1h/30m/6h; tests pass ~1/600 to page within a second of real
    traffic). `on_page` fires once per evaluation per NEWLY paging
    objective with ``(objective_name, [worker_id, ...])`` — the hook
    a caller uses to freeze flight bundles on the offenders; it does
    not re-fire while the same objective stays in page severity, so one
    sustained breach triggers one dump round.
    """

    def __init__(self, objectives: Optional[List[Objective]] = None,
                 window_scale: float = 1.0,
                 on_page: Optional[Callable[[str, List[str]], None]] = None,
                 history_s: Optional[float] = None):
        self.objectives = (default_objectives() if objectives is None
                           else list(objectives))
        self.window_scale = float(window_scale)
        self.on_page = on_page
        self.windows = [(sev, s * self.window_scale, l * self.window_scale,
                         burn) for sev, s, l, burn in BURN_WINDOWS]
        longest = max(l for _, _, l, _ in self.windows)
        self.history_s = (longest * 1.25 if history_s is None
                          else float(history_s))
        # {worker_id: deque[(t, {objective: (bad, total)})]}
        self._rings: Dict[str, deque] = {}
        self._paging: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- ingest

    def ingest(self, text: str, now: Optional[float] = None) -> None:
        """Fold one exposition (federated or single-process) into the
        per-worker sample rings."""
        t = time.monotonic() if now is None else float(now)
        parsed = parse_prometheus(text)
        with self._lock:
            for wid, samples in parsed.items():
                counts = {o.name: o.counts(samples)
                          for o in self.objectives}
                ring = self._rings.setdefault(wid, deque())
                ring.append((t, counts))
                while ring and t - ring[0][0] > self.history_s:
                    ring.popleft()

    # ----------------------------------------------------------- evaluate

    @staticmethod
    def _delta(ring: deque, objective: str, t: float,
               window: float) -> Tuple[float, float]:
        """(bad, total) increments over [t - window, t]: newest sample
        minus the oldest sample still inside the window."""
        newest = oldest = None
        for st, counts in ring:
            c = counts.get(objective)
            if c is None:
                continue
            if st >= t - window:
                if oldest is None:
                    oldest = c
                newest = c
        if newest is None or oldest is None or newest is oldest:
            return 0.0, 0.0
        # Counter resets (restart) clamp to zero rather than go negative.
        return (max(0.0, newest[0] - oldest[0]),
                max(0.0, newest[1] - oldest[1]))

    def _burns(self, ring: deque, o: Objective, t: float) -> dict:
        """Per-severity burn rates for one worker ring."""
        out = {}
        for sev, short_w, long_w, threshold in self.windows:
            rates = []
            for w in (short_w, long_w):
                bad, total = self._delta(ring, o.name, t, w)
                rates.append((bad / total / o.budget) if total else 0.0)
            out[sev] = {"short": rates[0], "long": rates[1],
                        "threshold": threshold,
                        "firing": all(r > threshold for r in rates)}
        return out

    def evaluate(self, now: Optional[float] = None) -> dict:
        """The SLO document: every objective's burn rates per
        severity, fleet-wide and per worker, plus the firing alerts.
        Severity = the worst firing pair (page > ticket > ok)."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            rings = {wid: deque(ring) for wid, ring in self._rings.items()}
        doc: dict = {"objectives": [], "alerts": []}
        pages: List[Tuple[str, List[str]]] = []
        now_paging: set = set()
        for o in self.objectives:
            workers = {}
            offenders: Dict[str, List[str]] = {}
            for wid, ring in rings.items():
                burns = self._burns(ring, o, t)
                sev = next((s for s in ("page", "ticket")
                            if burns.get(s, {}).get("firing")), "ok")
                workers[wid] = {"severity": sev, "burns": burns}
                if sev != "ok":
                    offenders.setdefault(sev, []).append(wid)
            severity = next((s for s in ("page", "ticket")
                             if offenders.get(s)), "ok")
            entry = dict(o.to_dict(), severity=severity, workers=workers)
            doc["objectives"].append(entry)
            if severity != "ok":
                doc["alerts"].append({
                    "objective": o.name, "severity": severity,
                    "workers": sorted(offenders[severity])})
            if offenders.get("page"):
                now_paging.add(o.name)
                if o.name not in self._paging:
                    pages.append((o.name, sorted(offenders["page"])))
        with self._lock:
            self._paging = now_paging
        if self.on_page is not None:
            for name, wids in pages:
                try:
                    self.on_page(name, wids)
                except Exception:
                    pass
        doc["severity"] = next(
            (s for s in ("page", "ticket")
             if any(a["severity"] == s for a in doc["alerts"])), "ok")
        return doc

    def report(self, text: str, now: Optional[float] = None) -> dict:
        """ingest + evaluate in one call — the pull-based entry point a
        GET handler uses: scrape, fold it in, return
        the current alert state."""
        self.ingest(text, now=now)
        return self.evaluate(now=now)
