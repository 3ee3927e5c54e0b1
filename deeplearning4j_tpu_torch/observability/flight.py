"""FlightRecorder: always-on crash and preemption forensics (counterpart
of `deeplearning4j_tpu/observability/flight.py:59-577`).

A fixed-size ring of per-step records fed from the engines'
`_fit_dispatch`: iteration, loss, dispatch seconds and superstep `k`,
build and capture deltas, host->device bytes, input wait, the card's
allocated bytes. Recording is one enabled check, one dict and one
append. The loss is kept as the device tensor and read only at a dump,
so recording never syncs the step; a superstep's record keeps its K
losses (`losses`), the copies its replay returned, never the graph's
static buffers, which the next replay overwrites.

A **dump** writes a bundle directory:

- ``MANIFEST.json``  reason, exception, env / version fingerprint
- ``steps.jsonl``    the ring, one JSON record a line (oldest first)
- ``trace.json``     Chrome trace: the span ring plus the ring's steps as
  ``X`` events (open in ui.perfetto.dev)
- ``metrics.json``   the registry (`MetricsRegistry.to_json`)
- ``ledger.jsonl``   recently closed request-ledger records
  (`observability/ledger.py`)
- ``allocator.json`` in place of the reference's ``memory.pprof`` (a jax
  device-memory profile): the caching allocator's state,
  `torch.cuda.memory_stats()` and `torch.cuda.memory._snapshot()`'s
  segments, when the process has a card.

Triggers: uncaught dispatch exceptions (`on_crash`, which records and
returns; the caller re-raises), serving loop failures, SIGTERM / SIGINT
(handlers installed lazily on the first recorded step, from the main
thread only) and an explicit ``observability.flight.dump()``. Automatic
triggers are rate-limited per reason. (The reference's NaN-loss trigger
belongs to its `analysis/runtime.py` guard, ROADMAP A.17.)

Env knobs (read once at import):

- ``DL4J_TPU_FLIGHT``                "0" / "false" / "off" disables
  recording (dump() still writes bundles on demand)
- ``DL4J_TPU_FLIGHT_RING``           ring capacity in steps (default 512)
- ``DL4J_TPU_FLIGHT_DIR``            bundle root (default
  ``./flight_recordings``)
- ``DL4J_TPU_FLIGHT_SIGNALS``        "0" skips the SIGTERM / SIGINT hooks
- ``DL4J_TPU_FLIGHT_MIN_INTERVAL_S`` per-reason rate limit of automatic
  dumps (default 10 s; explicit dumps ignore it)
- ``DL4J_TPU_FLIGHT_LIVE_EVERY``     read the card's allocated bytes every
  Nth record (default 8)

Inspect a bundle with ``python -m deeplearning4j_tpu_torch.observability
.flight <bundle-dir>``; it reads the reference's bundles too.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _finite(v):
    """JSON/trace-safe number: non-finite floats become their repr."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def _scalar(v):
    """A recorded loss (a device or host scalar) as a JSON-safe float (the
    read of a device tensor waits for its step); None if unreadable."""
    try:
        return _finite(float(v))
    except Exception:
        return None


class FlightRecorder:
    """See module docstring. One instance (`observability.flight`) is the
    process-global recorder; tests build their own."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 dump_dir: Optional[str] = None):
        if capacity is None:
            capacity = _env_int("DL4J_TPU_FLIGHT_RING", 512)
        self.enabled = (_env_flag("DL4J_TPU_FLIGHT")
                        if enabled is None else bool(enabled))
        self.dump_dir = dump_dir or os.environ.get(
            "DL4J_TPU_FLIGHT_DIR", os.path.join(".", "flight_recordings"))
        self.min_interval_s = _env_float("DL4J_TPU_FLIGHT_MIN_INTERVAL_S",
                                         10.0)
        self.live_every = max(1, _env_int("DL4J_TPU_FLIGHT_LIVE_EVERY", 8))
        self._ring: deque = deque(maxlen=max(8, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._last_live_bytes: Optional[int] = None
        self._last_counts: Dict[str, float] = {}  # per-engine jit cumulatives
        self._compile_family = None
        self._compiles_prev: Optional[float] = None
        self._last_dump_at: Dict[str, float] = {}  # reason -> monotonic
        self._dumps: List[str] = []
        # The reason of the last bundle written (a graceful exit after a
        # signal's dump reads it, so one preemption writes one bundle).
        self.last_dump_reason: Optional[str] = None
        self._signals_installed = False
        self._prev_handlers: Dict[int, Any] = {}
        # The installed handler, exposed so a cooperating handler can tell
        # it by identity (it re-raises the signal when its previous
        # disposition was the default, to keep the exit status).
        self.signal_handler: Any = None

    # -------------------------------------------------------------- feeding

    def record_step(self, engine: str, iteration: int, loss=None,
                    seconds: float = 0.0, k: int = 1, h2d_bytes: int = 0,
                    input_wait: Optional[float] = None,
                    jit_hits: Optional[float] = None,
                    jit_misses: Optional[float] = None,
                    losses=None) -> None:
        """One ring record a dispatch (called from `_fit_dispatch` on every
        training path; a superstep's gives its K losses as `losses`).
        Never raises, never syncs."""
        if not self.enabled:
            return
        try:
            self._maybe_install_signals()
            rec = {
                "type": "step",
                "engine": engine,
                "iteration": int(iteration),
                "loss": loss,  # raw scalar; materialized at dump time
                "seconds": float(seconds),
                "k": int(k),
                "h2d_bytes": int(h2d_bytes),
                "t_ns": time.perf_counter_ns(),
                "tid": threading.get_ident() & 0x7FFFFFFF,
            }
            if input_wait is not None:
                rec["input_wait"] = float(input_wait)
            if losses is not None:
                rec["losses"] = list(losses)  # raw; read at the dump
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                self._add_deltas(rec, engine, jit_hits, jit_misses)
                if self._seq % self.live_every == 1 or self.live_every == 1:
                    self._last_live_bytes = self._live_buffer_bytes()
                if self._last_live_bytes is not None:
                    rec["live_buffer_bytes"] = self._last_live_bytes
                self._ring.append(rec)
        except Exception:
            pass

    def record_event(self, kind: str, **fields) -> None:
        """Non-step ring event (NaN marker, serving failure, ...)."""
        if not self.enabled:
            return
        try:
            rec = {"type": str(kind), "t_ns": time.perf_counter_ns(),
                   "tid": threading.get_ident() & 0x7FFFFFFF}
            rec.update(fields)
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                self._ring.append(rec)
        except Exception:
            pass

    def _add_deltas(self, rec, engine, jit_hits, jit_misses) -> None:
        """Build and capture deltas since the previous record (the engine
        passes its own cumulative capture counters; the build total is one
        small registry-family sum)."""
        compiles = self._compiles_total()
        if compiles is not None:
            prev = self._compiles_prev
            if prev is not None:
                rec["compile_delta"] = compiles - prev
            self._compiles_prev = compiles
        for name, cum in (("jit_hits", jit_hits), ("jit_misses", jit_misses)):
            if cum is None:
                continue
            key = f"{engine}.{name}"
            prev = self._last_counts.get(key)
            if prev is not None:
                rec[f"{name}_delta"] = cum - prev
            self._last_counts[key] = cum

    def _compiles_total(self) -> Optional[float]:
        try:
            if self._compile_family is None:
                from deeplearning4j_tpu_torch import observability as _obs

                self._compile_family = _obs.metrics.get_family(
                    "dl4j_xla_compiles_total")
            fam = self._compile_family
            if fam is None:
                return None
            return sum(c.get() for c in fam.children())
        except Exception:
            return None

    def _live_buffer_bytes(self) -> Optional[int]:
        """The card's allocated bytes (an allocator counter, no sync); None
        in a process that has not started CUDA."""
        torch = sys.modules.get("torch")
        try:
            if torch is None or not torch.cuda.is_initialized():
                return None
            return int(torch.cuda.memory_allocated())
        except Exception:
            return None

    # ------------------------------------------------------------- triggers

    def on_crash(self, where: str, exc: BaseException) -> Optional[str]:
        """Uncaught-failure trigger (engine dispatch, serving loops):
        records the event and writes a rate-limited bundle; returns its
        path. Never raises: the caller re-raises `exc`."""
        try:
            self.record_event("crash", where=str(where),
                              error=f"{type(exc).__name__}: {exc}")
            return self.dump(reason=f"crash:{where}", exc=exc, force=False)
        except Exception:
            return None

    def _maybe_install_signals(self) -> None:
        if self._signals_installed or not _env_flag("DL4J_TPU_FLIGHT_SIGNALS"):
            return
        if threading.current_thread() is not threading.main_thread():
            return
        import signal

        self._signals_installed = True  # one attempt per process

        def handler(signum, frame):
            try:
                name = signal.Signals(signum).name
            except Exception:
                name = str(signum)
            try:
                self.dump(reason=f"signal:{name}", force=True)
            except Exception:
                pass
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                # restore the default disposition and re-raise so the
                # process still dies with the right signal status
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

        self.signal_handler = handler
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.getsignal(sig)
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    # ----------------------------------------------------------------- dump

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Materialized (JSON-ready) copies of the ring, oldest first."""
        with self._lock:
            records = list(self._ring)
        if limit is not None:
            records = records[-int(limit):]
        return [self._materialize(r) for r in records]

    def _materialize(self, rec: dict) -> dict:
        out = dict(rec)
        loss = out.get("loss")
        if loss is not None:
            out["loss"] = _scalar(loss)
        if out.get("losses") is not None:
            out["losses"] = [_scalar(v) for v in out["losses"]]
        return out

    def dump(self, reason: str = "manual", exc: Optional[BaseException] = None,
             bundle_dir: Optional[str] = None, force: bool = True
             ) -> Optional[str]:
        """Write a forensics bundle; returns its path (None when a
        rate-limited automatic trigger was suppressed). `force=True`
        (the default for explicit calls) bypasses the per-reason rate
        limit."""
        now = time.monotonic()
        with self._lock:
            if not force:
                last = self._last_dump_at.get(reason)
                if last is not None and now - last < self.min_interval_s:
                    return None
            self._last_dump_at[reason] = now
        try:
            return self._write_bundle(reason, exc, bundle_dir)
        except Exception:
            return None

    def _write_bundle(self, reason, exc, bundle_dir) -> str:
        records = self.snapshot()
        if bundle_dir is None:
            slug = "".join(c if c.isalnum() or c in "-_." else "-"
                           for c in reason)[:60]
            stamp = time.strftime("%Y%m%d-%H%M%S")
            bundle_dir = os.path.join(
                self.dump_dir, f"{stamp}-pid{os.getpid()}-{slug}")
        os.makedirs(bundle_dir, exist_ok=True)

        manifest = self._manifest(reason, exc, len(records))
        with open(os.path.join(bundle_dir, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=2, default=str)

        with open(os.path.join(bundle_dir, "steps.jsonl"), "w") as f:
            for rec in records:
                f.write(json.dumps(
                    {k: _finite(v) for k, v in rec.items()},
                    default=str) + "\n")

        with open(os.path.join(bundle_dir, "trace.json"), "w") as f:
            json.dump(self._chrome_trace(records), f, default=str)

        try:
            from deeplearning4j_tpu_torch import observability as _obs

            with open(os.path.join(bundle_dir, "metrics.json"), "w") as f:
                json.dump(_obs.metrics.to_json(), f, default=str)
        except Exception:
            pass

        # Join the request-lifecycle ledger: the same bundle that shows
        # WHERE the process was (steps/trace) shows WHICH requests were
        # in flight and who they were billed to.
        try:
            from deeplearning4j_tpu_torch.observability.ledger import (
                ledger as _ledger)

            records = _ledger.snapshot()
            if records:
                with open(os.path.join(bundle_dir, "ledger.jsonl"),
                          "w") as f:
                    for rec in records:
                        f.write(json.dumps(rec, default=str) + "\n")
        except Exception:
            pass

        self._write_allocator(os.path.join(bundle_dir, "allocator.json"))

        try:
            from deeplearning4j_tpu_torch import observability as _obs

            _obs.metrics.counter(
                "dl4j_flight_dumps_total", "Flight-recorder bundle dumps",
                label_names=("reason",)).labels(
                    reason=reason.split(":", 1)[0]).inc()
        except Exception:
            pass
        with self._lock:
            self._dumps.append(bundle_dir)
            self.last_dump_reason = reason
        return bundle_dir

    def _manifest(self, reason, exc, n_records) -> Dict[str, Any]:
        manifest: Dict[str, Any] = {
            "bundle_format": 1,
            "reason": reason,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "cwd": os.getcwd(),
            "records": n_records,
            "ring_capacity": self._ring.maxlen,
        }
        if exc is not None:
            manifest["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }
        versions: Dict[str, Any] = {
            "python": sys.version.split()[0],
        }
        try:
            import deeplearning4j_tpu_torch

            versions["deeplearning4j_tpu_torch"] = (
                deeplearning4j_tpu_torch.__version__)
        except Exception:
            pass
        torch = sys.modules.get("torch")
        if torch is not None:
            try:
                versions["torch"] = torch.__version__
                versions["cuda"] = torch.version.cuda
                if torch.cuda.is_initialized():
                    versions["devices"] = [
                        torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            except Exception:
                pass
        manifest["versions"] = versions
        manifest["env"] = {k: v for k, v in sorted(os.environ.items())
                           if k.startswith(("DL4J_TPU_", "CUDA_", "TORCH_"))}
        return manifest

    def _chrome_trace(self, records) -> Dict[str, Any]:
        """Span buffer + ring steps as one Chrome trace document."""
        try:
            from deeplearning4j_tpu_torch import observability as _obs

            events = _obs.tracer.events()
            epoch_ns = getattr(_obs.tracer, "_epoch_ns", 0)
        except Exception:
            events, epoch_ns = [], 0
        pid = os.getpid()
        for rec in records:
            dur_us = float(rec.get("seconds", 0.0)) * 1e6
            end_us = (rec.get("t_ns", epoch_ns) - epoch_ns) / 1000.0
            args = {k: _finite(v) for k, v in rec.items()
                    if k not in ("t_ns", "tid", "seconds")}
            if rec.get("type") == "step":
                events.append({
                    "name": f"{rec.get('engine', '?')}.step",
                    "cat": "flight", "ph": "X",
                    "ts": end_us - dur_us, "dur": dur_us,
                    "pid": pid, "tid": rec.get("tid", 0), "args": args,
                })
            else:
                events.append({
                    "name": f"flight.{rec.get('type', 'event')}",
                    "cat": "flight", "ph": "i", "s": "t",
                    "ts": end_us, "pid": pid,
                    "tid": rec.get("tid", 0), "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def _write_allocator(self, path: str) -> None:
        """The caching allocator's counters and segments (a process that
        has not started CUDA writes nothing)."""
        torch = sys.modules.get("torch")
        try:
            if torch is None or not torch.cuda.is_initialized():
                return
            doc = {"memory_stats": torch.cuda.memory_stats(),
                   "memory_allocated": torch.cuda.memory_allocated(),
                   "memory_reserved": torch.cuda.memory_reserved()}
            snap = getattr(torch.cuda.memory, "_snapshot", None)
            if snap is not None:
                doc["snapshot"] = snap()
            with open(path, "w") as f:
                json.dump(doc, f, default=str)
        except Exception:
            pass

    # ------------------------------------------------------------- plumbing

    def status(self) -> Dict[str, Any]:
        """The `/api/flight` payload."""
        with self._lock:
            dumps = list(self._dumps)
            n = len(self._ring)
        return {
            "enabled": self.enabled,
            "capacity": self._ring.maxlen,
            "records": n,
            "dump_dir": self.dump_dir,
            "dumps": dumps,
            "recent": self.snapshot(limit=20),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_counts.clear()
            self._compiles_prev = None
            self._last_live_bytes = None


# The process-global recorder; `observability.flight` re-exports it.
recorder = FlightRecorder()


# ------------------------------------------------------------------ CLI


def _fmt_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m deeplearning4j_tpu_torch.observability.flight
    <bundle-dir>`: pretty-print a bundle (the port's or the
    reference's)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.observability.flight",
        description="Pretty-print a flight-recorder bundle directory")
    parser.add_argument("bundle", help="bundle directory (one dump)")
    parser.add_argument("--steps", type=int, default=12,
                        help="how many trailing step records to show")
    args = parser.parse_args(argv)

    mpath = os.path.join(args.bundle, "MANIFEST.json")
    if not os.path.isfile(mpath):
        print(f"not a flight bundle (no MANIFEST.json): {args.bundle}",
              file=sys.stderr)
        return 2
    with open(mpath) as f:
        manifest = json.load(f)
    print(f"flight bundle: {args.bundle}")
    print(f"  reason : {manifest.get('reason')}")
    print(f"  time   : {manifest.get('time')}  pid {manifest.get('pid')}")
    versions = manifest.get("versions", {})
    print("  runtime: " + ", ".join(
        f"{k}={v}" for k, v in versions.items() if k != "devices"))
    exc = manifest.get("exception")
    if exc:
        print(f"  crash  : {exc['type']}: {exc['message']}")
        tb = exc.get("traceback") or []
        for line in "".join(tb[-3:]).rstrip().splitlines():
            print(f"           {line}")

    spath = os.path.join(args.bundle, "steps.jsonl")
    if os.path.isfile(spath):
        with open(spath) as f:
            records = [json.loads(line) for line in f if line.strip()]
        steps = [r for r in records if r.get("type") == "step"]
        others = [r for r in records if r.get("type") != "step"]
        print(f"\n  {len(steps)} step records"
              f" ({len(others)} other events) — last {args.steps}:")
        print("    iter      loss   seconds  k  input_wait  live_mem")
        for r in steps[-args.steps:]:
            wait = r.get("input_wait")
            print("    {:>6} {:>9} {:>9.4f} {:>2} {:>11} {:>9}".format(
                r.get("iteration", "?"),
                str(r.get("loss"))[:9],
                float(r.get("seconds", 0.0)),
                r.get("k", 1),
                "-" if wait is None else f"{wait:.4f}",
                _fmt_bytes(r.get("live_buffer_bytes"))
                if r.get("live_buffer_bytes") is not None else "-"))
        for r in others[-5:]:
            desc = {k: v for k, v in r.items()
                    if k not in ("t_ns", "tid", "seq")}
            print(f"    event: {desc}")

    mpath = os.path.join(args.bundle, "metrics.json")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            metrics = json.load(f)
        interesting = [n for n in ("dl4j_train_iterations_total",
                                   "dl4j_xla_compiles_total",
                                   "dl4j_program_hbm_bytes",
                                   "dl4j_input_wait_seconds")
                       if n in metrics]
        print(f"\n  metrics.json: {len(metrics)} families"
              + (f" (incl. {', '.join(interesting)})" if interesting else ""))
    tpath = os.path.join(args.bundle, "trace.json")
    if os.path.isfile(tpath):
        with open(tpath) as f:
            trace = json.load(f)
        print(f"  trace.json: {len(trace.get('traceEvents', []))} events "
              "(open in ui.perfetto.dev)")
    apath = os.path.join(args.bundle, "allocator.json")
    if os.path.isfile(apath):
        with open(apath) as f:
            alloc = json.load(f)
        print(f"  allocator.json: {_fmt_bytes(alloc.get('memory_allocated'))}"
              f" allocated, {_fmt_bytes(alloc.get('memory_reserved'))} "
              "reserved")
    ppath = os.path.join(args.bundle, "memory.pprof")
    if os.path.isfile(ppath):
        print(f"  memory.pprof: {os.path.getsize(ppath)} bytes "
              "(pprof -http : memory.pprof)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
