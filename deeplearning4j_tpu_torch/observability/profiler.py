"""StepProfiler: where did a step's milliseconds go? (counterpart of
`deeplearning4j_tpu/observability/profiler.py:41-466`).

It wraps a live engine (`MultiLayerNetwork` or `ComputationGraph`) and
splits the time of every dispatched batch:

- **build vs execute**: the first dispatch of a batch signature (the one
  that builds the kernel library, makes cuDNN's plans or captures a
  superstep's CUDA graph) is kept apart from the steady-state dispatches;
  the kernel library's nvcc seconds come through the compile hook
  (`observability.install_compile_hook`).
- **step latency**: on the card, two CUDA events recorded around each
  dispatch, read once, when the profiler settles (`stop`): the time from
  the step's first queued work to its last, with no host sync per step.
  On the CPU every op has finished when the dispatch returns, so it is
  the dispatch's wall time. `sync=False` records the dispatch's host time
  only, as in the reference. Observed into `dl4j_step_latency_seconds`.
- **host->device bytes**: the host-resident parts of every dispatched
  batch (`observability.host_nbytes`), plus what background stagers moved
  (`dl4j_staging_bytes_total`).
- **FLOPs and MFU**: `estimate_step_cost` counts one step's FLOPs with
  `torch.utils.flop_counter.FlopCounterMode`; divided by the median step
  and the card's peak (`chip_peak_flops`) it is `dl4j_train_mfu`. A card
  not in the table has no peak, and then no MFU, unless
  `DL4J_TPU_PEAK_FLOPS` gives one.
- **window_short** (`trace=True`, on the card): `torch.profiler` traces
  the window, and a trace that holds fewer of the port's kernels than the
  launch counters (`kernels.launches`) say the steps launched came back
  short; the profiler on the H100 has lost kernels from some windows, and
  such a window must not read as a fast step.

Usage::

    from deeplearning4j_tpu_torch.observability import StepProfiler

    with StepProfiler(net) as prof:
        net.fit(iterator)
    print(prof.summary())   # and scrape /metrics for the histograms
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional


def estimate_step_flops(net, ds) -> Optional[float]:
    """FLOPs of one training step of `net` on a batch shaped like `ds`
    (`estimate_step_cost`'s "flops"), or None."""
    return estimate_step_cost(net, ds).get("flops")


def estimate_step_cost(net, ds) -> Dict[str, Optional[float]]:
    """``{"flops": ..., "bytes": ...}`` of one training step.

    XLA's `cost_analysis` has no counterpart in PyTorch, so the FLOPs are
    counted by `torch.utils.flop_counter.FlopCounterMode` over one step of
    a twin of `net` whose params, state, updater state and batch are fake
    CPU tensors of the same shapes and dtypes (`FakeTensorMode`: no data,
    no compute). On the CPU the wrappers run their kernels' plain
    versions, which is what the counter sees: it does not see inside a
    hand-written kernel, and it counts the matrix products (matmuls,
    convolutions, attention), not elementwise work. The plain calls the
    count makes are taken back from `kernels.plain_calls`. `bytes` is None: the
    port has no counterpart of XLA's "bytes accessed" estimate until a
    benchmark defines one. Either value is None when the count fails."""
    out: Dict[str, Optional[float]] = {"flops": None, "bytes": None}
    try:
        flops = _count_step_flops(net, ds)
    except Exception:
        return out
    out["flops"] = float(flops) if flops > 0 else None
    return out


def _map_tree(fn, tree):
    import torch

    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _fake_like(t):
    """A tensor of `t`'s shape and dtype on the CPU (under FakeTensorMode:
    a fake one), a leaf that requires grad where `t` does."""
    import numpy as np
    import torch

    if isinstance(t, np.ndarray):
        dtype = torch.from_numpy(np.empty(0, t.dtype)).dtype
        return torch.zeros(t.shape, dtype=dtype, device="cpu")
    f = torch.zeros(tuple(t.shape), dtype=t.dtype, device="cpu")
    if t.requires_grad:
        f.requires_grad_(True)
    return f


def _count_step_flops(net, ds) -> float:
    from deeplearning4j_tpu_torch import kernels

    before = {n: c.value for n, c in kernels.plain_calls.items()}
    try:
        return _count_fake_step(net, ds)
    finally:
        for n, c in kernels.plain_calls.items():
            c.shift(before[n] - c.value)


def _count_fake_step(net, ds) -> float:
    import copy

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.datasets import iterators as _it
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet,
        MultiDataSet,
    )

    item = ds.batch(0) if isinstance(
        ds, (_it.Superbatch, _it.MultiSuperbatch)) else ds
    graph = type(net).__name__ == "ComputationGraph"
    with FakeTensorMode(allow_non_fake_inputs=True):
        twin = copy.copy(net)
        twin.device = torch.device("cpu")
        twin.params_tree = _map_tree(_fake_like, net.params_tree)
        twin.state = _map_tree(_fake_like, net.state)
        twin.opt_state = _map_tree(_fake_like, net.opt_state)
        twin._compute_params = None
        twin._update_tables = {}
        twin._step_ctx = None
        twin._score = None
        twin._rnn_state = {}
        twin.listeners = []
        twin._train_rng = net._train_rng.copy()

        def part(a):
            return None if a is None else _fake_like(a)

        if isinstance(item, MultiDataSet) or graph:
            feats = item.features if isinstance(
                item.features, (list, tuple)) else [item.features]
            labs = item.labels if isinstance(
                item.labels, (list, tuple)) else [item.labels]
            fm = getattr(item, "features_masks", None)
            lm = getattr(item, "labels_masks", None)
            if fm is None and getattr(item, "features_mask", None) is not None:
                fm = [item.features_mask]
            if lm is None and getattr(item, "labels_mask", None) is not None:
                lm = [item.labels_mask]
            fake = MultiDataSet(
                [part(f) for f in feats], [part(lab) for lab in labs],
                None if fm is None else [part(m) for m in fm],
                None if lm is None else [part(m) for m in lm])
        else:
            fake = DataSet(part(item.features), part(item.labels),
                           part(item.features_mask), part(item.labels_mask))
        with FlopCounterMode(display=False) as counter:
            twin._sgd_step(fake)
    return counter.get_total_flops()


# Dense bf16 tensor-core peaks (FLOP/s) and memory rates (B/s) of NVIDIA
# parts, keyed on `torch.cuda.get_device_name()`; the first key the name
# contains wins. The H100 SXM's are the figures PERF.md §6 bounds with.
_NVIDIA_PEAKS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),
    ("H100 PCIe", 756e12, 2.0e12),
    ("A100-SXM4-80GB", 312e12, 2.039e12),
    ("A100-SXM4-40GB", 312e12, 1.555e12),
)


def _card_peaks():
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for key, flops, bw in _NVIDIA_PEAKS:
        if key in name:
            return flops, bw
    return None


def chip_peak_flops() -> Optional[float]:
    """Peak dense bf16 FLOP/s of the local card (`DL4J_TPU_PEAK_FLOPS` /
    `BENCH_PEAK_FLOPS` override it). None on the CPU and for a card not in
    the table: MFU is then unavailable, not zero."""
    env = os.environ.get("DL4J_TPU_PEAK_FLOPS") or os.environ.get(
        "BENCH_PEAK_FLOPS")
    if env:
        return float(env)
    peaks = _card_peaks()
    return None if peaks is None else peaks[0]


def chip_peak_hbm_bw() -> Optional[float]:
    """Peak memory rate (bytes/s) of the local card
    (`DL4J_TPU_PEAK_HBM_BW` / `BENCH_PEAK_HBM_BW` override it). None on the
    CPU and for a card not in the table."""
    env = os.environ.get("DL4J_TPU_PEAK_HBM_BW") or os.environ.get(
        "BENCH_PEAK_HBM_BW")
    if env:
        return float(env)
    peaks = _card_peaks()
    return None if peaks is None else peaks[1]


def kernel_symbols() -> List[str]:
    """The names of the port's CUDA kernels (the `__global__` functions of
    `kernels/csrc/*.cu`)."""
    from deeplearning4j_tpu_torch.kernels import _build

    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(?:void\s+)?(\w+)\s*\(")
    return sorted({name for src in _build.sources()
                   for name in pat.findall(src.read_text())})


class StepProfiler:
    """See the module docstring. Patches the engine instance's
    `_fit_dispatch` (one call per dispatched batch on every path: plain,
    truncated BPTT, solver, superstep) and `output` for the `with` block,
    and restores them on exit."""

    def __init__(self, net, registry=None, tracer=None, sync: bool = True,
                 peak_flops: Optional[float] = None, trace: bool = False):
        from deeplearning4j_tpu_torch import observability as obs

        self.net = net
        self.registry = registry or obs.metrics
        self.tracer = tracer or obs.tracer
        self.sync = bool(sync)
        self.trace = bool(trace)
        self.peak_flops = peak_flops
        self.step_times: List[float] = []        # steady-state dispatches
        self.first_step_times: List[float] = []  # first of a signature
        self.infer_times: List[float] = []
        self.h2d_bytes = 0
        self.traced_kernels: Optional[int] = None
        self.counted_launches: Optional[int] = None
        self.flops: Optional[float] = None
        self.mfu: Optional[float] = None
        self._last_ds = None
        self._patched = False
        self._pending: list = []
        self._seen: set = set()
        self._prof = None
        reg = self.registry
        self._m_latency = reg.histogram(
            "dl4j_step_latency_seconds",
            "Settled train-step latency measured under StepProfiler "
            "(first compile-inclusive call excluded)")
        self._m_first = reg.histogram(
            "dl4j_step_first_call_seconds",
            "First (compile-inclusive) dispatch of each jitted program "
            "under StepProfiler", buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30,
                                           60, 120, 300))
        self._m_infer = reg.histogram(
            "dl4j_infer_latency_seconds",
            "Settled output() latency measured under StepProfiler")
        self._m_compile = reg.gauge(
            "dl4j_profiler_compile_seconds",
            "XLA compile seconds attributed to the profiled window")
        self._m_execute = reg.gauge(
            "dl4j_profiler_execute_seconds_median",
            "Median steady-state step seconds in the profiled window")
        self._m_flops = reg.gauge(
            "dl4j_train_flops_per_step",
            "XLA cost-analysis FLOPs of one jitted train step")
        self._m_mfu = reg.gauge(
            "dl4j_train_mfu",
            "Model FLOPs utilization: flops/step / step_time / chip peak "
            "(absent without a known peak — see PERF.md CPU caveats)")

    # ------------------------------------------------------------ patching

    @property
    def _on_card(self) -> bool:
        return self.net.device.type == "cuda"

    def __enter__(self) -> "StepProfiler":
        import torch

        from deeplearning4j_tpu_torch import kernels
        from deeplearning4j_tpu_torch import observability as obs
        from deeplearning4j_tpu_torch.nn.engine import (
            batch_host_nbytes,
            dispatch_signature,
        )
        from deeplearning4j_tpu_torch.observability import memory as _mem

        obs.install_compile_hook(self.registry)
        _mem.register_tree(type(self.net).__name__, self.net)
        self._compile_s0 = self._compile_seconds()
        self._cache_counts0 = self._cache_counts()
        self._input_wait0 = self._input_wait_totals()
        self._staging0 = self._staging_totals()
        self._orig_dispatch = self.net._fit_dispatch
        self._orig_output = self.net.output
        net = self.net
        if self.trace and self._on_card:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(net.device)
            self._launches0 = sum(kernels.counts()["launches"].values())
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()

        def dispatch(item, *a, **kw):
            self._last_ds = item
            self.h2d_bytes += batch_host_nbytes(item, net.device)
            sig = dispatch_signature(item)
            first = sig not in self._seen
            self._seen.add(sig)
            # No span here: the engine's iteration span already covers the
            # dispatch, and a wrapper would take its parentage.
            if self.sync and self._on_card:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = self._orig_dispatch(item, *a, **kw)
                e1.record()
                self._pending.append((first, e0, e1))
                return out
            t0 = time.perf_counter()
            out = self._orig_dispatch(item, *a, **kw)
            self._observe(first, time.perf_counter() - t0)
            return out

        def output(*a, **kw):
            t0 = time.perf_counter()
            result = self._orig_output(*a, **kw)
            dt = time.perf_counter() - t0
            self.infer_times.append(dt)
            self._m_infer.observe(dt)
            return result

        self.net._fit_dispatch = dispatch
        self.net.output = output
        self._patched = True
        return self

    def _observe(self, first: bool, dt: float) -> None:
        if first:
            self.first_step_times.append(dt)
            self._m_first.observe(dt)
        else:
            self.step_times.append(dt)
            self._m_latency.observe(dt)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def stop(self) -> None:
        """Restore the engine, settle the recorded events (one
        synchronize), close the trace, and set the summary gauges."""
        if self._patched:
            self.net._fit_dispatch = self._orig_dispatch
            self.net.output = self._orig_output
            # A bound method of the class put back on the instance: drop
            # it, so the class's own shows again.
            for name in ("_fit_dispatch", "output"):
                got = self.net.__dict__.get(name)
                if getattr(got, "__func__", None) is getattr(
                        type(self.net), name, None):
                    del self.net.__dict__[name]
            self._patched = False
        self._settle()
        self._finalize()

    def _settle(self) -> None:
        if not (self._pending or self._prof is not None):
            return
        import torch

        from deeplearning4j_tpu_torch import kernels

        torch.cuda.synchronize(self.net.device)
        for first, e0, e1 in self._pending:
            self._observe(first, e0.elapsed_time(e1) / 1e3)
        self._pending = []
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            syms = kernel_symbols()
            pats = [re.compile(r"\b" + s + r"\b") for s in syms]
            cuda = torch.autograd.DeviceType.CUDA
            self.traced_kernels = sum(
                1 for e in prof.events() if e.device_type == cuda
                and any(p.search(e.name) for p in pats))
            self.counted_launches = (
                sum(kernels.counts()["launches"].values()) - self._launches0)

    # ----------------------------------------------------------- reporting

    def _compile_seconds(self) -> float:
        fam = self.registry.get_family("dl4j_xla_compile_seconds_total")
        if fam is None:
            return 0.0
        return sum(c.get() for c in fam.children())

    def compile_seconds(self) -> float:
        """Kernel-library build seconds inside the profiled window."""
        return max(0.0, self._compile_seconds() - self._compile_s0)

    def _cache_counts(self) -> Dict[str, float]:
        counts: Dict[str, float] = {}
        for kind, name in (("hits", "dl4j_compile_cache_hits_total"),
                           ("misses", "dl4j_compile_cache_misses_total")):
            fam = self.registry.get_family(name)
            if fam is None:
                continue
            for child in fam.children():
                source = child.labels.get("source", "_")
                counts[f"{kind}_{source}"] = child.get()
        for kind, name in (("hits", "dl4j_jit_cache_hits_total"),
                           ("misses", "dl4j_jit_cache_misses_total")):
            fam = self.registry.get_family(name)
            if fam is None:
                continue
            for child in fam.children():
                engine = child.labels.get("engine", "_")
                counts[f"{kind}_capture_{engine}"] = child.get()
        return counts

    def compile_cache_deltas(self) -> Dict[str, float]:
        """Build-cache and capture hit / miss counts inside the window,
        e.g. {'hits_persistent': 1, 'misses_capture_graph': 1}."""
        base = getattr(self, "_cache_counts0", {})
        out: Dict[str, float] = {}
        for key, val in self._cache_counts().items():
            delta = val - base.get(key, 0.0)
            if delta > 0:
                out[key] = delta
        return out

    def _input_wait_totals(self) -> tuple:
        fam = self.registry.get_family("dl4j_input_wait_seconds")
        if fam is None:
            return (0.0, 0)
        s_total, c_total = 0.0, 0
        for child in fam.children():
            _, _, s, c = child.histogram_state()
            s_total += s
            c_total += c
        return (s_total, c_total)

    def input_wait(self) -> tuple:
        """(seconds, observations) the host spent blocked in iterator-next
        inside the window: starvation shows here, not in step latency."""
        s0, c0 = getattr(self, "_input_wait0", (0.0, 0))
        s, c = self._input_wait_totals()
        return (max(0.0, s - s0), max(0, c - c0))

    def _staging_totals(self) -> Dict[str, float]:
        """Totals of the staging counters: bytes the stagers moved, and
        copy-issue seconds by overlapped (stager thread) or synchronous
        (caller thread)."""
        out = {"overlapped_bytes": 0.0, "overlapped_put_seconds": 0.0,
               "synchronous_put_seconds": 0.0, "staging_wait_seconds": 0.0}
        fam = self.registry.get_family("dl4j_staging_bytes_total")
        if fam is not None:
            out["overlapped_bytes"] = sum(c.get() for c in fam.children())
        fam = self.registry.get_family("dl4j_staging_put_seconds_total")
        if fam is not None:
            for child in fam.children():
                mode = child.labels.get("mode", "synchronous")
                out[f"{mode}_put_seconds"] = (
                    out.get(f"{mode}_put_seconds", 0.0) + child.get())
        fam = self.registry.get_family("dl4j_staging_wait_seconds")
        if fam is not None:
            for child in fam.children():
                _, _, s, _ = child.histogram_state()
                out["staging_wait_seconds"] += s
        return out

    def staging_deltas(self) -> Dict[str, float]:
        """Overlapped-transfer activity inside the window (the keys of
        `_staging_totals`); all zeros when no DeviceStager ran."""
        base = getattr(self, "_staging0", {})
        return {key: max(0.0, val - base.get(key, 0.0))
                for key, val in self._staging_totals().items()}

    def execute_seconds_median(self) -> Optional[float]:
        if not self.step_times:
            return None
        return sorted(self.step_times)[len(self.step_times) // 2]

    def _finalize(self) -> None:
        compile_s = self.compile_seconds()
        if not compile_s and self.first_step_times and self.step_times:
            # Nothing built in the window: the first dispatches less the
            # steady state (an estimate, as in the reference).
            med = self.execute_seconds_median() or 0.0
            compile_s = max(0.0, sum(self.first_step_times)
                            - med * len(self.first_step_times))
        self._m_compile.set(compile_s)
        med = self.execute_seconds_median()
        if med is not None:
            self._m_execute.set(med)
        if self._last_ds is not None:
            self.flops = estimate_step_flops(self.net, self._last_ds)
        if self.flops:
            self._m_flops.set(self.flops)
            peak = self.peak_flops or chip_peak_flops()
            if peak and med:
                self.mfu = self.flops / med / peak
                self._m_mfu.set(self.mfu)

    def window_short(self) -> Optional[bool]:
        """True when the traced window holds fewer of the port's kernels
        than the launch counters say the window launched (None when the
        window was not traced)."""
        if self.traced_kernels is None:
            return None
        return self.traced_kernels < self.counted_launches

    def summary(self) -> Dict[str, Any]:
        med = self.execute_seconds_median()
        staging = self.staging_deltas()
        out: Dict[str, Any] = {
            "steps": len(self.step_times) + len(self.first_step_times),
            "first_call_steps": len(self.first_step_times),
            "compile_seconds": self.compile_seconds() or self._m_compile.get(),
            "execute_seconds_median": med,
            # Dispatch-side host bytes plus what background stagers moved
            # (a staged batch reaches dispatch already on the device).
            "host_to_device_bytes": (self.h2d_bytes
                                     + int(staging["overlapped_bytes"])),
            "window_short": self.window_short(),
        }
        if self.traced_kernels is not None:
            out["traced_kernels"] = self.traced_kernels
            out["counted_launches"] = self.counted_launches
        if any(staging.values()):
            out["transfer"] = {
                "overlapped_bytes": int(staging["overlapped_bytes"]),
                "synchronous_bytes": self.h2d_bytes,
                "overlapped_put_seconds": staging["overlapped_put_seconds"],
                "synchronous_put_seconds": staging["synchronous_put_seconds"],
                "staging_wait_seconds": staging["staging_wait_seconds"],
            }
        cache = self.compile_cache_deltas()
        if cache:
            out["compile_cache"] = cache
        wait_s, wait_n = self.input_wait()
        if wait_n:
            out["input_wait"] = {"seconds": wait_s, "observations": wait_n,
                                 "mean": wait_s / wait_n}
        if self.step_times:
            s = sorted(self.step_times)
            out["step_latency"] = {
                "mean": sum(s) / len(s), "p50": s[len(s) // 2],
                "min": s[0], "max": s[-1],
                "sync": self.sync,
            }
        if self.infer_times:
            s = sorted(self.infer_times)
            out["infer_latency"] = {"mean": sum(s) / len(s),
                                    "p50": s[len(s) // 2], "count": len(s)}
        if self.flops:
            out["flops_per_step"] = self.flops
            if med:
                out["flops_per_sec"] = self.flops / med
        if self.mfu:
            out["mfu"] = self.mfu
        return out

