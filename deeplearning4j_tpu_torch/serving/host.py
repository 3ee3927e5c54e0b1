"""Multi-model hosting under a memory budget, with LoRA adapters
(counterpart of `deeplearning4j_tpu/serving/host.py`).

One server hosts several models (`ModelHost`). A model's footprint
(`hbm_bytes`) is measured once the model has dispatched on the card
(`_measure_hbm`, reference :158-176): the bytes of its leaves on the card
plus the largest transient its warmup recorded (`observability/memory.py`
`measured_model_bytes`; `hbm_source` "measured"), kept through evictions,
so a reload of a measured model is measured again at once. Before that it
is an estimate (`hbm_source` "estimated"): the bytes of its params and
layer state once loaded, or the sizes in its checkpoint's COMMIT manifest
(a zip's size) before the first load. Every hosted net is registered for
`memory.live_buffer_report` under its model's name. When the resident
footprints sum past `hbm_budget_bytes`, the host
evicts the least recently used model that is not pinned: its batcher and
scheduler are detached under the lock and stopped off it, its merged
adapter trees are dropped with its net, and the card's memory is freed;
the entry stays registered, and the next request reloads it from its path
onto the server's device (`checkpoint.legacy.load_any`, retried on
`OSError` by `util/retry.py`), while other callers of that model get 503
`Retry-After` until the load is published. A model added as a live net
with no path is pinned: there is nothing to reload it from.

A model's `adapters` hold LoRA deltas (`nn/lora.py`) beside its one
resident base: each entry keeps the small delta tree and, built on first
use, the merged serving tree (the base's tensors shared, never copied), so
an adapter costs the card only its own leaves. Requests name an adapter
and run through its merged tree.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.nn import lora as lora_mod
from deeplearning4j_tpu_torch.observability import memory as _obsmem
from deeplearning4j_tpu_torch.serving import metrics as _m
from deeplearning4j_tpu_torch.serving.errors import (
    ModelNotFoundError,
    ModelNotReadyError,
)


def _nbytes(tree) -> int:
    return sum(int(t.numel() * t.element_size())
               for leaves in (tree or {}).values()
               for t in leaves.values() if hasattr(t, "element_size"))


def estimate_hbm_bytes(net) -> int:
    """The bytes of the engine's params and layer state (what stays on
    the card while the model serves)."""
    return (_nbytes(getattr(net, "params_tree", None))
            + _nbytes(getattr(net, "state", None)))


def estimate_checkpoint_bytes(path) -> int:
    """The footprint before a load: the COMMIT manifest's file sizes (a
    sharded step, or a manager root's newest committed step), or the zip's
    size; 0 when unreadable (the estimate firms up at the load)."""
    from deeplearning4j_tpu_torch.checkpoint import store
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager

    path = str(path)
    try:
        if os.path.isdir(path):
            if not store.is_sharded_checkpoint(path):
                path = CheckpointManager(path).latest_path()
                if path is None:
                    return 0
            commit = store.verify_checkpoint(path)
            return sum(int(s) for s in commit.get("files", {}).values())
        return int(os.path.getsize(path))
    except (OSError, ValueError, RuntimeError):
        return 0


def _measure_hbm(model: "ServedModel") -> None:
    """Register the model's net for live-buffer attribution, and firm its
    footprint up to measured device bytes when it has dispatched on the
    card (its leaves there plus the largest transient recorded for it, or
    for an earlier load of it); else keep the estimate."""
    net = model.net
    _obsmem.register_tree(model.name, net)
    transient = _obsmem.largest_transient(net)
    if transient is not None:
        model.transient_bytes = transient
    measured = _obsmem.measured_model_bytes(net, model.transient_bytes)
    if measured:
        model.hbm_bytes = int(measured)
        model.hbm_source = "measured"
    else:
        model.hbm_bytes = estimate_hbm_bytes(net)
        model.hbm_source = "estimated"


def model_dtype(net) -> str:
    """The serving dtype: "int8" when a param has a `__scale` companion,
    else the first floating param's dtype."""
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
    """One hosted model: its net (None while evicted), path, batcher and
    optional scheduler, status ("ready", "warming" or "failed" with the
    warmup's error), LRU stamp, footprint and adapter registry."""

    def __init__(self, name: str, net, path=None, pinned=False,
                 options: Optional[dict] = None):
        self.name = name
        self.net = net
        self.path = None if path is None else str(path)
        self.pinned = bool(pinned)
        self.options = dict(options or {})
        self.batcher = None
        self.scheduler = None
        self.status = "ready"
        self.error: Optional[BaseException] = None
        self.vocab = None
        self.loading = False  # a reload is in flight off the host lock
        self.last_used = time.monotonic()
        self.hbm_source = "estimated"
        self.hbm_bytes = estimate_hbm_bytes(net)
        # The largest transient measured for this model (None until it
        # dispatched on the card), kept through evictions.
        self.transient_bytes: Optional[int] = None
        self.dtype = model_dtype(net)
        # name -> {"tree": delta, "rank", "bytes", "pinned",
        #          "merged": the full serving tree or None (built lazily)}
        self.adapters: Dict[str, dict] = {}

    @property
    def resident(self) -> bool:
        return self.net is not None

    def touch(self) -> None:
        self.last_used = time.monotonic()

    # ----------------------------------------------------------- adapters

    def add_adapter(self, name: str, tree) -> dict:
        """Register one LoRA delta tree as `name` (adding a name again
        replaces its delta and drops its merged tree). An adapter stays
        registered through its base's evictions."""
        entry = {"tree": tree, "rank": lora_mod.adapter_rank(tree),
                 "bytes": lora_mod.adapter_nbytes(tree), "merged": None}
        self.adapters[name] = entry
        _m.ADAPTERS_RESIDENT.labels(model=self.name).set(len(self.adapters))
        return entry

    def adapter_params(self, name: str):
        """The full serving tree of adapter `name`: the base's params with
        the delta laid over them, built once and kept until an eviction
        (the merged tree shares the base's tensors)."""
        entry = self.adapters.get(name)
        if entry is None:
            raise KeyError(
                f"model {self.name!r} hosts no adapter {name!r}; loaded: "
                f"{sorted(self.adapters) or '(none)'}")
        if entry["merged"] is None:
            net = self.net
            if net is None:
                raise ModelNotReadyError(
                    f"model {self.name!r} is not resident; retry shortly")
            entry["merged"] = lora_mod.merge_adapter(net.params_tree,
                                                     entry["tree"])
        return entry["merged"]

    def adapter_trees(self) -> Dict[str, dict]:
        """`{name: merged tree}` of every adapter (what warmup drives)."""
        return {n: self.adapter_params(n) for n in sorted(self.adapters)}

    def adapter_rows(self) -> List[dict]:
        """`/v1/models` sub-rows, one per adapter."""
        return [{"name": n, "rank": int(e["rank"]), "bytes": int(e["bytes"]),
                 "pinned": True} for n, e in sorted(self.adapters.items())]

    def row(self) -> dict:
        status = (self.status if self.resident
                  else "loading" if self.loading else "evicted")
        row = {"name": self.name, "status": status,
               "lm": self.scheduler is not None,
               "device": (None if self.net is None
                          else str(getattr(self.net, "device", "cpu"))),
               "dtype": self.dtype, "path": self.path,
               "resident": self.resident, "pinned": self.pinned,
               "hbm_bytes": int(self.hbm_bytes),
               "hbm_source": self.hbm_source,
               "adapters": self.adapter_rows()}
        if self.batcher is not None:
            row["batch_buckets"] = list(self.batcher.buckets)
        s = self.scheduler
        if s is not None:
            row.update(kv_cache=s.kv, decode_slots=s.slots,
                       capacity=s.capacity, scheduler_mode=s.mode,
                       speculative=s._draft_stepper is not None)
        if self.error is not None:
            row["error"] = f"{type(self.error).__name__}: {self.error}"
        return row


class ModelHost:
    """The registry of hosted models and their admission point. Adding,
    reloading and evicting change it under one lock; `get` on a resident
    model only stamps its LRU time."""

    def __init__(self, hbm_budget_bytes: Optional[int] = None,
                 on_load: Optional[Callable[[ServedModel], None]] = None,
                 device=None):
        self.hbm_budget_bytes = hbm_budget_bytes
        self.on_load = on_load      # the server attaches the runtimes here
        self.device = device        # where a reload puts the net
        self._lock = threading.RLock()
        self._models: Dict[str, ServedModel] = {}
        _m.MODELS_RESIDENT.set_function(
            lambda: sum(1 for m in self._models.values() if m.resident))

    # ----------------------------------------------------------- registry

    def add(self, name: str, net, path=None, **options) -> ServedModel:
        """Host `net` under `name`, loaded by the caller from `path` (a
        model that can be evicted and reloaded) or live (pinned: nothing
        to reload it from); a model already hosted under the name is
        replaced and stopped. Returns the new entry after the budget is
        enforced."""
        model = ServedModel(name, net, path=path, pinned=path is None,
                            options=options)
        with self._lock:
            old = self._models.get(name)
            self._models[name] = model
            _measure_hbm(model)
            _m.MODEL_HBM_BYTES.labels(model=name).set(model.hbm_bytes)
            _m.MODEL_DTYPE.labels(model=name, dtype=model.dtype).set(1)
            if self.on_load is not None:
                self.on_load(model)
            stoppables = self._enforce_budget(keep=model)
        if old is not None:
            stoppables += [r for r in (old.batcher, old.scheduler)
                           if r is not None]
        self._stop_runtimes(stoppables)
        return model

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def models(self) -> List[ServedModel]:
        with self._lock:
            return list(self._models.values())

    def get(self, name: str) -> ServedModel:
        """The model a request goes to: stamps its LRU time, and reloads
        an evicted one (`_reload`)."""
        model = self._models.get(name)
        if model is None:
            raise ModelNotFoundError(f"no model named {name!r}; hosted: "
                                     f"{self.names() or '(none)'}")
        model.touch()
        if not model.resident:
            self._reload(model)
        return model

    # ----------------------------------------------------- budget, evict

    def _reload(self, model: ServedModel) -> None:
        """Reload an evicted model. The load runs off the host lock: other
        models serve meanwhile, and other callers of this one get
        ModelNotReadyError (503) until it is published."""
        from deeplearning4j_tpu_torch.checkpoint.legacy import load_any
        from deeplearning4j_tpu_torch.util.retry import with_retries

        with self._lock:
            if model.resident:
                return
            if model.loading:
                raise ModelNotReadyError(
                    f"model {model.name!r} is reloading; retry shortly")
            model.loading = True
        try:
            # A reload racing a publisher's rename can meet a moment of
            # ENOENT: retry instead of failing the model.
            net = with_retries(
                lambda: load_any(model.path, device=self.device),
                retry_on=(OSError,), describe=f"model reload {model.name}")
        except Exception:
            with self._lock:
                model.loading = False
            raise
        stoppables: List = []
        try:
            with self._lock:
                try:
                    model.net = net
                    _measure_hbm(model)
                    model.dtype = model_dtype(net)
                    _m.MODEL_HBM_BYTES.labels(model=model.name).set(
                        model.hbm_bytes)
                    _m.MODEL_DTYPE.labels(model=model.name,
                                          dtype=model.dtype).set(1)
                    if self.on_load is not None:
                        self.on_load(model)
                    stoppables = self._enforce_budget(keep=model)
                except Exception:
                    # Back to the evicted state, so the next get() loads
                    # again instead of answering 503 for ever.
                    stoppables.extend(self._evict(model))
                    raise
                finally:
                    model.loading = False
        finally:
            self._stop_runtimes(stoppables)

    def publish_footprint(self, model: ServedModel) -> None:
        """Publish a model's (re)measured footprint and enforce the budget
        with it."""
        with self._lock:
            _m.MODEL_HBM_BYTES.labels(model=model.name).set(model.hbm_bytes)
            stoppables = self._enforce_budget(keep=model)
        self._stop_runtimes(stoppables)

    def set_budget(self, hbm_budget_bytes: Optional[int]) -> None:
        """A new budget, enforced at once."""
        with self._lock:
            self.hbm_budget_bytes = hbm_budget_bytes
            stoppables = self._enforce_budget()
        self._stop_runtimes(stoppables)

    def _enforce_budget(self, keep: Optional[ServedModel] = None) -> List:
        """Evict the least recently used resident models that are not
        pinned until the footprints fit the budget; `keep` (the model just
        loaded) is never evicted, so a budget below one model still serves
        it. Returns the victims' detached runtimes, for the caller to stop
        off the lock."""
        stoppables: List = []
        if self.hbm_budget_bytes is None:
            return stoppables
        while True:
            victims = [m for m in self._models.values()
                       if m.resident and not m.pinned and m is not keep]
            if (sum(m.hbm_bytes for m in self._models.values()
                    if m.resident) <= self.hbm_budget_bytes or not victims):
                return stoppables
            stoppables.extend(
                self._evict(min(victims, key=lambda m: m.last_used)))

    def _evict(self, model: ServedModel) -> List:
        """Evict under the host lock, detaching the batcher and scheduler
        rather than stopping them (a stop joins their threads, which must
        not happen under the lock); the caller stops what this returns.
        The merged adapter trees go with the net (they hold its tensors);
        the deltas stay registered and merge again after a reload."""
        stoppables = [r for r in (model.batcher, model.scheduler)
                      if r is not None]
        model.batcher = model.scheduler = None
        for entry in model.adapters.values():
            entry["merged"] = None
        model.net = None
        _obsmem.unregister_tree(model.name)
        _m.MODEL_HBM_BYTES.labels(model=model.name).set(0)
        _m.EVICTIONS.labels(model=model.name).inc()
        model.hbm_source = "estimated"
        model.hbm_bytes = (estimate_checkpoint_bytes(model.path)
                           if model.path else 0)
        return stoppables

    @staticmethod
    def _stop_runtimes(stoppables: List) -> None:
        """Stop detached batchers and schedulers (the host lock released),
        emptying the caller's list, then collect: the evicted net's tensors
        leave the card before the caller goes on."""
        stopped = bool(stoppables)
        while stoppables:
            stoppables.pop().stop()
        if stopped:
            gc.collect()

    # ---------------------------------------------------------- introspect

    def snapshot(self) -> List[dict]:
        """`GET /v1/models`: one row per hosted model."""
        with self._lock:
            return [m.row() for m in self._models.values()]

    def stop(self) -> None:
        _m.MODELS_RESIDENT.set_function(None)
        with self._lock:
            runtimes = [r for m in self._models.values()
                        for r in (m.batcher, m.scheduler) if r is not None]
        self._stop_runtimes(runtimes)
