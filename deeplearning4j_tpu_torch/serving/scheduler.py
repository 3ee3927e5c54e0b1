"""Continuous-batching generation scheduler (counterpart of
`deeplearning4j_tpu/serving/scheduler.py`).

The scheduler owns a decode stepper (`models.zoo.DecodeStepper` or
`PagedDecodeStepper`): a fixed bank of slots whose sequences sit at
different depths. New sequences are admitted at STEP BOUNDARIES, so a
request waits for the next decode step plus its own prefill, and a slot is
recycled the moment its sequence hits EOS or its token budget.
`mode="drain"` admits only when every slot is free (the control arm).

Per-request sampling replays `generate_lm`'s draws (one
`np.random.RandomState(seed)` per request, `_sample_token` per token), so
a continuously batched generation equals the single-sequence path.

With a `draft` model (a second, dense stepper in lockstep), each decode
round is speculative (`_spec_round`): the draft proposes `spec_k` tokens,
the target verifies them in one `step_k` forward, greedy requests keep
the agreeing prefix plus one, and both steppers rewind. On the card the
verify's attention is the paged kernel with `spec_k + 1` query rows, so
`spec_k + 1` may not pass its limit of 8.

`warmup()` runs every prompt bucket, the decode step and every verify
width once before traffic, and leaves slot 0, the pool and the prefix
cache as it found them.

LoRA adapters (`serving/host.py`): a request may name an adapter, whose
merged params tree it carries from admission (an unknown name is a 400
there). Its prefill runs through that tree, and its prefix-cache entries
are kept under the adapter's name, so the same prompt under two adapters
never shares pages. A decode round whose slots all share one adapter is
one dispatch; a mixed round dispatches once per adapter group over the
whole slot bank, then rewinds: slots whose group has run stay one token
on, slots still waiting go back to their length, so each slot's KV row
and distribution come from its own group's dispatch (reference
`_decode_round`). A model with a draft refuses adapters, as the
reference's does.

Threads: the decode loop runs on its own thread and is the only thread
that touches device tensors once traffic flows; callers hand it host-side
requests through a bounded queue and wait on an event. The group abort
of sharded replicas comes with ROADMAP A.13.

Observability (reference :92, 384-646): a request carries its caller's
trace context and its ledger record (`NOOP_RECORD` for a direct caller).
A prefill runs in a `serving.prefill` span under the request's context;
an admission and every round a request rides get `serving.admission_wait`
and `serving.decode_step` spans. A prefill's wall time is the request's
own (`dl4j_serving_dispatch_seconds_total{phase="prefill"}`); a round's
(every adapter group's dispatch of a mixed round, or a speculative
round's draft steps and verify) adds to `{phase="decode"}` and splits
evenly across the round's active slots, since every slot rides every
dispatch of the round. The record gets its marks (admitted, prefill or
prefix hit, first token), tokens out, speculative accepts and rejects,
and its slot's copy-on-write page copies at retirement. A dying loop
leaves a flight bundle (`flight.on_crash`) and fails its callers.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.kernels import flash_attention as _fa
from deeplearning4j_tpu_torch.models.kv_pool import PrefixCache
from deeplearning4j_tpu_torch.models.zoo import (
    DecodeStepper,
    PagedDecodeStepper,
    _sample_token,
)
from deeplearning4j_tpu_torch.observability import propagate as _prop
from deeplearning4j_tpu_torch.observability.ledger import NOOP_RECORD
from deeplearning4j_tpu_torch.serving import metrics as _m
from deeplearning4j_tpu_torch.serving.errors import (
    InputValidationError,
    RequestTimeoutError,
    ServerOverloadedError,
)


def prompt_bucket_ladder(capacity: int,
                         buckets: Optional[Sequence[int]] = None):
    """Prompt pad ladder: powers of two from 8 up to the decode cache
    capacity (explicit `buckets` override, capped at capacity)."""
    if buckets:
        ladder = sorted({int(b) for b in buckets if 0 < int(b) <= capacity})
        if not ladder:
            raise ValueError(
                f"prompt_buckets must contain a size in [1, {capacity}]")
        if ladder[-1] < capacity:
            ladder.append(capacity)
        return tuple(ladder)
    out, b = [], 8
    while b < capacity:
        out.append(b)
        b *= 2
    out.append(int(capacity))
    return tuple(out)


class GenerationRequest:
    __slots__ = ("prompt", "n_steps", "temperature", "top_k", "top_p",
                 "seed", "eos_id", "ids", "error", "deadline", "cancelled",
                 "event", "t_submit", "rng", "adapter", "params",
                 "_last_tok_ns", "ctx", "t_submit_ns", "ledger_rec")

    def __init__(self, prompt, n_steps, *, temperature=1.0, top_k=0,
                 top_p=0.0, seed=0, eos_id=None, deadline=None,
                 adapter=None, ledger_rec=None):
        self.prompt = [int(t) for t in prompt]
        self.n_steps = int(n_steps)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.ids: List[int] = list(self.prompt)
        self.error: Optional[str] = None
        self.deadline = deadline
        self.cancelled = False
        self.event = threading.Event()
        self.t_submit = time.monotonic()
        self.rng = np.random.RandomState(self.seed)
        # The LoRA adapter this request decodes through, and its merged
        # params tree (resolved at admission; None: the base).
        self.adapter = None if adapter is None else str(adapter)
        self.params = None
        self._last_tok_ns: Optional[int] = None  # inter-token anchor
        # The trace context rides the request into the loop's thread; the
        # ledger record is the server's (it opens and closes it).
        self.ctx = _prop.current()
        self.t_submit_ns = time.perf_counter_ns()
        self.ledger_rec = NOOP_RECORD if ledger_rec is None else ledger_rec

    @property
    def done(self) -> bool:
        gen = len(self.ids) - len(self.prompt)
        if gen >= self.n_steps:
            return True
        return (self.eos_id is not None and gen > 0
                and self.ids[-1] == self.eos_id)


class GenerationScheduler:
    """One LM's continuous-batching decode loop (see module docstring).

    `stats` counts what the loop did: target prefills, prefix hits, decode
    rounds of the target (a step or a verify) and their wall seconds, the
    target's decode dispatches (one a round, one per adapter group in a
    mixed round), tokens sampled from them, the draft's prefills and
    steps, and the speculative tokens accepted and rejected. `ttft_s`
    keeps recent time-to-first-token samples. The decode thread alone
    writes both."""

    def __init__(self, cg, model_name: str = "default", slots: int = 4,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 queue_depth: int = 64, mode: str = "continuous",
                 kv: str = "dense", page_size: int = 64,
                 kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 draft=None, spec_k: int = 4):
        if mode not in ("continuous", "drain"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        if kv not in ("dense", "paged"):
            raise ValueError(f"unknown kv cache layout {kv!r}; "
                             "want 'dense' or 'paged'")
        if kv == "dense" and prefix_cache:
            raise ValueError(
                "prefix_cache requires kv='paged' (a hit installs pool "
                "pages by reference; the dense stepper has none to share)")
        self.model_name = model_name
        self.mode = mode
        self.kv = kv
        self._spec_k = int(spec_k)
        if draft is not None:
            if self._spec_k < 1:
                raise ValueError("spec_k must be >= 1 with a draft model")
            if kv == "paged" and self._spec_k + 1 > _fa._MAX_QUERIES:
                raise ValueError(
                    f"spec_k={self._spec_k}: a verify feeds spec_k + 1 "
                    f"tokens, and the paged decode kernel takes at most "
                    f"{_fa._MAX_QUERIES} query rows")
        if kv == "paged":
            self.stepper = PagedDecodeStepper(cg, slots, page_size=page_size,
                                              pages=kv_pages)
        else:
            self.stepper = DecodeStepper(cg, slots)
        self.slots = self.stepper.slots
        self.capacity = self.stepper.capacity
        # The draft stepper advances in lockstep with the target, so the
        # capacity is the smaller of the two caches.
        self._draft_stepper = None
        if draft is not None:
            self._draft_stepper = DecodeStepper(draft, self.slots)
            self.capacity = min(self.capacity, self._draft_stepper.capacity)
        self.prefix_cache = None
        if kv == "paged" and (prefix_cache is None or prefix_cache):
            self.prefix_cache = PrefixCache(self.stepper.pool)
            self.stepper.pool.reclaim = self.prefix_cache.evict_one
        self.prompt_buckets = prompt_bucket_ladder(self.capacity,
                                                   prompt_buckets)
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = \
            queue.Queue(maxsize=int(queue_depth))
        self._thread: Optional[threading.Thread] = None
        # Adapter hooks (set by the server): name -> merged params tree,
        # and the names loaded (warmup drives the first).
        self.adapter_params = None
        self.adapter_names = None
        self.stats = {"prefills": 0, "prefix_hits": 0, "decode_steps": 0,
                      "decode_dispatches": 0,
                      "decode_seconds": 0.0, "decode_tokens": 0,
                      "draft_prefills": 0, "draft_steps": 0,
                      "spec_accepted": 0, "spec_rejected": 0}
        self.ttft_s: "collections.deque[float]" = collections.deque(
            maxlen=1024)
        _m.MODEL_QUEUE_DEPTH.labels(
            model=model_name, route="generate").set_function(
                self._queue.qsize)
        self._itl_hist = _m.ITL_SECONDS.labels(model=model_name)
        self._step_hist = _m.DECODE_STEP_SECONDS.labels(model=model_name)
        self._busy = _m.DECODE_SLOTS_BUSY.labels(model=model_name)
        self._tokens = _m.GENERATED_TOKENS.labels(model=model_name)
        self._ttft = _m.TTFT_SECONDS.labels(model=model_name)
        self._spec = {o: _m.SPECULATIVE_TOKENS.labels(model=model_name,
                                                      outcome=o)
                      for o in ("accepted", "rejected")}
        self._disp_prefill = _m.DISPATCH_SECONDS.labels(model=model_name,
                                                        phase="prefill")
        self._disp_decode = _m.DISPATCH_SECONDS.labels(model=model_name,
                                                       phase="decode")
        if kv == "paged":
            pool = self.stepper.pool
            for st in ("free", "used", "shared"):
                _m.KV_PAGES.labels(model=model_name, state=st).set_function(
                    lambda s=st, p=pool: p.counts()[s])

    # ------------------------------------------------------------ control

    def start(self) -> "GenerationScheduler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"dl4j-decode-{self.model_name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is not None:
            self._thread = None
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=10.0)

    def qsize(self) -> int:
        return self._queue.qsize()

    # ------------------------------------------------------------- warmup

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every prompt bucket's prefill, the decode step, the page
        copy and, with a draft, every verify width (k shrinks from spec_k
        to 0 near capacity) and the draft's own prefills and step, before
        traffic: on the card the first launch of each shape builds its
        setup. With adapters loaded, every prompt bucket and the step run
        again through the first adapter's merged tree (every adapter's
        tree has the same shapes). Slot 0 is cleared, every cursor rewound
        to 0, and the pool's free list restored to its order, so a request
        after warmup runs as on a server never warmed (the pool raises if
        a page leaked). The prefix cache is not touched."""
        pool = getattr(self.stepper, "pool", None)
        with (contextlib.nullcontext() if pool is None
              else pool.free_list_kept()):
            for b in self.prompt_buckets:
                _, slot_state, n = self.stepper.prefill([0], pad_to=b)
            self.stepper.install(0, slot_state, n)
            self.stepper.step([0] * self.slots)
            self.stepper.warm_page_copies()
            idle = [0] * self.slots
            if self._draft_stepper is not None:
                for t in range(2, self._spec_k + 2):
                    self.stepper.rewind_all([n] + idle[1:])
                    self.stepper.step_k(np.zeros((self.slots, t), np.int64))
                for b in self.prompt_buckets:
                    _, dstate, dn = self._draft_stepper.prefill([0],
                                                                pad_to=b)
                self._draft_stepper.install(0, dstate, dn)
                self._draft_stepper.step([0] * self.slots)
                self._draft_stepper.rewind_all(idle)
                self._draft_stepper.clear(0)
            self.stepper.rewind_all(idle)
            self.stepper.clear(0)
            names = (self.adapter_names() if callable(self.adapter_names)
                     else ())
            if names and self.adapter_params is not None:
                self.stepper.set_params(self.adapter_params(names[0]))
                try:
                    for b in self.prompt_buckets:
                        _, astate, an = self.stepper.prefill([0], pad_to=b)
                    self.stepper.install(0, astate, an)
                    self.stepper.step([0] * self.slots)
                finally:
                    self.stepper.set_params(None)
                self.stepper.rewind_all(idle)
                self.stepper.clear(0)

    # ---------------------------------------------------------- admission

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        if not req.prompt:
            raise InputValidationError("prompt_ids must be non-empty")
        if req.n_steps < 1:
            raise InputValidationError("n_steps must be >= 1")
        if len(req.prompt) + req.n_steps > self.capacity:
            raise InputValidationError(
                f"prompt ({len(req.prompt)}) + n_steps ({req.n_steps}) "
                f"exceeds the decode cache capacity {self.capacity}")
        if req.adapter is not None:
            if self._draft_stepper is not None:
                raise InputValidationError(
                    "adapter selection is not supported with a draft "
                    "(speculative) model configured — the draft has no "
                    "per-tenant delta to propose with")
            if self.adapter_params is None:
                raise InputValidationError(
                    f"model {self.model_name!r} hosts no adapters "
                    f"(requested {req.adapter!r})")
            try:
                # Resolved here, so an unknown name is a 400 and the loop
                # only ever sees a merged tree.
                req.params = self.adapter_params(req.adapter)
            except KeyError as e:
                raise InputValidationError(str(e.args[0]) if e.args
                                           else str(e))
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise ServerOverloadedError(
                f"model {self.model_name!r} generation queue is full "
                f"({self._queue.maxsize} requests); retry later")
        return req

    def generate(self, prompt_ids, n_steps: int, *,
                 timeout_s: Optional[float] = None, adapter=None,
                 ledger_rec=None, **sampling) -> List[int]:
        """Blocking helper: submit + wait; cancels the request (recycled at
        the next step boundary) when the caller's timeout expires."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        req = GenerationRequest(prompt_ids, n_steps, deadline=deadline,
                                adapter=adapter, ledger_rec=ledger_rec,
                                **sampling)
        self.submit(req)
        req.event.wait(timeout=timeout_s)
        if not req.event.is_set():
            req.cancelled = True
            raise TimeoutError(
                f"generation timed out after {timeout_s}s; the slot is "
                "recycled at the next step boundary")
        if req.error == "__deadline__":
            raise RequestTimeoutError(
                "generation deadline expired before completion")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.ids

    # --------------------------------------------------------------- loop

    def _sample(self, req: GenerationRequest, probs) -> int:
        tok = _sample_token(probs, req.rng, req.temperature, req.top_k,
                            req.top_p)
        req.ids.append(tok)
        # The first token anchors the inter-token clock (TTFT covers it).
        now_ns = time.perf_counter_ns()
        if req._last_tok_ns is not None:
            self._itl_hist.observe((now_ns - req._last_tok_ns) / 1e9)
        req._last_tok_ns = now_ns
        req.ledger_rec.add_tokens_out(1)
        self._tokens.inc()
        return tok

    def _finish_timeout(self, req: GenerationRequest) -> None:
        _m.REQUESTS.labels(model=self.model_name, route="generate",
                           outcome="timeout").inc()
        if not req.cancelled:
            req.error = "__deadline__"
        req.event.set()

    def _install_prompt(self, slot: int, req: GenerationRequest,
                        pad_to: int):
        """Get `slot` holding the prompt's KV; return the first-token
        distribution. A prefix-cache hit points the slot at resident pages
        and replays the stored distribution (no target forward); a miss
        prefills, installs and admits the fresh pages. Entries are kept
        under the request's adapter. The draft always prefills (its dense
        cache has no pages to share)."""
        cache = self.prefix_cache
        hit = (cache.get(req.prompt, namespace=req.adapter)
               if cache is not None else None)
        if hit is not None:
            pages, n, probs = hit
            self.stepper.install_shared(slot, pages, n)
            self.stats["prefix_hits"] += 1
            _m.PREFIX_CACHE_HITS.labels(model=self.model_name).inc()
            req.ledger_rec.set_prefix_hit(True)
            req.ledger_rec.mark("prefix_hit")
        else:
            # parent_ctx is explicit: the loop's thread has no enclosing
            # span to inherit from.
            t_pf = time.perf_counter_ns()
            with _obs.tracer.span("serving.prefill", cat="serving",
                                  parent_ctx=req.ctx,
                                  model=self.model_name, pad_to=pad_to):
                self.stepper.set_params(req.params)
                probs, slot_state, n = self.stepper.prefill(req.prompt,
                                                            pad_to=pad_to)
                self.stepper.install(slot, slot_state, n)
            # One request's dispatch: its wall time is all its own.
            prefill_s = (time.perf_counter_ns() - t_pf) / 1e9
            self._disp_prefill.inc(prefill_s)
            req.ledger_rec.add_device_seconds(prefill_s)
            req.ledger_rec.mark("prefill")
            self.stats["prefills"] += 1
            if cache is not None:
                _m.PREFIX_CACHE_MISSES.labels(model=self.model_name).inc()
                req.ledger_rec.set_prefix_hit(False)
                cache.admit(req.prompt, self.stepper.pool.pages_of(slot), n,
                            probs, namespace=req.adapter)
        if self._draft_stepper is not None:
            _, dstate, dn = self._draft_stepper.prefill(req.prompt,
                                                        pad_to=pad_to)
            self._draft_stepper.install(slot, dstate, dn)
            self.stats["draft_prefills"] += 1
        return probs

    def _admit(self, slot: int, req: GenerationRequest) -> bool:
        """Prefill + install + first token. True when the request stays
        active in `slot`."""
        pad_to = next(b for b in self.prompt_buckets
                      if len(req.prompt) <= b)
        if req.ctx is not None:
            # The admission wait, submit -> this step boundary.
            _obs.tracer.complete(
                "serving.admission_wait", req.t_submit_ns,
                time.perf_counter_ns() - req.t_submit_ns, cat="serving",
                parent_ctx=req.ctx, model=self.model_name)
        req.ledger_rec.set_queue_wait(
            (time.perf_counter_ns() - req.t_submit_ns) / 1e9)
        req.ledger_rec.mark("admitted")
        try:
            probs = self._install_prompt(slot, req, pad_to)
        except Exception as e:  # fail this request, keep the loop alive
            req.error = f"{type(e).__name__}: {e}"
            req.event.set()
            return False
        ttft = time.monotonic() - req.t_submit
        self._ttft.observe(ttft)
        self.ttft_s.append(ttft)
        self._sample(req, probs)
        req.ledger_rec.mark("first_token")
        if req.done:
            self._clear_slot(slot)
            req.event.set()
            return False
        return True

    def _clear_slot(self, slot: int) -> None:
        self.stepper.clear(slot)
        if self._draft_stepper is not None:
            self._draft_stepper.clear(slot)

    def _retire(self, slot: int, req: GenerationRequest,
                timed_out: bool = False) -> None:
        if self.kv == "paged":
            req.ledger_rec.add_cow_copies(self.stepper.pool.cow_count(slot))
        self._clear_slot(slot)
        if timed_out:
            self._finish_timeout(req)
        else:
            req.event.set()

    def _loop(self) -> None:
        active: Dict[int, GenerationRequest] = {}
        try:
            # inference_mode is per thread: the loop's forwards run under it.
            with torch.inference_mode():
                self._loop_inner(active)
        except Exception as e:
            # Decode-loop death strands every active sequence: a flight
            # bundle, the callers failed, then the thread dies with the
            # traceback.
            _obs.flight.on_crash("serving.decode_loop", e)
            for req in active.values():
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            raise

    def _loop_inner(self, active: Dict[int, GenerationRequest]) -> None:
        free = list(reversed(range(self.slots)))
        while True:
            # Admission happens only here, at a step boundary: continuous
            # mode refills any free slot, drain mode only an empty bank.
            admitting = self.mode == "continuous" or not active
            while admitting and free:
                try:
                    req = self._queue.get(timeout=None if not active
                                          else 0.0)
                except queue.Empty:
                    break
                if req is None:
                    self._shutdown(active)
                    return
                if req.cancelled or (req.deadline is not None
                                     and time.monotonic() > req.deadline):
                    self._finish_timeout(req)
                    continue
                slot = free.pop()
                if self._admit(slot, req):
                    active[slot] = req
                else:
                    free.append(slot)
            self._busy.set(len(active))
            if not active:
                continue
            if self._draft_stepper is not None:
                self._spec_round(active, free)
                continue
            t0_ns = time.perf_counter_ns()
            probs = self._decode_round(active)
            self._stepped(t0_ns, active)
            now = time.monotonic()
            for slot, req in list(active.items()):
                if req.cancelled or (req.deadline is not None
                                     and now > req.deadline):
                    self._retire(slot, req, timed_out=True)
                    del active[slot]
                    free.append(slot)
                    continue
                self._sample(req, probs[slot])
                if req.done:
                    self._retire(slot, req)
                    del active[slot]
                    free.append(slot)

    def _decode_round(self, active: Dict[int, GenerationRequest]):
        """One decode step of every active slot, grouped by adapter (see
        the module docstring; reference `_decode_round`). Returns `{slot:
        next-token distribution}`."""
        tokens = [active[s].ids[-1] if s in active else 0
                  for s in range(self.slots)]
        groups: Dict[Optional[str], List[int]] = {}
        for s in sorted(active):
            groups.setdefault(active[s].adapter, []).append(s)
        if len(groups) == 1:
            self.stepper.set_params(active[min(active)].params)
            probs = self.stepper.step(tokens)
            self.stats["decode_dispatches"] += 1
            return {s: probs[s] for s in active}
        lengths = [len(active[s].ids) - 1 if s in active else 0
                   for s in range(self.slots)]
        rows: Dict[int, np.ndarray] = {}
        done: set = set()
        for gslots in groups.values():
            self.stepper.set_params(active[gslots[0]].params)
            probs = self.stepper.step(tokens)
            self.stats["decode_dispatches"] += 1
            done.update(gslots)
            for s in gslots:
                rows[s] = probs[s]
            self.stepper.rewind_all([lengths[s] + 1 if s in done
                                     else lengths[s]
                                     for s in range(self.slots)])
        return rows

    def _stepped(self, t0_ns: int,
                 active: Dict[int, GenerationRequest]) -> None:
        """Account one round that began at `t0_ns`: its wall time to the
        stats and histograms, to the decode dispatch seconds, and evenly
        to the active slots' records (every slot rides every dispatch of
        the round)."""
        dur_ns = time.perf_counter_ns() - t0_ns
        seconds = dur_ns / 1e9
        self.stats["decode_seconds"] += seconds
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(active)
        self._step_hist.observe(seconds)
        self._disp_decode.inc(seconds)
        share = seconds / len(active)
        for req in active.values():
            req.ledger_rec.add_device_seconds(share)
            if req.ctx is not None:
                _obs.tracer.complete(
                    "serving.decode_step", t0_ns, dur_ns, cat="serving",
                    parent_ctx=req.ctx, model=self.model_name)

    def _spec_round(self, active: Dict[int, GenerationRequest],
                    free: List[int]) -> None:
        """One speculative round (Leviathan et al., ICML 2023, greedy
        acceptance; reference `_spec_round`, scheduler.py:593-683).

        On entry both steppers have consumed `ids[:-1]` of every active
        slot. The round feeds `[x, d1..dk]` (the pending token and k draft
        proposals) through one target `step_k`; row j is the target's
        distribution after `ids + d1..dj`, so a greedy slot emits tokens
        while the target's argmax agrees with the draft, plus one from the
        first row that disagrees. Both steppers then rewind to
        `len(ids) - 1`. Greedy output equals the non-speculative
        scheduler's; sampled slots emit one token a round, from row 0."""
        draft = self._draft_stepper
        # Clamp k so the target's writes (positions len(ids)-1 ..
        # len(ids)+k-1) never cross capacity.
        k = max(0, min(self._spec_k,
                       min(self.capacity - len(r.ids)
                           for r in active.values())))
        tok = np.zeros((self.slots, k + 1), np.int64)
        tok[:, 0] = [active[s].ids[-1] if s in active else 0
                     for s in range(self.slots)]
        t0_ns = time.perf_counter_ns()
        for j in range(k):
            tok[:, j + 1] = draft.step(tok[:, j]).argmax(axis=-1)
        if k:
            # Feed the last proposal too, so the draft has consumed
            # tok[:, :k+1]; its result is unused (rewound below).
            draft.step(tok[:, k])
        self.stats["draft_steps"] += k + (1 if k else 0)
        probs = self.stepper.step_k(tok)
        self._stepped(t0_ns, active)
        now = time.monotonic()
        for slot, req in list(active.items()):
            if req.cancelled or (req.deadline is not None
                                 and now > req.deadline):
                self._retire(slot, req, timed_out=True)
                del active[slot]
                free.append(slot)
                continue
            greedy = req.temperature <= 0
            accepted = 0
            for j in range(k + 1):
                t = self._sample(req, probs[slot, j])
                if (req.done or not greedy or j >= k
                        or t != int(tok[slot, j + 1])):
                    break
                accepted += 1
            if greedy and k:
                self._spec["accepted"].inc(accepted)
                self._spec["rejected"].inc(k - accepted)
                self.stats["spec_accepted"] += accepted
                self.stats["spec_rejected"] += k - accepted
                req.ledger_rec.add_speculative(accepted, k - accepted)
            if req.done:
                self._retire(slot, req)
                del active[slot]
                free.append(slot)
        # Restore the invariant: both caches back to the tokens kept
        # (retired and free slots to 0).
        lengths = [len(active[s].ids) - 1 if s in active else 0
                   for s in range(self.slots)]
        self.stepper.rewind_all(lengths)
        draft.rewind_all(lengths)

    def _shutdown(self, active: Dict[int, GenerationRequest]) -> None:
        for req in active.values():
            req.error = "server stopped"
            req.event.set()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = "server stopped"
                req.event.set()
