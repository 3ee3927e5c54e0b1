"""Continuous-batching generation scheduler (counterpart of
`deeplearning4j_tpu/serving/scheduler.py`, continuous mode).

The scheduler owns a decode stepper (`models.zoo.DecodeStepper` or
`PagedDecodeStepper`): a fixed bank of slots whose sequences sit at
different depths. New sequences are admitted at STEP BOUNDARIES, so a
request waits for the next single-token step plus its own prefill, and a
slot is recycled the moment its sequence hits EOS or its token budget.

Per-request sampling replays `generate_lm`'s draws (one
`np.random.RandomState(seed)` per request, `_sample_token` per token), so
a continuously batched generation equals the single-sequence path.

Threads: the decode loop runs on its own thread and is the only thread
that touches device tensors; callers hand it host-side requests through a
bounded queue and wait on an event.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.models.kv_pool import PrefixCache
from deeplearning4j_tpu_torch.models.zoo import (
    DecodeStepper,
    PagedDecodeStepper,
    _sample_token,
)
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
                 "event", "t_submit", "rng")

    def __init__(self, prompt, n_steps, *, temperature=1.0, top_k=0,
                 top_p=0.0, seed=0, eos_id=None, deadline=None):
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

    @property
    def done(self) -> bool:
        gen = len(self.ids) - len(self.prompt)
        if gen >= self.n_steps:
            return True
        return (self.eos_id is not None and gen > 0
                and self.ids[-1] == self.eos_id)


class GenerationScheduler:
    """One LM's continuous-batching decode loop (see module docstring).

    `stats` counts what the loop did (prefills, prefix hits, decode steps
    and their wall seconds, tokens sampled from steps) and `ttft_s` keeps
    recent time-to-first-token samples; both are written by the decode
    thread only."""

    def __init__(self, cg, model_name: str = "default", slots: int = 4,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 queue_depth: int = 64, kv: str = "dense",
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
        if kv not in ("dense", "paged"):
            raise ValueError(f"unknown kv cache layout {kv!r}; "
                             "want 'dense' or 'paged'")
        if kv == "dense" and prefix_cache:
            raise ValueError(
                "prefix_cache requires kv='paged' (a hit installs pool "
                "pages by reference; the dense stepper has none to share)")
        self.model_name = model_name
        self.kv = kv
        if kv == "paged":
            self.stepper = PagedDecodeStepper(cg, slots, page_size=page_size,
                                              pages=kv_pages)
        else:
            self.stepper = DecodeStepper(cg, slots)
        self.slots = self.stepper.slots
        self.capacity = self.stepper.capacity
        self.prefix_cache = None
        if kv == "paged" and (prefix_cache is None or prefix_cache):
            self.prefix_cache = PrefixCache(self.stepper.pool)
            self.stepper.pool.reclaim = self.prefix_cache.evict_one
        self.prompt_buckets = prompt_bucket_ladder(self.capacity,
                                                   prompt_buckets)
        self._queue: "queue.Queue[Optional[GenerationRequest]]" = \
            queue.Queue(maxsize=int(queue_depth))
        self._thread: Optional[threading.Thread] = None
        self.stats = {"prefills": 0, "prefix_hits": 0, "decode_steps": 0,
                      "decode_seconds": 0.0, "decode_tokens": 0}
        self.ttft_s: "collections.deque[float]" = collections.deque(
            maxlen=1024)

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
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise ServerOverloadedError(
                f"model {self.model_name!r} generation queue is full "
                f"({self._queue.maxsize} requests); retry later")
        return req

    def generate(self, prompt_ids, n_steps: int, *,
                 timeout_s: Optional[float] = None,
                 **sampling) -> List[int]:
        """Blocking helper: submit + wait; cancels the request (recycled at
        the next step boundary) when the caller's timeout expires."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        req = GenerationRequest(prompt_ids, n_steps, deadline=deadline,
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
        return tok

    def _install_prompt(self, slot: int, req: GenerationRequest,
                        pad_to: int):
        """Get `slot` holding the prompt's KV; return the first-token
        distribution. A prefix-cache hit points the slot at resident pages
        and replays the stored distribution (no forward at all); a miss
        prefills, installs and admits the fresh pages."""
        cache = self.prefix_cache
        hit = cache.get(req.prompt) if cache is not None else None
        if hit is not None:
            pages, n, probs = hit
            self.stepper.install_shared(slot, pages, n)
            self.stats["prefix_hits"] += 1
            return probs
        probs, slot_state, n = self.stepper.prefill(req.prompt, pad_to=pad_to)
        self.stepper.install(slot, slot_state, n)
        self.stats["prefills"] += 1
        if cache is not None:
            cache.admit(req.prompt, self.stepper.pool.pages_of(slot), n,
                        probs)
        return probs

    def _admit(self, slot: int, req: GenerationRequest) -> bool:
        """Prefill + install + first token. True when the request stays
        active in `slot`."""
        pad_to = next(b for b in self.prompt_buckets
                      if len(req.prompt) <= b)
        try:
            probs = self._install_prompt(slot, req, pad_to)
        except Exception as e:  # fail this request, keep the loop alive
            req.error = f"{type(e).__name__}: {e}"
            req.event.set()
            return False
        self._sample(req, probs)
        self.ttft_s.append(time.monotonic() - req.t_submit)
        if req.done:
            self.stepper.clear(slot)
            req.event.set()
            return False
        return True

    def _finish_timeout(self, req: GenerationRequest) -> None:
        if not req.cancelled:
            req.error = "__deadline__"
        req.event.set()

    def _retire(self, slot: int, req: GenerationRequest,
                timed_out: bool = False) -> None:
        self.stepper.clear(slot)
        if timed_out:
            self._finish_timeout(req)
        else:
            req.event.set()

    def _loop(self) -> None:
        active: Dict[int, GenerationRequest] = {}
        try:
            self._loop_inner(active)
        except Exception as e:
            # Decode-loop death strands every active sequence: fail the
            # callers, then let the thread die with the traceback.
            for req in active.values():
                req.error = f"{type(e).__name__}: {e}"
                req.event.set()
            raise

    def _loop_inner(self, active: Dict[int, GenerationRequest]) -> None:
        free = list(reversed(range(self.slots)))
        while True:
            # Admission happens only here, at a step boundary.
            while free:
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
            if not active:
                continue
            tokens = [active[s].ids[-1] if s in active else 0
                      for s in range(self.slots)]
            t0 = time.perf_counter()
            probs = self.stepper.step(tokens)
            self.stats["decode_seconds"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(active)
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
