"""Host-side paged KV-cache pool and prompt prefix cache (a copy of
`deeplearning4j_tpu/models/kv_pool.py`, which is numpy-only; the port keeps
its own so it never imports the JAX package).

KV lives in fixed-size PAGES shared by all slots (vLLM's PagedAttention,
Kwon et al., SOSP 2023); each sequence maps logical page indices to
physical pages through its int32 row of `table`, and pages are refcounted
so a shared prefix is resident once. This module is pure bookkeeping: the
device pools live in `models.zoo.PagedDecodeStepper`, the scatter and the
read in `nn/layers/attention.py`.

Invariants:

- physical page 0 is the reserved ZERO page: unmapped table entries point
  at it, so free slots riding a decode dispatch write their dummy-token KV
  there and never corrupt a live page. It is never allocated or freed.
- a page in any slot's WRITE RANGE has refcount 1 at dispatch time:
  `plan_appends` copies-on-write every shared page an append would touch.
  Garbage rows (pad tails, CoW'd tails, rejected speculative tokens) sit
  at key positions >= the cursor, where the attention mask gives them
  weight exactly 0.
- `PrefixCache` holds +1 ref on every page of an admitted prompt, so a
  cached prefix survives its slot's retirement; a hit re-refs the pages and
  replays the stored next-token distribution.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class PoolExhaustedError(RuntimeError):
    """No free page and the reclaim hook could not surrender one."""


class KVPagePool:
    """Refcounted fixed-size-page allocator. `table` is the
    host-authoritative `[slots, pages_per_seq]` int32 page table shipped to
    the device before every dispatch; unmapped entries are 0."""

    def __init__(self, slots: int, capacity: int, page_size: int,
                 pages: Optional[int] = None,
                 reclaim: Optional[Callable[[], bool]] = None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if capacity % page_size:
            raise ValueError(
                f"decode cache capacity {capacity} must be a multiple of "
                f"page_size {page_size}")
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.pages_per_seq = self.capacity // self.page_size
        if pages is None:
            # Worst case (zero sharing): every slot fully deep, + page 0.
            pages = self.slots * self.pages_per_seq + 1
        self.num_pages = int(pages)
        if self.num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is reserved)")
        # LIFO free list keeps recently-freed pages hot.
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int64)
        self._seq: Dict[int, List[int]] = {}   # slot -> physical pages
        self._len: Dict[int, int] = {}         # slot -> token length
        self._cow: Dict[int, int] = {}         # slot -> CoW copies since install
        self.table = np.zeros((self.slots, self.pages_per_seq), np.int32)
        # Called when the free list runs dry; returns True if it freed a
        # page (the scheduler wires PrefixCache.evict_one here).
        self.reclaim = reclaim

    @property
    def free_count(self) -> int:
        return len(self._free)

    def counts(self) -> Dict[str, int]:
        """Page states for the `dl4j_kv_pages` gauges: free, used
        (refcount 1) and shared (refcount >= 2). Page 0 is none of them."""
        return {
            "free": len(self._free),
            "used": int(np.count_nonzero(self._ref == 1)),
            "shared": int(np.count_nonzero(self._ref >= 2)),
        }

    def tracked(self) -> Tuple[int, ...]:
        return tuple(sorted(self._seq))

    def length_of(self, slot: int) -> int:
        return self._len.get(slot, 0)

    @contextlib.contextmanager
    def free_list_kept(self):
        """Run the block, then put the free list back in its order (a
        block that allocates and frees again, as a warmup does, leaves the
        pool as it found it). Raises RuntimeError if the block left a page
        allocated that was free before it, or freed one that was not."""
        before = list(self._free)
        yield
        if sorted(self._free) != sorted(before):
            raise RuntimeError(
                f"the pool's free pages changed: {len(before)} before, "
                f"{len(self._free)} after")
        self._free[:] = before

    def pages_of(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._seq.get(slot, ()))

    def cow_count(self, slot: int) -> int:
        """Copy-on-write page copies this slot has forced since its
        install (the request ledger's per-request CoW field)."""
        return self._cow.get(slot, 0)

    def _alloc_one(self) -> int:
        while not self._free:
            if self.reclaim is None or not self.reclaim():
                raise PoolExhaustedError(
                    f"KV page pool exhausted ({self.num_pages - 1} usable "
                    f"pages of {self.page_size} tokens; "
                    f"{len(self._seq)} resident sequences)")
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def _reserve(self, need: int) -> None:
        """Fail-before-mutate: make sure `need` pages are allocatable."""
        while len(self._free) < need:
            if self.reclaim is None or not self.reclaim():
                raise PoolExhaustedError(
                    f"KV page pool exhausted: need {need} pages, "
                    f"{len(self._free)} free of {self.num_pages - 1} usable")

    def ref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is the reserved zero page")
            self._ref[p] += 1

    def unref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"unref of unallocated page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def install_slot(self, slot: int, length: int) -> List[int]:
        """Allocate fresh pages covering `length` tokens for `slot`."""
        self.free_slot(slot)
        need = -(-int(length) // self.page_size)  # ceil
        if need > self.pages_per_seq:
            raise ValueError(
                f"sequence length {length} exceeds capacity {self.capacity}")
        self._reserve(need)
        pages = [self._alloc_one() for _ in range(need)]
        self._seq[slot] = pages
        self._len[slot] = int(length)
        self.table[slot, :] = 0
        self.table[slot, :need] = pages
        return pages

    def install_shared(self, slot: int, pages: Sequence[int],
                       length: int) -> None:
        """Point `slot` at already-resident pages (prefix-cache hit)."""
        self.free_slot(slot)
        pages = list(pages)
        self.ref(pages)
        self._seq[slot] = pages
        self._len[slot] = int(length)
        self.table[slot, :] = 0
        self.table[slot, :len(pages)] = pages

    def free_slot(self, slot: int) -> None:
        """Retire a slot: unref its pages and zero its table row."""
        pages = self._seq.pop(slot, None)
        self._len.pop(slot, None)
        self._cow.pop(slot, None)
        self.table[slot, :] = 0
        if pages:
            self.unref(pages)

    def rewind(self, slot: int, length: int) -> None:
        """Truncate a slot to `length` tokens (a speculative rejection):
        pages wholly beyond the new length are unref'd. No-op for an
        untracked slot."""
        if slot not in self._seq:
            return
        length = int(length)
        keep = -(-length // self.page_size)
        pages = self._seq[slot]
        drop = pages[keep:]
        if drop:
            self._seq[slot] = pages[:keep]
            self.table[slot, keep:len(pages)] = 0
            self.unref(drop)
        self._len[slot] = length

    def plan_appends(self, t: int) -> List[Tuple[int, int]]:
        """Advance every tracked slot by `t` tokens, allocating pages the
        append crosses into and copy-on-writing shared pages in the write
        range. Returns the `(src, dst)` page copies the device must do
        BEFORE the dispatch. Atomic: exhaustion raises before any state
        mutates."""
        t = int(t)
        plans = []
        need = 0
        for slot, pages in self._seq.items():
            n = self._len[slot]
            first, last = n // self.page_size, (n + t - 1) // self.page_size
            todo = []
            for pi in range(first, min(last, self.pages_per_seq - 1) + 1):
                if pi >= len(pages) or self._ref[pages[pi]] >= 2:
                    todo.append(pi)
                    need += 1
            plans.append((slot, todo))
        self._reserve(need)
        copies: List[Tuple[int, int]] = []
        for slot, todo in plans:
            pages = self._seq[slot]
            for pi in todo:
                new = self._alloc_one()
                if pi < len(pages):
                    copies.append((pages[pi], new))   # CoW: shared page
                    self._cow[slot] = self._cow.get(slot, 0) + 1
                    self.unref([pages[pi]])
                    pages[pi] = new
                else:
                    pages.append(new)
                self.table[slot, pi] = new
            self._len[slot] += t
        return copies


class PrefixCache:
    """LRU prompt -> primed-KV cache over pool pages, keyed on the exact
    prompt token tuple. An entry holds the prompt's pages (+1 ref each),
    its length and the next-token distribution its prefill produced."""

    def __init__(self, pool: KVPagePool, max_entries: int = 32):
        self.pool = pool
        self.max_entries = int(max_entries)
        self._entries: "collections.OrderedDict[Tuple[int, ...], tuple]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, prompt: Sequence[int], namespace=None):
        """`(pages, length, probs)` for an exact prompt match (LRU
        refresh), else None. `namespace` partitions the keys: the same
        prompt prefilled through two params trees (two adapters) has
        different KV, so a hit never crosses them."""
        key = (namespace,) + tuple(int(i) for i in prompt)
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return ent

    def admit(self, prompt: Sequence[int], pages: Sequence[int],
              length: int, probs, namespace=None) -> None:
        """Cache a freshly-prefilled prompt: +1 ref on its pages, LRU-evict
        beyond `max_entries`; `namespace` is the one its `get` missed
        under."""
        key = (namespace,) + tuple(int(i) for i in prompt)
        if key in self._entries or not pages:
            return
        self.pool.ref(pages)
        self._entries[key] = (tuple(int(p) for p in pages), int(length),
                              np.array(probs, copy=True))
        while len(self._entries) > self.max_entries:
            self.evict_one()

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry (the pool's reclaim hook)."""
        if not self._entries:
            return False
        _, (pages, _, _) = self._entries.popitem(last=False)
        self.pool.unref(pages)
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass
