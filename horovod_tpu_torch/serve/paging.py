"""Paged KV-cache subsystem: block allocator + prefix reuse for serving
(port of ``horovod_tpu/serve/paging.py``: the pool, the prefix cache and
the admission discount line for line, the engine on the port's KVCache).

The dense :class:`~horovod_tpu_torch.serve.kv_cache.DecodeEngine` reserves
``max_seq`` cache rows per slot, so ``slots x max_seq`` bounds HBM no
matter how short requests actually run — vLLM's PagedAttention
observation is that most of that is never reached. This module replaces
the per-slot rows with a shared pool of fixed-size pages
(``HOROVOD_SERVE_PAGE_TOKENS`` tokens each, power of two):

* :class:`PagePool` — refcounted free-list allocator over
  ``HOROVOD_SERVE_PAGE_POOL`` physical pages. Page 0 is the reserved
  SCRATCH page: it is never allocated, pads every request's page table
  past its last real block, and absorbs the padded-prefill garbage
  writes — garbage in scratch is unattendable for the same reason stale
  dense rows are (``cached_attention`` masks ``key_pos <= q_pos``).
* :class:`PrefixCache` — rolling-hash chain over FULL prompt blocks
  plus exact-whole-prompt entries, mapping shared prefixes (system
  prompts) to refcounted pages. N requests sharing a prefill pay for it
  once; an exact repeat does ZERO prefill compute (the cached first
  token and max-|logit| replay). Divergence is copy-on-write: the first
  write into a page with refcount > 1 copies it (``KVCache.copy_page``,
  counted as the ``page_copy`` program at engine init).
* :class:`PagedDecodeEngine` — the drop-in engine behind
  ``HOROVOD_SERVE_PAGED=1``. Reads and writes go through gather/scatter
  at page-table indices held in the decode step's static device buffer
  (copied in place before each replay of its CUDA graph), so growing a
  request appends a page id to a host-side table: zero steady-state
  compiles, token-for-token against the dense path
  (tests/test_torch_paging.py pins parity across prompt buckets).

Admission moves from dense slots to free-page accounting in
``batcher.ContinuousBatcher`` (admit while the pool covers committed
``prompt+max_new`` pages, discounted by the candidate's current prefix
hits); on exhaustion the replica preempts the newest-admitted request
back to the queue FRONT with its pages reclaimed — the zero-lost
requeue invariant holds, and greedy decoding regenerates the dropped
prefix deterministically on resume.

Threading: a pool is touched by its replica thread, the memory
tracker's pull (``total_pool_bytes``) and ``/serve`` snapshots, so all
pool state is behind ``PagePool._lock``. Engine-level structures
(tables, prefix cache, program caches) are owned by the replica loop
thread, like the dense engine's.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.models.transformer import KVCache
from horovod_tpu_torch.serve import kv_cache as _kv
from horovod_tpu_torch.utils.env import (HOROVOD_SERVE_PAGE_POOL,
                                         HOROVOD_SERVE_PAGE_TOKENS,
                                         HOROVOD_SERVE_PREFIX_CACHE,
                                         _get_int)

DEFAULT_PAGE_TOKENS = 16
DEFAULT_PREFIX_ENTRIES = 256

_PAGE_POOL = _metrics().gauge(
    "horovod_serve_page_pool_pages",
    "Allocatable KV pages in the pool (scratch page excluded).",
    labelnames=("replica",))
_PAGE_FREE = _metrics().gauge(
    "horovod_serve_page_free_pages",
    "KV pages currently on the free list.",
    labelnames=("replica",))
_COW = _metrics().counter(
    "horovod_serve_page_cow_copies_total",
    "Copy-on-write page copies (first divergent write to a shared page).",
    labelnames=("replica",))
_PREFIX_HITS = _metrics().counter(
    "horovod_serve_page_prefix_hits_total",
    "Prefills that reused at least one cached prefix page.",
    labelnames=("replica",))
_PREFIX_TOKENS = _metrics().counter(
    "horovod_serve_page_prefix_tokens_total",
    "Prefill prompt tokens, by source (reused from cache / computed).",
    labelnames=("replica", "source"))
_PREEMPTIONS = _metrics().counter(
    "horovod_serve_page_preemptions_total",
    "Requests preempted back to the queue front on pool exhaustion.",
    labelnames=("replica",))

# every live paged engine, so the memory tracker's "kv_pages" subsystem
# can sum resident pool bytes without the serve plane pushing
_pools_lock = threading.Lock()
_pools: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _pools_lock


def total_pool_bytes() -> int:
    """Resident page-pool bytes across every live paged engine on this
    process — the memory tracker's pull source for ``kv_pages``."""
    with _pools_lock:
        engines = list(_pools)
    return sum(e.cache_bytes() for e in engines)


class PagePoolExhausted(RuntimeError):
    """No free page and nothing reclaimable — the caller preempts."""


class PagePool:
    """Refcounted free-list allocator over fixed-size KV pages.

    ``pages`` counts PHYSICAL pages including the reserved scratch page
    0, which is never handed out — page ids returned by :meth:`alloc`
    are in ``[1, pages)``. A page is freed when its refcount reaches
    zero (requests, prefix-cache entries and exact entries each hold
    one ref per page). When the free list is empty, ``alloc`` invokes
    the reclaim hook (prefix-cache LRU eviction) until a page frees or
    nothing is left to evict.
    """

    def __init__(self, pages: int, page_tokens: int, name: str = "pool"):
        if pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (1 scratch + "
                             f"1 allocatable), got {pages}")
        self.pages = int(pages)
        self.page_tokens = int(page_tokens)
        self.name = name
        self._lock = threading.Lock()
        # highest page first so allocation order is deterministic
        self._free: List[int] = list(range(self.pages - 1, 0, -1))  # guarded-by: _lock
        self._refs: Dict[int, int] = {}        # guarded-by: _lock
        self._reclaim = None   # set once by the owning engine, pre-serving
        self.allocs = 0                        # guarded-by: _lock
        self.reclaims = 0                      # guarded-by: _lock

    @property
    def allocatable(self) -> int:
        return self.pages - 1

    def set_reclaim_hook(self, fn) -> None:
        self._reclaim = fn

    def alloc(self) -> int:
        """Take a free page at refcount 1; tries the reclaim hook before
        giving up. Raises :class:`PagePoolExhausted` when every page is
        pinned by a live request."""
        while True:
            with self._lock:
                if self._free:
                    page = self._free.pop()
                    self._refs[page] = 1
                    self.allocs += 1
                    return page
            # the hook evicts cache entries, which re-enters unref() —
            # so it must run outside _lock
            if self._reclaim is None or not self._reclaim():
                raise PagePoolExhausted(
                    f"{self.name}: all {self.allocatable} pages pinned")
            with self._lock:
                self.reclaims += 1

    def ref(self, page: int) -> None:
        with self._lock:
            if page not in self._refs:
                raise ValueError(f"ref of unallocated page {page}")
            self._refs[page] += 1

    def unref(self, page: int) -> bool:
        """Drop one ref; returns True when the page was freed."""
        with self._lock:
            count = self._refs.get(page)
            if count is None:
                raise ValueError(f"unref of unallocated page {page}")
            if count > 1:
                self._refs[page] = count - 1
                return False
            del self._refs[page]
            self._free.append(page)
            return True

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def used_count(self) -> int:
        with self._lock:
            return len(self._refs)

    def stats(self) -> dict:
        with self._lock:
            return {"pages": self.allocatable,
                    "page_tokens": self.page_tokens,
                    "free": len(self._free),
                    "used": len(self._refs),
                    "allocs": self.allocs,
                    "reclaims": self.reclaims}


class PrefixCache:
    """Token-prefix → page mapping for prefill reuse.

    Two entry kinds share one LRU order (single ``OrderedDict``):

    * BLOCK entries, keyed by ``(depth, rolling_hash)`` where the hash
      chains over full ``page_tokens`` blocks — a depth-``d`` hit is
      only reachable through hits at every shallower depth, so a match
      (verified against the stored block tokens, hash collisions are a
      miss) proves the whole prefix. The entry maps one FULL block to
      one refcounted page.
    * EXACT entries, keyed by the whole prompt tuple: all of the
      prompt's pages (partial tail page included) plus the prefill's
      first generated token and max-|logit| — a repeat prompt replays
      them with zero prefill compute. The tail page is shared, so the
      repeat's first decode write copy-on-writes it.

    Owned by the replica loop thread; page refcounts go through the
    (locked) pool. Evicting an entry drops its page refs — pages still
    referenced by live requests survive, the cache just forgets them.
    """

    def __init__(self, pool: PagePool, capacity: int):
        self.pool = pool
        self.capacity = int(capacity)
        self._entries: "OrderedDict" = OrderedDict()  # guarded-by: <replica-thread>
        self.hits = 0
        self.lookups = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _walk(self, prompt: List[int]):
        """Yield ``(depth, hash, block)`` for every FULL block; the hash
        chains so equal (depth, hash, block) implies equal prefix."""
        T = self.pool.page_tokens
        h = 0
        for depth in range(len(prompt) // T):
            block = tuple(prompt[depth * T:(depth + 1) * T])
            h = hash((h, block))
            yield depth, h, block

    def lookup(self, prompt: List[int]
               ) -> Tuple[List[int], Optional[Tuple[Tuple[int, ...], int, float]]]:
        """(longest-prefix hit pages, exact entry or None). Does NOT
        take refs — the caller refs what it keeps."""
        self.lookups += 1
        exact = self._entries.get(("x", tuple(prompt)))
        if exact is not None:
            self._entries.move_to_end(("x", tuple(prompt)))
            self.hits += 1
            return list(exact[0]), (exact[0], exact[1], exact[2])
        pages: List[int] = []
        for depth, h, block in self._walk(prompt):
            entry = self._entries.get(("b", depth, h))
            if entry is None or entry[1] != block:
                break
            self._entries.move_to_end(("b", depth, h))
            pages.append(entry[0])
        if pages:
            self.hits += 1
        return pages, None

    def probe(self, prompt: List[int]) -> int:
        """Full-block hit count WITHOUT touching LRU order or counters —
        the admission-time page-cost discount."""
        n = 0
        for depth, h, block in self._walk(prompt):
            entry = self._entries.get(("b", depth, h))
            if entry is None or entry[1] != block:
                break
            n += 1
        return n

    def insert(self, prompt: List[int], pages: List[int],
               first_token: int, max_abs: float) -> None:
        """Cache a finished prefill's pages (one ref per entry-page)."""
        if self.capacity <= 0:
            return
        for depth, h, block in self._walk(prompt):
            key = ("b", depth, h)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self.pool.ref(pages[depth])
            self._entries[key] = (pages[depth], block)
        key = ("x", tuple(prompt))
        if key in self._entries:
            self._entries.move_to_end(key)
        else:
            for p in pages:
                self.pool.ref(p)
            self._entries[key] = (tuple(pages), int(first_token),
                                  float(max_abs))
        self.inserts += 1
        while len(self._entries) > self.capacity:
            self._evict_lru()

    def _evict_lru(self) -> None:
        key, entry = self._entries.popitem(last=False)
        if key[0] == "b":
            self.pool.unref(entry[0])
        else:
            for p in entry[0]:
                self.pool.unref(p)
        self.evictions += 1

    def reclaim_one(self) -> bool:
        """Pool reclaim hook: evict LRU entries until one page actually
        frees (entries whose pages are still shared free nothing).
        Returns False once the cache is empty."""
        while self._entries:
            key, entry = self._entries.popitem(last=False)
            self.evictions += 1
            pages = (entry[0],) if key[0] == "b" else entry[0]
            freed = False
            for p in pages:
                freed |= self.pool.unref(p)
            if freed:
                return True
        return False

    def held_pages(self) -> set:
        held = set()
        for key, entry in self._entries.items():
            if key[0] == "b":
                held.add(entry[0])
            else:
                held.update(entry[0])
        return held

    def release_all(self) -> None:
        while self._entries:
            self._evict_lru()

    def stats(self) -> dict:
        return {"entries": len(self._entries), "capacity": self.capacity,
                "lookups": self.lookups, "hits": self.hits,
                "inserts": self.inserts, "evictions": self.evictions}


def auto_pool_pages(num_slots: int, max_seq: int, page_tokens: int) -> int:
    """Default pool size (physical pages, scratch included): half the
    dense engine's ``slots x max_seq`` token capacity — the paged bench
    must show >= 2x lower KV bytes at equal occupancy — floored so one
    worst-case request (``max_seq`` tokens) always fits."""
    max_blocks = -(-max_seq // page_tokens)
    return max(max_blocks + 1, num_slots * max_seq // (2 * page_tokens))




class PagedDecodeEngine(_kv.StepEngine):
    """Pool-paged drop-in for :class:`~horovod_tpu_torch.serve.kv_cache.
    DecodeEngine` (``HOROVOD_SERVE_PAGED=1``).

    Same program discipline as dense: ONE fixed-shape decode step over all
    slots (a CUDA graph on the card, :class:`~horovod_tpu_torch.serve.
    kv_cache.DecodeStep`), one prefill per suffix-length bucket, plus the
    page copy (COW), counted at init. The cache is ``(pool_pages,
    page_tokens, heads, head_dim)`` a layer and every read and write goes
    through per-slot page tables: host-side (``_tables``) and as a
    ``(slots, max_blocks+1)`` array whose padding entries point at scratch
    page 0, copied into the step's static table before each step.

    The replica loop calls :meth:`prepare_step` before each decode step to
    grow tables across block boundaries and copy-on-write shared pages;
    both can raise :class:`PagePoolExhausted`, which the replica answers by
    preempting the newest-admitted request. ``decode`` also calls it, so
    direct callers (tests, chip_smoke) can never corrupt a shared page.
    """

    paged = True

    def __init__(self, model, num_slots: int, name: str = "r0",
                 page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_entries: Optional[int] = None):
        _kv.check_causal(model)
        max_seq = int(model.max_seq)
        T = int(_get_int(HOROVOD_SERVE_PAGE_TOKENS, DEFAULT_PAGE_TOKENS)
                if page_tokens is None else page_tokens)
        if T < 1 or (T & (T - 1)):
            raise ValueError(
                f"{HOROVOD_SERVE_PAGE_TOKENS} must be a power of two, "
                f"got {T}")
        self.page_tokens = T
        self.max_blocks = -(-max_seq // T)
        self.table_width = self.max_blocks + 1   # last entry: scratch pad
        pages = int(_get_int(HOROVOD_SERVE_PAGE_POOL, 0)
                    if pool_pages is None else pool_pages)
        if pages <= 0:
            pages = auto_pool_pages(int(num_slots), max_seq, T)
        if pages - 1 < self.max_blocks:
            raise ValueError(
                f"{HOROVOD_SERVE_PAGE_POOL}={pages} cannot hold one "
                f"max_seq={max_seq} request "
                f"({self.max_blocks} pages of {T} tokens + scratch)")
        self.pool = PagePool(pages, T, name=f"{name}.pool")
        entries = int(_get_int(HOROVOD_SERVE_PREFIX_CACHE,
                               DEFAULT_PREFIX_ENTRIES)
                      if prefix_entries is None else prefix_entries)
        self.prefix = PrefixCache(self.pool, entries) if entries > 0 else None
        if self.prefix is not None:
            self.pool.set_reclaim_hook(self.prefix.reclaim_one)

        self._start(model, num_slots, name, KVCache.paged(model, pages, T),
                    table_width=self.table_width)
        # per-slot page tables + token high-water marks (replica thread)
        self._tables: List[List[int]] = [[] for _ in range(self.num_slots)]
        self._table_arr = np.zeros((self.num_slots, self.table_width),
                                   np.int64)
        self._lengths = [0] * self.num_slots
        self.cow_copies = 0
        self.preemptions = 0
        self.exact_hits = 0
        self.reused_tokens = 0
        self.computed_tokens = 0
        # the COW copy is counted now, so the first real divergence adds
        # no program key in steady state
        self._programs.note("page_copy")
        with _pools_lock:
            _pools.add(self)
        _PAGE_POOL.labels(replica=self.name).set(self.pool.allocatable)
        _PAGE_FREE.labels(replica=self.name).set(self.pool.free_count())

    # -- page bookkeeping --------------------------------------------------
    def _set_table(self, slot: int, pages: List[int], length: int) -> None:
        self._tables[slot] = list(pages)
        row = self._table_arr[slot]
        row[:] = 0
        row[:len(pages)] = pages
        self._lengths[slot] = length

    def release_slot(self, slot: int) -> None:
        """Drop the slot's page refs (retire/preempt/re-prefill). Pages
        shared with the prefix cache survive under the cache's refs."""
        for page in self._tables[slot]:
            self.pool.unref(page)
        self._tables[slot] = []
        self._table_arr[slot, :] = 0
        self._lengths[slot] = 0
        _PAGE_FREE.labels(replica=self.name).set(self.pool.free_count())

    def release_all(self) -> None:
        """Quarantine/eviction path: every request-held page goes back
        (``request_held == 0`` after it)."""
        for slot in range(self.num_slots):
            if self._tables[slot]:
                self.release_slot(slot)

    def probe_prefix(self, prompt: List[int]) -> int:
        """Admission-time page discount: FULL blocks currently cached
        for this prompt. Capped so the recompute-last-block rule (see
        :meth:`prefill`) never discounts a page prefill must allocate."""
        if self.prefix is None:
            return 0
        cap = (len(prompt) - 1) // self.page_tokens
        return min(self.prefix.probe(prompt), cap)

    def prepare_step(self, slots: List[int], positions: List[int]) -> None:
        """Make every row's next write position ownable: grow the table
        across a block boundary (alloc+append) and copy-on-write shared
        pages. Idempotent — a retry after preemption re-checks cheaply.
        Raises :class:`PagePoolExhausted` when the pool cannot cover
        it; partial allocations stay (they are this request's pages and
        survive to the retry)."""
        T = self.page_tokens
        for slot, pos in zip(slots, positions):
            if pos >= self.max_seq:
                continue   # decode() raises the admission-cap error
            blk = pos // T
            table = self._tables[slot]
            while blk >= len(table):
                page = self.pool.alloc()   # may raise: caller preempts
                table.append(page)
                self._table_arr[slot, len(table) - 1] = page
            page = table[blk]
            if self.pool.refcount(page) > 1:
                fresh = self.pool.alloc()  # may raise: caller preempts
                self._cache.copy_page(page, fresh)
                self.pool.unref(page)
                table[blk] = fresh
                self._table_arr[slot, blk] = fresh
                self.cow_copies += 1
                _COW.labels(replica=self.name).inc()
        _PAGE_FREE.labels(replica=self.name).set(self.pool.free_count())

    def note_preemption(self) -> None:
        self.preemptions += 1
        _PREEMPTIONS.labels(replica=self.name).inc()

    # -- serving ops -------------------------------------------------------
    def prefill(self, slot: int, prompt: List[int]) -> Tuple[int, float]:
        """Paged prefill: reuse every cached full-prefix block, compute
        only the suffix (bucketed, batch 1, starting at the first
        uncached position), and cache the result for the next sharer. An
        exact repeat replays the cached first token with zero prefill
        compute."""
        self._check_prompt(prompt)
        T = self.page_tokens
        self.release_slot(slot)   # re-prefill frees the previous occupant
        if self.prefix is not None:
            hit_pages, exact = self.prefix.lookup(prompt)
        else:
            hit_pages, exact = [], None
        if exact is not None:
            pages, token, max_abs = exact
            for p in pages:
                self.pool.ref(p)
            self._set_table(slot, list(pages), len(prompt))
            self.exact_hits += 1
            self.reused_tokens += len(prompt)
            _PREFIX_HITS.labels(replica=self.name).inc()
            _PREFIX_TOKENS.labels(replica=self.name,
                                  source="reused").inc(len(prompt))
            return int(token), float(max_abs)

        # at least the LAST prompt token must be recomputed (its logits
        # produce the first generated token), and the suffix prefill
        # writes its blocks — so a full-block hit covering the whole
        # prompt drops its last block and recomputes it into a fresh
        # page (identical values: greedy + same prefix)
        hit_tokens = min(len(hit_pages) * T, ((len(prompt) - 1) // T) * T)
        hit_pages = hit_pages[:hit_tokens // T]
        needed = -(-len(prompt) // T)
        taken: List[int] = []
        try:
            for p in hit_pages:
                self.pool.ref(p)
                taken.append(p)
            while len(taken) < needed:
                taken.append(self.pool.alloc())
        except PagePoolExhausted:
            for p in taken:     # roll back — admission retries after
                self.pool.unref(p)   # the replica preempts a victim
            raise
        suffix = prompt[hit_tokens:]
        bucket = self._bucket(len(suffix))
        dev = self._step.device
        row = np.zeros((1, self.table_width), np.int64)
        row[0, :needed] = taken
        with torch.no_grad():
            hidden = self._model(
                _kv.padded_prompt(suffix, bucket, dev),
                positions=torch.full((1,), hit_tokens, dtype=torch.long,
                                     device=dev),
                cache=self._cache, page_table=torch.from_numpy(row).to(dev),
                output="hidden")
            token, max_abs = _kv.greedy(_kv.last_logits(
                self._model, hidden, len(suffix) - 1))
        token, max_abs = int(token), float(max_abs)
        self._set_table(slot, taken, len(prompt))
        if hit_pages:
            _PREFIX_HITS.labels(replica=self.name).inc()
        self.reused_tokens += hit_tokens
        self.computed_tokens += len(suffix)
        _PREFIX_TOKENS.labels(replica=self.name,
                              source="reused").inc(hit_tokens)
        _PREFIX_TOKENS.labels(replica=self.name,
                              source="computed").inc(len(suffix))
        if self.prefix is not None:
            self.prefix.insert(prompt, taken, token, max_abs)
        _PAGE_FREE.labels(replica=self.name).set(self.pool.free_count())
        return token, max_abs

    def decode(self, slots: List[int], tokens: List[int],
               positions: List[int]) -> Tuple[List[int], List[float]]:
        """One decode step over ALL slots through the one paged step.
        Runs :meth:`prepare_step` first so every write position owns
        its page."""
        self.prepare_step(slots, positions)
        self._note_decode()
        step_tokens, step_pos = self._step_inputs(slots, tokens, positions)
        # inactive rows still run (fixed shape) and write garbage KV at
        # position 0: a mapped table would scribble on their block-0
        # page, which may be SHARED with the prefix cache or another
        # request. Zeroed rows route the write to the scratch page,
        # which is only ever gathered at masked key positions.
        step_table = np.zeros_like(self._table_arr)
        step_table[slots] = self._table_arr[slots]
        out = self._run_step(slots, step_tokens, step_pos, step_table)
        for s, p in zip(slots, positions):
            self._lengths[s] = max(self._lengths[s], p + 1)
        return out

    # -- introspection -----------------------------------------------------
    def page_stats(self) -> dict:
        """Pool occupancy split by holder, utilization and (internal)
        fragmentation — the ``/serve`` page-pool fields and the flight
        recorder's postmortem view of the pool at death."""
        request_held = set()
        held_tokens = 0
        for slot in range(self.num_slots):
            request_held.update(self._tables[slot])
            held_tokens += self._lengths[slot]
        prefix_held = (self.prefix.held_pages()
                       if self.prefix is not None else set())
        pool = self.pool.stats()
        T = self.page_tokens
        req_pages = len(request_held)
        # internal fragmentation: allocated token rows the requests
        # mapping them have not (yet) filled
        frag = (1.0 - held_tokens / (req_pages * T)) if req_pages else 0.0
        return {
            **pool,
            "utilization": round(pool["used"] / max(pool["pages"], 1), 3),
            "fragmentation": round(max(frag, 0.0), 3),
            "request_held": req_pages,
            "prefix_held": len(prefix_held),
            "shared": len(request_held & prefix_held),
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "exact_hits": self.exact_hits,
            "reused_tokens": self.reused_tokens,
            "computed_tokens": self.computed_tokens,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "prefix": (self.prefix.stats()
                       if self.prefix is not None else None),
        }

    def prefix_hit_rate(self) -> float:
        """Token-weighted prefill reuse: cached tokens / prompt tokens."""
        total = self.reused_tokens + self.computed_tokens
        return round(self.reused_tokens / total, 4) if total else 0.0

    def stats(self) -> dict:
        compiles = self._programs.counts()
        return {"compiles": compiles,
                "compiles_total": sum(compiles.values()),
                "decode_steps": self.decode_steps,
                "decode_step_ms_ewma": round(self.step_ms_ewma, 3),
                "cache_bytes": self.cache_bytes(),
                "slots": self.num_slots,
                "pages": self.page_stats()}
