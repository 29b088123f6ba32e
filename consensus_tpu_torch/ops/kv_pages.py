"""Paged KV cache bookkeeping: a free-list page allocator + per-slot block
tables (PagedAttention-style block management, Kwon et al., SOSP '23).

The continuous-batching engine (``backends/engine.py``) keeps every
resident request's KV in fixed-size PAGES drawn from one fixed pool sized
at startup — instead of one contiguous, bucket-padded cache per batch.  A
slot's logical token stream maps to a BLOCK TABLE (ordered page list);
ragged-length slots coexist without padding each other, and a finished or
cancelled slot returns its pages to the free list immediately.

This module is the HOST side: allocation, block tables, and the no-aliasing
invariant (a page belongs to at most one owner at a time — double frees and
foreign frees raise).  The DEVICE side — gathering K/V through a block
table inside attention — lives in ``ops/decode_attention.paged_attention``
and the slot programs in ``models/stepper.py``.

Cross-request prefix reuse adds two pieces:

* REFCOUNTED SHARING — ``share()`` lets a second holder (the prefix cache,
  or a slot adopting cached pages) pin pages another owner allocated; a
  page returns to the free list only when its last reference is freed.
  Shared pages are READ-ONLY by convention: cache hits are page-aligned,
  so a request forks at the first divergent PAGE — it writes its own fresh
  pages from there and never mutates a shared one (copy-on-write at page
  granularity, RadixAttention-style).
* :class:`PrefixCache` — a content-addressed map from blake2b of
  (model-tier/quant identity, prompt-token prefix) to the device pages
  holding that prefix's KV, LRU-bounded by a page budget so
  ``suggest_kv_page_pool``'s device-memory reservation is never exceeded.

Thread safety: the engine loop is single-threaded, but ``stats()`` is read
from serving threads (/healthz), so the pool takes a lock around every
mutation and snapshot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """An allocation did not fit the pool's free list.  The engine maps this
    to admission-level backpressure (``SchedulerRejected``) — it must never
    escape to a waiter as a bare RuntimeError."""


@dataclasses.dataclass(frozen=True)
class PoolStats:
    num_pages: int
    page_size: int
    pages_in_use: int
    pages_free: int
    high_water: int
    pages_shared: int = 0


class PagePool:
    """Fixed pool of KV pages with a LIFO free list and per-page refcounts.

    All-or-nothing allocation: ``alloc(n)`` either returns ``n`` distinct
    page ids or raises :class:`PagePoolExhausted` leaving the pool
    untouched.  LIFO reuse keeps the working set of page ids dense, which
    keeps device block tables cache-friendly and makes aliasing bugs (a
    freed page handed to two owners) surface immediately in tests.

    ``share()`` adds a reference to an already-allocated page; ``free()``
    drops one reference, and the page rejoins the free list only at zero —
    so the prefix cache and any number of slots can pin the same prefix
    pages, and the last holder out returns them.  Freeing a page nobody
    holds still raises (double free / foreign free), shared or not.
    """

    def __init__(self, num_pages: int, page_size: int = 16):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"pool needs positive dimensions, got {num_pages=} {page_size=}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owner: Dict[int, object] = {}
        self._refs: Dict[int, int] = {}
        self._high_water = 0

    # -- allocation --------------------------------------------------------

    def pages_for_tokens(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries (ceil)."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def alloc(self, n: int, owner: object = None) -> List[int]:
        with self._lock:
            if n > len(self._free):
                raise PagePoolExhausted(
                    f"need {n} pages, {len(self._free)} free of {self.num_pages}"
                )
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._owner[p] = owner
                self._refs[p] = 1
            self._high_water = max(self._high_water, len(self._owner))
            return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (must be allocated).  The caller
        becomes a co-holder: it must ``free()`` exactly once per share, and
        must treat the pages as READ-ONLY (fork-at-first-divergent-page)."""
        with self._lock:
            for p in pages:
                if p not in self._owner:
                    raise ValueError(
                        f"page {p} is not allocated (cannot share a free page)"
                    )
            for p in pages:
                self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page rejoins the free list only
        when its LAST reference goes (refcounted sharing)."""
        with self._lock:
            for p in pages:
                if p not in self._owner:
                    raise ValueError(
                        f"page {p} is not allocated (double free or foreign page)"
                    )
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._owner[p]
                    del self._refs[p]
                    self._free.append(p)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    # -- introspection -----------------------------------------------------

    @property
    def in_use(self) -> int:
        with self._lock:
            return len(self._owner)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> PoolStats:
        with self._lock:
            return PoolStats(
                num_pages=self.num_pages,
                page_size=self.page_size,
                pages_in_use=len(self._owner),
                pages_free=len(self._free),
                high_water=self._high_water,
                pages_shared=sum(1 for r in self._refs.values() if r > 1),
            )


class BlockTable:
    """One slot's ordered page list + logical token length.

    ``append_tokens`` grows the table to cover ``num_tokens + n`` tokens,
    allocating pages only when the current last page is full — so a slot
    ingesting a prompt chunk-by-chunk touches the allocator once per
    page boundary, not once per token.
    """

    def __init__(self, slot: int):
        self.slot = slot
        self.pages: List[int] = []
        self.num_tokens = 0

    def adopt_shared(
        self, pool: PagePool, pages: Sequence[int], n_tokens: int
    ) -> None:
        """Start this table from a cached, page-aligned prefix: take a
        reference on ``pages`` (the cache keeps its own) and count their
        tokens as already resident.  Shared pages are read-only — they are
        all FULL (page alignment), so every subsequent ``append_tokens``
        write lands in a fresh private page: the fork at the first
        divergent page is structural, never a mid-page copy."""
        if self.pages or self.num_tokens:
            raise ValueError("adopt_shared requires an empty block table")
        if n_tokens != len(pages) * pool.page_size:
            raise ValueError(
                f"shared prefix must be page-aligned: {n_tokens} tokens "
                f"over {len(pages)} pages of {pool.page_size}"
            )
        pool.share(pages)
        self.pages = list(pages)
        self.num_tokens = int(n_tokens)

    def append_tokens(self, pool: PagePool, n: int) -> List[int]:
        """Extend the logical stream by ``n`` tokens; returns newly
        allocated page ids (all-or-nothing — on PagePoolExhausted the table
        is unchanged)."""
        target = self.num_tokens + int(n)
        need = pool.pages_for_tokens(target) - len(self.pages)
        fresh: List[int] = []
        if need > 0:
            fresh = pool.alloc(need, owner=self)
            self.pages.extend(fresh)
        self.num_tokens = target
        return fresh

    def release(self, pool: PagePool) -> None:
        if self.pages:
            pool.free(self.pages)
        self.pages = []
        self.num_tokens = 0

    def write_cursor(self, pool: PagePool) -> tuple:
        """(page_id, offset) where the NEXT token's KV lands.  Valid only
        after ``append_tokens`` reserved room for it."""
        if not self.pages:
            raise ValueError("empty block table has no write cursor")
        last = self.num_tokens - 1
        return self.pages[last // pool.page_size], last % pool.page_size

    def as_array(self, max_blocks: int) -> np.ndarray:
        """Fixed-shape device view: (max_blocks,) int32, -1 padded — the
        shape every compiled slot program sees regardless of this slot's
        actual length (no per-length recompiles)."""
        if len(self.pages) > max_blocks:
            raise ValueError(
                f"slot {self.slot} holds {len(self.pages)} pages > "
                f"max_blocks={max_blocks}"
            )
        out = np.full((max_blocks,), -1, np.int32)
        out[: len(self.pages)] = self.pages
        return out


class _PrefixEntry:
    __slots__ = ("pages", "n_tokens", "tokens")

    def __init__(self, pages: List[int], n_tokens: int, tokens: Tuple = ()):
        self.pages = pages
        self.n_tokens = n_tokens
        #: The token prefix itself — retained so a run can be EXPORTED
        #: (serve/pagestore.py warm handoff) and re-inserted into another
        #: replica's cache, which needs the tokens to rebuild the chained
        #: content keys.  Token ids are small ints/strs; the KV bytes they
        #: key are the heavy payload and those stay on device.
        self.tokens = tokens


class PrefixCache:
    """Content-addressed map from prompt-token prefixes to resident KV pages.

    Key = blake2b over (identity, page-aligned token prefix) where identity
    names the model tier + KV quantization — two tiers (or quant modes)
    never alias each other's KV bytes.  Value = the page ids holding that
    prefix, pinned with one cache-owned reference (``pool.share``).

    ``lookup`` returns the LONGEST cached page-aligned prefix of the given
    token stream and takes a reference on its pages for the caller (the
    admitting slot); a miss returns ``([], 0)``.  ``insert`` registers a
    completed prefix and evicts least-recently-used entries past
    ``max_pages`` — eviction only drops the CACHE's reference, so pages
    still adopted by live slots survive until those slots retire.

    Keys chain per page (``key_n = blake2b(key_{n-1} + page_tokens)``) so
    one lookup hashes the prompt once and probes every page-aligned prefix
    length from longest down.
    """

    def __init__(
        self,
        pool: PagePool,
        max_pages: int,
        identity: Tuple = (),
    ):
        self.pool = pool
        self.max_pages = max(0, int(max_pages))
        #: Model-tier/quant identity the content keys are seeded with —
        #: exposed so the warm-handoff PageStore can refuse to adopt runs
        #: across mismatched identities (different model or tp width ==
        #: different KV bytes, same tokens notwithstanding).
        self.identity = tuple(identity)
        self._seed = repr(self.identity).encode()
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self._pages_cached = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserted_pages = 0
        self.tokens_saved = 0

    def _chain_keys(self, tokens: Sequence) -> List[bytes]:
        """Digest per page-aligned prefix length: index i covers (i+1) pages."""
        ps = self.pool.page_size
        keys: List[bytes] = []
        h = hashlib.blake2b(self._seed, digest_size=16)
        for n in range(len(tokens) // ps):
            h.update(repr(tuple(tokens[n * ps : (n + 1) * ps])).encode())
            keys.append(h.digest())
        return keys

    def lookup(self, tokens: Sequence) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``tokens`` → (pages,
        n_tokens), with one reference taken per page for the caller (free
        them through ``BlockTable.release`` / ``pool.free``)."""
        keys = self._chain_keys(tokens)
        with self._lock:
            for i in range(len(keys) - 1, -1, -1):
                entry = self._entries.get(keys[i])
                if entry is None:
                    continue
                self._entries.move_to_end(keys[i])
                self.pool.share(entry.pages)
                self.hits += 1
                self.tokens_saved += entry.n_tokens
                return list(entry.pages), entry.n_tokens
            self.misses += 1
            return [], 0

    def insert(self, tokens: Sequence, pages: Sequence[int]) -> bool:
        """Register a fully-prefilled page-aligned prefix.  The cache takes
        its own reference on ``pages`` (the inserting slot keeps and later
        frees its own).  Returns False when already present or when the
        entry alone exceeds the page budget."""
        ps = self.pool.page_size
        n_pages = len(pages)
        if n_pages == 0 or len(tokens) != n_pages * ps:
            return False
        if self.max_pages and n_pages > self.max_pages:
            return False
        keys = self._chain_keys(tokens)
        key = keys[n_pages - 1]
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            self.pool.share(pages)
            self._entries[key] = _PrefixEntry(
                list(pages), n_pages * ps, tokens=tuple(tokens)
            )
            self._pages_cached += n_pages
            self.inserted_pages += n_pages
            while self.max_pages and self._pages_cached > self.max_pages:
                _, old = self._entries.popitem(last=False)
                self.pool.free(old.pages)
                self._pages_cached -= len(old.pages)
                self.evictions += 1
            return True

    def export_runs(
        self, max_runs: Optional[int] = None
    ) -> List[Dict[str, object]]:
        """Snapshot the hottest cached runs for warm handoff, most recently
        used FIRST: each run carries the tokens (to rebuild chained keys on
        the importing side), its final chained content key, the page ids it
        occupies HERE (device-local — meaningful only to a backend that can
        serialize those pages' KV bytes), and the block-table metadata a
        joining replica needs to re-admit it.  No references are taken —
        the export is a point-in-time read; the PageStore's payload capture
        happens in the same harvest pass, before any eviction could free
        the pages."""
        with self._lock:
            runs: List[Dict[str, object]] = []
            for key, entry in reversed(self._entries.items()):
                if max_runs is not None and len(runs) >= max_runs:
                    break
                runs.append({
                    "key": key,
                    "tokens": tuple(entry.tokens),
                    "n_tokens": entry.n_tokens,
                    "pages": list(entry.pages),
                    "page_size": self.pool.page_size,
                })
            return runs

    def clear(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                self.pool.free(entry.pages)
            self._entries.clear()
            self._pages_cached = 0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "pages": self._pages_cached,
                "max_pages": self.max_pages,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "inserted_pages": self.inserted_pages,
                "tokens_saved": self.tokens_saved,
            }
