"""Continuous-batching decode engine: always-on iteration loop over a slot
table backed by a paged KV cache.

The legacy :class:`~consensus_tpu_torch.backends.batching.BatchingBackend` model
is flush-snapshot: worker calls queue until EVERY active session blocks (or
a quiescence window expires), then one merged batch dispatches and the
cycle restarts.  That barrier costs throughput: rows pad to the widest
bucket, and the device idles between flushes while stragglers finish host
work.

This engine replaces the barrier with ITERATION-LEVEL batching (Orca, Yu
et al., OSDI '22): a persistent loop over a fixed table of ``n_slots``
request slots.  Each iteration

1. consults cancellation probes — queued work is dropped before any pages
   are spent, resident rows are EVICTED and their pages freed;
2. admits queued generate rows into free slots under a conservative page
   reservation (prompt + max_tokens pages must fit the pool, so a resident
   row can always finish — no mid-decode preemption);
3. advances chunked PREFILL: each mid-prefill slot ingests one
   ``prefill_chunk``-token chunk of its prompt, allocating pages as the
   chunk crosses page boundaries — long prompts interleave with decode
   instead of stalling it;
4. dispatches the DECODE cohort: all prefill-complete slots run as one
   batch on the inner backend, then retire, freeing their pages — new
   arrivals admitted meanwhile join the next iteration (requests join and
   leave at iteration granularity; there is no full-batch flush barrier
   and no timeout reason);
5. batches every queued score / next_token / embed call into one inner
   call per kind.

Correctness: per-request threefry keys (backends/torch_backend.py) and
(prompt, seed)-keyed hashing (backends/fake.py) make every sampled draw
independent of batch composition, so engine cohorts equal flushes and solo
execution on the CPU — pinned for all seven methods in
tests/test_torch_engine.py.  On the card a cohort's row bucket can flip a
greedy near-tie (``TorchBackend.deterministic_greedy`` is False there).

KV residency is tracked in PAGES (ops/kv_pages.py): a slot's stream maps
to a block table over one fixed pool, so ragged-length slots coexist
without bucket padding.  On the device side the matching fixed-shape slot
programs are ``models/stepper.paged_prefill_chunk`` /
``paged_decode_step(s)`` over ``ops/decode_attention.paged_attention``,
with slot lengths entering as data only.  The engine delegates token
generation itself to the inner backend (that is what keeps the seven
methods byte-identical across engine on/off), while the pool/block-table
accounting here is exactly the residency contract those programs consume.

A request that could NEVER fit the pool (prompt + max_tokens pages >
pool) is rejected gracefully with the serving tier's
``SchedulerRejected`` (lazy import — backends must not import serve at
module load).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from consensus_tpu_torch.backends.base import (
    BackendLostError,
    PartialBatchError,
    RequestCancelled,
)
from consensus_tpu_torch.obs.metrics import (
    DEFAULT_COUNT_BUCKETS,
    Registry,
    get_registry,
)
from consensus_tpu_torch.obs.trace import (
    IterationLedger,
    get_flight_recorder,
    trace_current,
)
from consensus_tpu_torch.ops.kv_pages import BlockTable, PagePool, PrefixCache
from consensus_tpu_torch.parallel.mesh import parse_mesh_spec

#: Engine defaults.  ``NUM_PAGES``/``PAGE_SIZE`` give a 16k-token pool —
#: roomy for CPU/fake runs; runs on the card size the pool from the
#: backend's session budget via ``suggest_kv_page_pool``.
DEFAULT_SLOTS = 8
DEFAULT_PAGE_SIZE = 16
DEFAULT_NUM_PAGES = 1024
DEFAULT_PREFILL_CHUNK = 128

_PREFILL = "prefill"
_READY = "ready"


class _Item:
    """One submitted call: ``requests`` fan out to rows (generate) or ride
    whole (score/next_token/embed)."""

    __slots__ = (
        "kind", "requests", "probe", "event", "result", "error",
        "rows_left", "row_results", "row_errors", "failed", "trace", "span",
    )

    def __init__(self, kind: str, requests: List[Any], probe):
        self.kind = kind
        self.requests = requests
        self.probe = probe
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.rows_left = len(requests)
        self.row_results: Dict[int, Any] = {}
        self.row_errors: Dict[int, BaseException] = {}
        #: Set when the whole item is being failed (cancel/reject): rows
        #: still resident are evicted, rows still queued are dropped.
        self.failed = False
        #: Request-scoped trace (obs.trace) captured at submit; span 0 (and
        #: trace None) mean "untraced" and every trace op is a no-op.
        self.trace = None
        self.span = 0

    def cancelled(self) -> bool:
        if self.probe is None:
            return False
        try:
            return bool(self.probe())
        except Exception:
            # A broken probe must not take down the loop — treat as live.
            return False


class _Row:
    __slots__ = (
        "item", "index", "request", "prompt_tokens", "prompt_ids",
        "trace", "span",
    )

    def __init__(
        self, item: _Item, index: int, request, prompt_ids: List[Any]
    ):
        self.item = item
        self.index = index
        self.request = request
        #: Tokenized prompt (ids on real backends, pseudo-tokens on the
        #: fake one) — page accounting AND the prefix-cache content key.
        self.prompt_ids = prompt_ids
        self.prompt_tokens = max(1, len(prompt_ids))
        self.trace = None
        self.span = 0


class _Slot:
    __slots__ = (
        "idx", "row", "table", "prefilled", "state", "reserved",
        "cached_tokens", "shard",
    )

    def __init__(self, idx: int, row: _Row, reserved: int, shard: int = 0):
        self.idx = idx
        self.row = row
        self.table = BlockTable(idx)
        self.prefilled = 0
        self.state = _PREFILL
        #: Worst-case pages this row may ever need (prompt + max_tokens
        #: minus any cached prefix) — held against the pool so a resident
        #: row can always decode to completion without preemption.
        self.reserved = reserved
        #: Prompt tokens adopted from the prefix cache (page-aligned) —
        #: their prefill chunks are skipped entirely.
        self.cached_tokens = 0
        #: Data-parallel shard this slot lives on (mesh mode): its pages
        #: come from ``pools[shard]`` and its prefix hits from that shard's
        #: cache — pages never cross dp replicas.
        self.shard = shard


class DecodeEngine:
    """Iteration-loop scheduler over ``n_slots`` slots and one page pool."""

    def __init__(
        self,
        inner,
        *,
        slots: int = DEFAULT_SLOTS,
        page_size: int = DEFAULT_PAGE_SIZE,
        num_pages: Optional[int] = None,
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        min_fill: Optional[int] = None,
        registry: Optional[Registry] = None,
        cancelled_counter=None,
        auto_start: bool = True,
        prefix_cache: bool = False,
        prefix_cache_pages: Optional[int] = None,
        mesh: Optional[Any] = None,
        watchdog_timeout_s: Optional[float] = None,
        decode_steps: Optional[int] = None,
        speculative: bool = False,
    ):
        self.inner = inner
        self.n_slots = max(1, int(slots))
        #: Multi-token decode: decode up to K tokens per
        #: inner dispatch through the backend's ``generate_stream`` seam
        #: instead of one blocking ``generate`` per cohort.  ``None`` (the
        #: default) preserves the per-cohort blocking path byte-for-byte;
        #: backends without a stream seam silently fall back to it.  The
        #: per-cohort clamp the option promises is a PER-ROW MASK, not a
        #: shorter program: rows whose remaining budget is under K freeze
        #: mid-scan (they write only the sink page and emit pads), so one
        #: compiled K-step program serves every budget mix.
        self.decode_steps = (
            max(1, int(decode_steps)) if decode_steps is not None else None
        )
        #: Engine-native speculative decoding: each decode window drafts K
        #: tokens per row (n-gram self-draft) and verifies them in ONE
        #: dispatch of ``paged_verify_steps``, emitting ``1 + accepted`` real
        #: tokens instead of 1.  Off by default (the plain
        #: ``paged_decode_steps`` path is untouched); on, the sampled tokens
        #: replay the sequential key schedule exactly, so results equal the
        #: plain windows up to the verify forward's numerics.  Requires
        #: ``decode_steps`` (the draft window IS the decode window); backends
        #: without the stream seam fall back like plain multi-token decode.
        self.speculative = bool(speculative)
        if self.speculative and self.decode_steps is None:
            # Speculative alone implies a default K, so
            # ``{"speculative": true}`` works.
            self.decode_steps = 4
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self._stream_spec_seen = (0, 0)
        self._stream: Optional[Any] = None
        self._stream_slots: List[Optional["_Slot"]] = []
        # Mesh mode: ``mesh`` is a {'dp': N, 'tp': M} dict, a "dp=4,tp=2"
        # string, or a MeshPlan.  Left unset, the engine inherits the inner
        # backend's mesh.  Slots and page pools partition over the dp
        # shards; tp lives inside the backend's model (each rank's pages
        # hold its kv heads under one page table), so the engine records
        # it.  Over a backend with no mesh of its own (the fake backend)
        # both are bookkeeping only, as in the JAX engine.
        if mesh is None:
            mesh = getattr(inner, "mesh", None) or getattr(inner, "mesh_plan", None)
        if mesh is not None:
            mesh = parse_mesh_spec(mesh)
        self.mesh_dp = int(mesh["dp"]) if mesh else 1
        self.mesh_tp = int(mesh["tp"]) if mesh else 1
        #: Whether the inner backend runs each slot's rows on its shard's
        #: card: it then receives every row's shard, so that a shard's pool
        #: books the KV that lives on that card.
        self._shard_rows = self.mesh_dp > 1 and getattr(inner, "mesh_plan", None) is not None
        if num_pages is None:
            suggest = getattr(inner, "suggest_kv_page_pool", None)
            num_pages = (
                suggest(page_size) if callable(suggest) else DEFAULT_NUM_PAGES
            )
        #: One page pool PER data-parallel shard (one here).  Pages never
        #: migrate between shards — a slot's block table names pages of its
        #: own shard's pool only.
        self.pools: List[PagePool] = [
            PagePool(int(num_pages), page_size) for _ in range(self.mesh_dp)
        ]
        self.pool = self.pools[0]  # dp=1 alias; shard-0 pool under a mesh
        #: Cross-request prefix KV reuse: completed
        #: prompts donate their page-aligned prefix pages to a
        #: content-addressed LRU; admission adopts the longest cached
        #: prefix and skips its prefill chunks entirely.  The budget
        #: defaults to a quarter of the pool — the share
        #: ``suggest_kv_page_pool`` already reserves headroom for.
        #: Mesh mode keeps one cache PER dp shard (cached pages live in a
        #: shard's pool and cannot be adopted across shards); the identity
        #: already carries the backend's tp width via kv_cache_identity, so
        #: tp=1 and tp=2 content keys never alias.
        self.prefix_caches: List[Optional[PrefixCache]] = [
            None for _ in range(self.mesh_dp)
        ]
        if prefix_cache:
            identity_fn = getattr(inner, "kv_cache_identity", None)
            identity = (
                identity_fn() if callable(identity_fn)
                else (getattr(inner, "name", type(inner).__name__),)
            )
            budget = (
                int(prefix_cache_pages)
                if prefix_cache_pages is not None
                else max(1, self.pool.num_pages // 4)
            )
            self.prefix_caches = [
                PrefixCache(pool, budget, identity=identity)
                for pool in self.pools
            ]
        self.prefix_cache = self.prefix_caches[0]
        self.prefill_chunk = max(1, int(prefill_chunk))
        #: Decode dispatch heuristic: with prefills still in progress, hold
        #: the cohort until at least this many slots are ready — avoids
        #: fragmenting into narrow cohorts while prompts trickle in.  Once
        #: nothing is mid-prefill the cohort dispatches at any width, so
        #: progress is guaranteed (every iteration advances every prefill
        #: by a chunk).
        self.min_fill = (
            max(1, self.n_slots // 2) if min_fill is None else max(1, min_fill)
        )

        reg = registry if registry is not None else get_registry()
        self._m_occupancy = reg.gauge(
            "engine_slot_occupancy",
            "Occupied fraction of the decode engine's slot table at the "
            "latest iteration.",
        )
        self._m_mesh_dp = reg.gauge(
            "engine_mesh_dp",
            "Data-parallel width of the mesh this engine partitions its "
            "slots and page pools over (1 = single device).",
        )
        self._m_mesh_tp = reg.gauge(
            "engine_mesh_tp",
            "Tensor-parallel width of the mesh under this engine's inner "
            "backend (1 = unsharded params).",
        )
        self._m_mesh_dp.set(self.mesh_dp)
        self._m_mesh_tp.set(self.mesh_tp)
        self._m_tokens_iter = reg.histogram(
            "engine_tokens_per_iteration",
            "Generated tokens retired per decode-cohort iteration.",
            buckets=DEFAULT_COUNT_BUCKETS,
        )
        self._m_pages = reg.histogram(
            "kv_pages_in_use",
            "KV pages allocated from the engine's fixed page pool, sampled "
            "at each decode dispatch.",
            buckets=DEFAULT_COUNT_BUCKETS,
        )
        self._m_admitted = reg.counter(
            "engine_admitted_total",
            "Generate rows admitted into decode-engine slots.",
        )
        self._m_evicted = reg.counter(
            "engine_evicted_total",
            "Resident rows evicted before completion (cancellation or "
            "sibling-row failure); their KV pages return to the pool.",
        )
        self._m_prefill_chunks = reg.counter(
            "engine_prefill_chunks_total",
            "Prompt chunks ingested by interleaved chunked prefill.",
        )
        self._m_prefill_tokens = reg.counter(
            "engine_prefill_tokens_total",
            "Prompt tokens actually ingested by chunked prefill "
            "(prefix-cache hits skip theirs, so this is the honest "
            "prefill-work series).",
        )
        self._m_prefix_hits = reg.counter(
            "prefix_cache_hits_total",
            "Admissions that adopted a cached page-aligned prompt prefix.",
        )
        self._m_prefix_misses = reg.counter(
            "prefix_cache_misses_total",
            "Admissions that found no cached prefix.",
        )
        self._m_prefix_evictions = reg.counter(
            "prefix_cache_evictions_total",
            "Prefix-cache entries evicted by the LRU page budget.",
        )
        self._m_prefix_inserted = reg.counter(
            "prefix_cache_inserted_pages_total",
            "KV pages donated to the prefix cache by retiring prompts.",
        )
        self._m_prefix_saved = reg.counter(
            "prefix_tokens_saved_total",
            "Prompt tokens whose prefill was skipped via a cached prefix.",
        )
        self._m_score_dedup = reg.counter(
            "engine_score_dedup_total",
            "Duplicate score rows removed from merged dispatches — "
            "identical (prompt, continuation) rows in one flush are "
            "computed once and fanned back out.",
        )
        self._m_watchdog_trips = reg.counter(
            "engine_watchdog_trips_total",
            "Hang-watchdog trips: a dispatched inner-backend call made no "
            "progress for watchdog_timeout_s, so the engine latched "
            "backend_lost (the silent-hang -> recoverable-loss conversion).",
        )
        self._m_heartbeat_age = reg.gauge(
            "engine_heartbeat_age_s",
            "Seconds since the decode engine's iteration loop last proved "
            "liveness (sampled by the watchdog monitor thread).",
        )
        self._m_mfu_device = reg.gauge(
            "engine_mfu_device_fraction",
            "Fraction of engine wall time spent inside inner-backend device "
            "dispatches (iteration-ledger aggregate).",
        )
        self._m_mfu_host = reg.gauge(
            "engine_mfu_host_fraction",
            "Fraction of engine wall time spent in host-side iteration "
            "bookkeeping (sweep/admit/prefill/cohort/merge/other) — the "
            "per-iteration host round-trip loss.",
        )
        self._m_mfu_idle = reg.gauge(
            "engine_mfu_idle_fraction",
            "Fraction of engine wall time spent idle between iterations.",
        )
        self._m_tokens_dispatch = reg.histogram(
            "engine_tokens_per_dispatch",
            "Generated tokens returned by one device dispatch (one K-step "
            "multi-token window in stream mode; one whole cohort generate "
            "in the legacy blocking path).",
            buckets=DEFAULT_COUNT_BUCKETS,
        )
        self._m_host_iter_per_token = reg.gauge(
            "engine_host_iterations_per_token",
            "Engine iterations per generated token (ledger aggregate): 1.0 "
            "means one host round-trip per token; decode_steps=K drives "
            "this toward 1/K on decode-bound load.",
        )
        #: Queued-call cancellations share the batching adapter's counter
        #: family so dashboards keep one cancellation series.
        self._cancelled_counter = cancelled_counter

        #: Inner-backend dispatches per kind — the adapter aliases its
        #: ``batch_counts`` to this dict so serve stats keep working.
        self.dispatch_counts = {
            "generate": 0, "score": 0, "next_token": 0, "embed": 0,
            "score_matrix": 0,
        }
        #: Decode-window accounting: one "window" is one device dispatch
        #: that can retire up to ``decode_steps`` tokens per row (a legacy
        #: blocking generate counts as one window).  tokens/windows is the
        #: per-dispatch amortization the multi-token path exists to raise.
        self.decode_windows = 0
        self.decoded_tokens = 0

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._gen_backlog: List[_Row] = []
        self._other: Dict[str, List[_Item]] = {
            "score": [], "next_token": [], "embed": [], "score_matrix": [],
        }
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        #: Per-dp-shard page reservations (index = shard); the legacy
        #: single-pool figure is the sum.
        self._reserved: List[int] = [0] * self.mesh_dp
        self._stopped = False
        #: Latched when a dispatch raises BackendLostError: the device under
        #: this engine is gone for good (BackendLostError is sticky by
        #: contract).  Fleet replica health checks read this directly — a
        #: plain bool read, no lock — as the passive loss signal.
        self.backend_lost = False
        #: Hang watchdog (the one failure mode the fault taxonomy cannot
        #: raise its way out of): ``run_iteration`` stamps a heartbeat and
        #: marks the lock-free dispatch window busy; a monitor thread trips
        #: when a dispatch has been in flight for ``watchdog_timeout_s``
        #: without returning, latching ``backend_lost`` so the fleet health
        #: ladder (and ReplicaManager respawn) treat the wedge exactly like
        #: a device loss.  ``wedged`` records that the loss came from the
        #: watchdog, not an exception.
        self.watchdog_timeout_s = (
            float(watchdog_timeout_s) if watchdog_timeout_s else None
        )
        self.wedged = False
        self.watchdog_trips = 0
        self._busy_since: Optional[float] = None
        self._heartbeat = time.monotonic()
        self._watchdog_stop = threading.Event()
        self._watchdog_thread: Optional[threading.Thread] = None
        self.iterations = 0
        self._occ_sum = 0.0
        self._occ_iters = 0
        self._search_sessions = 0
        self._search_slots = 0
        #: Iteration ledger: per-iteration wall time
        #: split into host phases / device dispatch / idle, aggregated into
        #: stats()["mfu_attribution"].  The accumulators below are touched
        #: only by the iteration thread (or the test thread stepping
        #: run_iteration) — no lock needed.
        self.ledger = IterationLedger()
        self._last_iter_end: Optional[float] = None
        #: Device-time split: ``dispatch_s`` is host
        #: time spent ENQUEUEING device work (stream window launches),
        #: ``block_s`` is time spent WAITING on device results (collect /
        #: blocking inner calls).  On CPU backends the device runs
        #: host-synchronously, so block_s absorbs device compute — the
        #: caveat is stamped into ``mfu_attribution`` output itself.
        self._iter_dispatch_s = 0.0
        self._iter_block_s = 0.0
        self._iter_merge_s = 0.0
        self._iter_tokens = 0
        self._iter_spec_proposed = 0
        self._iter_spec_accepted = 0

        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self._thread = threading.Thread(
                target=self._loop, name="decode-engine", daemon=True
            )
            self._thread.start()
        # The monitor runs whenever a timeout is configured — including
        # auto_start=False test engines stepped via run_iteration().
        if self.watchdog_timeout_s:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="engine-watchdog",
                daemon=True,
            )
            self._watchdog_thread.start()

    # -- public ------------------------------------------------------------

    def submit(
        self, kind: str, requests: Sequence[Any], probe: Optional[Callable] = None
    ):
        """Enqueue one call and block until the loop retires it."""
        item = _Item(kind, list(requests), probe)
        active = trace_current()
        if active is not None:
            trace, parent = active
            item.trace = trace
            item.span = trace.begin(
                f"engine_{kind}", parent=parent, rows=len(item.requests))
        with self._work:
            if self._stopped:
                raise RuntimeError("decode engine is closed")
            if kind == "generate":
                for i, req in enumerate(item.requests):
                    row = _Row(item, i, req, self._prompt_token_ids(req))
                    if item.trace is not None:
                        row.trace = item.trace
                        row.span = item.trace.begin(
                            "engine_row", parent=item.span, row=i)
                    self._gen_backlog.append(row)
            else:
                self._other[kind].append(item)
            self._work.notify_all()
        item.event.wait()
        if item.trace is not None:
            item.trace.end(
                item.span,
                outcome="error" if item.error is not None else "ok")
        if item.error is not None:
            raise item.error
        return item.result

    @staticmethod
    def _trace_row_event(row: _Row, name: str, **attrs: Any) -> None:
        if row.trace is not None:
            row.trace.event(row.span, name, **attrs)

    @staticmethod
    def _trace_row_end(row: _Row, **attrs: Any) -> None:
        if row.trace is not None:
            row.trace.end(row.span, **attrs)

    def close(self) -> None:
        with self._work:
            self._stopped = True
            self._work.notify_all()
        self._watchdog_stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if (
            self._watchdog_thread is not None
            and self._watchdog_thread.is_alive()
        ):
            self._watchdog_thread.join(timeout=1.0)

    def track_session(self, session, spec):
        """Seam for ``open_token_search``: fused sessions bypass the request
        queue (their steps are already single fused programs), but their
        slot footprint still belongs on the engine's pressure surface —
        /healthz shows them next to slot occupancy."""
        with self._lock:
            self._search_sessions += 1
            self._search_slots += spec.n_slots
        orig_close = session.close

        def close():
            with self._lock:
                self._search_sessions -= 1
                self._search_slots -= spec.n_slots
            orig_close()

        session.close = close
        return session

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            occupied = sum(1 for s in self._slots if s is not None)
            pools = [pool.stats() for pool in self.pools]
            shard_occupied = [0] * self.mesh_dp
            for s in self._slots:
                if s is not None:
                    shard_occupied[s.shard] += 1
            if self.prefix_cache is not None:
                # Aggregate the per-shard caches into one legacy-shaped
                # block (counters sum; rates recompute from the sums).
                cache_stats = [c.stats() for c in self.prefix_caches]
                agg = {
                    key: sum(cs[key] for cs in cache_stats)
                    for key in (
                        "entries", "pages", "max_pages", "hits", "misses",
                        "evictions", "inserted_pages", "tokens_saved",
                    )
                }
                total = agg["hits"] + agg["misses"]
                agg["hit_rate"] = (agg["hits"] / total) if total else 0.0
                prefix_block: Dict[str, Any] = {"enabled": True, **agg}
            else:
                prefix_block = {"enabled": False}
            return {
                "slots": self.n_slots,
                "slots_occupied": occupied,
                "slot_occupancy": occupied / self.n_slots,
                "slot_occupancy_mean": (
                    self._occ_sum / self._occ_iters if self._occ_iters else 0.0
                ),
                "iterations": self.iterations,
                "queue_depth": len(self._gen_backlog)
                + sum(len(q) for q in self._other.values()),
                # Aggregates across every dp shard's pool (dp=1 == the
                # single legacy pool, unchanged numbers).
                "kv_pages": sum(p.num_pages for p in pools),
                "kv_page_size": pools[0].page_size,
                "kv_pages_in_use": sum(p.pages_in_use for p in pools),
                "kv_pages_reserved": sum(self._reserved),
                "kv_pages_high_water": sum(p.high_water for p in pools),
                # Fraction of the page pool not in use or reserved — the
                # capacity signal the kv_headroom SLO (obs/slo.py) watches.
                "kv_page_headroom": round(
                    max(
                        0.0,
                        1.0
                        - (
                            sum(p.pages_in_use for p in pools)
                            + sum(self._reserved)
                        )
                        / max(1, sum(p.num_pages for p in pools)),
                    ),
                    4,
                ),
                "fused_search_sessions": self._search_sessions,
                "fused_search_slots": self._search_slots,
                "decode_steps": self.decode_steps,
                "stream_active": self._stream is not None,
                "decode_windows": self.decode_windows,
                "decoded_tokens": self.decoded_tokens,
                "tokens_per_dispatch_mean": (
                    self.decoded_tokens / self.decode_windows
                    if self.decode_windows else 0.0
                ),
                "speculative": {
                    "enabled": self.speculative,
                    "proposed_tokens": self.spec_proposed_tokens,
                    "accepted_tokens": self.spec_accepted_tokens,
                    # Mean draft tokens accepted per device dispatch — each
                    # window emits 1 + accepted real tokens, so anything > 0
                    # is throughput past the fixed-K floor.
                    "accepted_tokens_per_dispatch": (
                        self.spec_accepted_tokens / self.decode_windows
                        if self.decode_windows else 0.0
                    ),
                    "draft_acceptance_rate": (
                        self.spec_accepted_tokens / self.spec_proposed_tokens
                        if self.spec_proposed_tokens else 0.0
                    ),
                },
                "backend_lost": self.backend_lost,
                "mfu_attribution": self.ledger.mfu_attribution(),
                "watchdog": {
                    "enabled": self.watchdog_timeout_s is not None,
                    "timeout_s": self.watchdog_timeout_s,
                    "heartbeat_age_s": round(
                        max(0.0, time.monotonic() - self._heartbeat), 4
                    ),
                    "wedged": self.wedged,
                    "trips": self.watchdog_trips,
                },
                "prefix_cache": prefix_block,
                "mesh": {
                    "dp": self.mesh_dp,
                    "tp": self.mesh_tp,
                    "per_shard": [
                        {
                            "slots_occupied": shard_occupied[i],
                            "kv_pages_in_use": pools[i].pages_in_use,
                            "kv_pages_reserved": self._reserved[i],
                        }
                        for i in range(self.mesh_dp)
                    ],
                },
            }

    # -- loop --------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._work:
                while not self._stopped and not self._has_work():
                    self._work.wait()
                if self._stopped:
                    self._fail_all(RuntimeError("decode engine closed"))
                    return
            try:
                self.run_iteration()
            except Exception as exc:  # pragma: no cover - loop must survive
                with self._work:
                    self._fail_all(exc)

    def _has_work(self) -> bool:
        return (
            bool(self._gen_backlog)
            or any(self._other.values())
            or any(s is not None for s in self._slots)
        )

    def _fail_all(self, exc: BaseException) -> None:
        """Stop-path cleanup (lock held): fail every queued/resident item."""
        if self._stream is not None:
            stream = self._stream
            self._stream, self._stream_slots = None, []
            close = getattr(stream, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    pass
        for row in self._gen_backlog:
            self._fail_item(row.item, exc)
        self._gen_backlog = []
        for slot in list(self._slots):
            if slot is not None:
                self._evict(slot, count=False)
                self._fail_item(slot.row.item, exc)
        for queue in self._other.values():
            for item in queue:
                self._fail_item(item, exc)
            queue.clear()

    def run_iteration(self) -> None:
        """One scheduler iteration.  Public so tests can step the engine
        deterministically (construct with ``auto_start=False``)."""
        self._heartbeat = time.monotonic()
        t_start = time.perf_counter()
        idle_s = (
            max(0.0, t_start - self._last_iter_end)
            if self._last_iter_end is not None else 0.0
        )
        self._iter_dispatch_s = 0.0
        self._iter_block_s = 0.0
        self._iter_merge_s = 0.0
        self._iter_tokens = 0
        self._iter_spec_proposed = 0
        self._iter_spec_accepted = 0
        with self._lock:
            t0 = time.perf_counter()
            self._process_cancellations()
            t1 = time.perf_counter()
            self._admit()
            t2 = time.perf_counter()
            self._advance_prefill()
            t3 = time.perf_counter()
            cohort = self._decode_cohort()
            t4 = time.perf_counter()
            occupied = sum(1 for s in self._slots if s is not None)
            occ = occupied / self.n_slots
            self._m_occupancy.set(occ)
            if occupied:
                self._occ_sum += occ
                self._occ_iters += 1
            self.iterations += 1
            queue_depth = len(self._gen_backlog) + sum(
                len(q) for q in self._other.values()
            )
            pages_in_use = sum(pool.in_use for pool in self.pools)
            others = {
                kind: queue[:] for kind, queue in self._other.items() if queue
            }
            for kind in others:
                self._other[kind] = []

        # Inner-backend calls run WITHOUT the lock: submitters keep
        # enqueueing while the device is busy, so the next iteration's
        # cohort and merged kind-batches widen for free (the same overlap
        # the legacy flush got from releasing its lock mid-dispatch).
        # The busy window brackets exactly the calls that can silently
        # wedge — a dispatch that never returns leaves ``_busy_since`` set
        # and the watchdog converts the stall into ``backend_lost``.
        # Stream mode: while a multi-token stream is in flight, the device
        # already holds a dispatched K-step window (launched LAST iteration,
        # after that iteration's host phases) — the sweep/admit/prefill
        # block above just ran CONCURRENTLY with it (CUDA launches are
        # asynchronous).  ``_advance_stream`` now collects that window's tokens
        # (the only blocking point), retires finished rows, and launches
        # the next window before returning: D2H retirement and H2D
        # admission double-buffer against device compute.
        stream_active = self._stream is not None
        if cohort or others or stream_active:
            self._busy_since = time.monotonic()
        try:
            if stream_active:
                self._advance_stream()
            elif cohort:
                self._dispatch_decode(cohort)
            for kind, items in others.items():
                self._dispatch_other(kind, items)
        finally:
            self._busy_since = None
            self._heartbeat = time.monotonic()
            t_end = time.perf_counter()
            row = self.ledger.record(
                start_s=t_start,
                end_s=t_end,
                idle_s=idle_s,
                dispatch_s=self._iter_dispatch_s,
                block_s=self._iter_block_s,
                host={
                    "sweep": t1 - t0,
                    "admit": t2 - t1,
                    "prefill": t3 - t2,
                    "cohort": t4 - t3,
                    "merge": self._iter_merge_s,
                },
                tokens=self._iter_tokens,
                cohort=len(cohort),
                queue_depth=queue_depth,
                pages_in_use=pages_in_use,
                spec_proposed=self._iter_spec_proposed,
                spec_accepted=self._iter_spec_accepted,
            )
            self._last_iter_end = t_end
            get_flight_recorder().record_iteration(row)
            mfu = self.ledger.mfu_attribution()
            self._m_mfu_device.set(mfu["device_fraction"])
            self._m_mfu_host.set(mfu["host_fraction"])
            self._m_mfu_idle.set(mfu["idle_fraction"])
            if mfu["tokens"]:
                self._m_host_iter_per_token.set(
                    self.iterations / mfu["tokens"]
                )

    def _watchdog_loop(self) -> None:
        """Monitor thread: trip when a dispatched inner call has made no
        progress for ``watchdog_timeout_s``.  Idle engines never trip —
        staleness only counts while the busy window is open, so a quiet
        fleet replica is indistinguishable from a healthy one."""
        interval = max(0.01, self.watchdog_timeout_s / 4.0)
        while not self._watchdog_stop.wait(interval):
            now = time.monotonic()
            self._m_heartbeat_age.set(max(0.0, now - self._heartbeat))
            busy = self._busy_since
            if (
                not self.wedged
                and busy is not None
                and now - busy > self.watchdog_timeout_s
            ):
                self.wedged = True
                self.backend_lost = True
                self.watchdog_trips += 1
                self._m_watchdog_trips.inc()
                recorder = get_flight_recorder()
                recorder.record_event(
                    "watchdog_trip",
                    timeout_s=self.watchdog_timeout_s,
                    busy_s=round(now - busy, 3),
                    iterations=self.iterations,
                )
                recorder.dump("watchdog_trip")

    # -- iteration phases (lock held) ---------------------------------------

    def _process_cancellations(self) -> None:
        cancelled_items = set()
        keep: List[_Row] = []
        for row in self._gen_backlog:
            if row.item.failed or row.item in cancelled_items or row.item.cancelled():
                cancelled_items.add(row.item)
            else:
                keep.append(row)
        self._gen_backlog = keep
        for slot in list(self._slots):
            if slot is None:
                continue
            item = slot.row.item
            if item.failed or item in cancelled_items or item.cancelled():
                cancelled_items.add(item)
                self._evict(slot)
        for kind, queue in self._other.items():
            live: List[_Item] = []
            for item in queue:
                if item.cancelled():
                    if self._cancelled_counter is not None:
                        self._cancelled_counter.labels(kind).inc()
                    self._fail_item(
                        item,
                        RequestCancelled(
                            f"session cancelled before its {kind} call ran"
                        ),
                    )
                else:
                    live.append(item)
            self._other[kind] = live
        for item in cancelled_items:
            if self._cancelled_counter is not None and not item.failed:
                self._cancelled_counter.labels("generate").inc()
            self._fail_item(
                item,
                RequestCancelled(
                    "session cancelled; its resident rows were evicted and "
                    "their KV pages freed"
                ),
            )

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        occupied = [0] * self.mesh_dp
        for s in self._slots:
            if s is not None:
                occupied[s.shard] += 1
        while free and self._gen_backlog:
            row = self._gen_backlog[0]
            if row.item.failed:
                self._gen_backlog.pop(0)
                continue
            needed = self.pool.pages_for_tokens(
                row.prompt_tokens + int(getattr(row.request, "max_tokens", 0))
            )
            if needed > self.pool.num_pages:
                self._gen_backlog.pop(0)
                self._reject_oversized(row, needed)
                continue
            # Balanced admission: among free slots whose dp shard still has
            # reservation headroom, take the one on the least-loaded shard
            # (fewest resident rows, then fewest reserved pages, then lowest
            # slot index — which at dp=1 is exactly the legacy FIFO pick).
            best = None
            best_key = None
            for slot_idx in free:
                shard = slot_idx % self.mesh_dp
                if self._reserved[shard] + needed > self.pool.num_pages:
                    continue
                key = (occupied[shard], self._reserved[shard], slot_idx)
                if best_key is None or key < best_key:
                    best, best_key = slot_idx, key
            if best is None:
                # Fits a pool but not right now — hold FIFO order and wait
                # for resident rows to retire.
                break
            self._gen_backlog.pop(0)
            free.remove(best)
            shard = best % self.mesh_dp
            pool = self.pools[shard]
            cache = self.prefix_caches[shard]
            cached_pages: List[int] = []
            cached_tokens = 0
            if cache is not None:
                cached_pages, cached_tokens = cache.lookup(row.prompt_ids)
                if cached_tokens:
                    self._m_prefix_hits.inc()
                    self._m_prefix_saved.inc(cached_tokens)
                else:
                    self._m_prefix_misses.inc()
            # Shared pages come off the cache, not the free list — only the
            # private remainder counts against the reservation.
            slot = _Slot(
                best, row, reserved=needed - len(cached_pages), shard=shard
            )
            if cached_tokens:
                slot.table.adopt_shared(pool, cached_pages, cached_tokens)
                slot.prefilled = cached_tokens
                slot.cached_tokens = cached_tokens
                if slot.prefilled >= row.prompt_tokens:
                    slot.state = _READY
            self._slots[slot.idx] = slot
            self._reserved[shard] += slot.reserved
            occupied[shard] += 1
            self._m_admitted.inc()
            self._trace_row_event(
                row, "slot_admitted", slot=slot.idx, shard=shard,
                cached_tokens=cached_tokens)
            if slot.state == _READY:
                self._trace_row_event(row, "prefill_complete", cached=True)

    def _advance_prefill(self) -> None:
        for slot in self._slots:
            if slot is None or slot.state != _PREFILL:
                continue
            remaining = slot.row.prompt_tokens - slot.prefilled
            chunk = min(self.prefill_chunk, remaining)
            if chunk > 0:
                # Reservation guarantees the pool has room.
                slot.table.append_tokens(self.pools[slot.shard], chunk)
                slot.prefilled += chunk
                self._m_prefill_chunks.inc()
                self._m_prefill_tokens.inc(chunk)
                self._trace_row_event(slot.row, "prefill_chunk", tokens=chunk)
            if slot.prefilled >= slot.row.prompt_tokens:
                slot.state = _READY
                self._trace_row_event(slot.row, "prefill_complete")

    def _decode_cohort(self) -> List[_Slot]:
        # One multi-token stream in flight at a time: newly-ready slots
        # keep prefilling/waiting and form the NEXT cohort when the
        # current stream drains (admission still overlaps device decode —
        # that is the double-buffering, not a second stream).
        if self._stream is not None:
            return []
        ready = [s for s in self._slots if s is not None and s.state == _READY]
        prefilling = any(
            s is not None and s.state == _PREFILL for s in self._slots
        )
        if not ready or (prefilling and len(ready) < self.min_fill):
            return []
        for slot in ready:
            # Generated-token pages, allocated up front (the reservation
            # made at admission covers them); retired below with the slot.
            slot.table.append_tokens(
                self.pools[slot.shard],
                int(getattr(slot.row.request, "max_tokens", 0)),
            )
        self._m_pages.observe(sum(pool.in_use for pool in self.pools))
        return ready

    # -- dispatch (lock released) -------------------------------------------

    def _dispatch_decode(self, cohort: List[_Slot]) -> None:
        if self.decode_steps is not None and callable(
            getattr(self.inner, "generate_stream", None)
        ):
            self._open_stream(cohort)
            return
        requests = [slot.row.request for slot in cohort]
        self.dispatch_counts["generate"] += 1
        for slot in cohort:
            self._trace_row_event(
                slot.row, "decode_dispatch", cohort=len(cohort))
        results: Optional[List[Any]] = None
        row_errors: Dict[int, BaseException] = {}
        batch_error: Optional[BaseException] = None
        t_dev = time.perf_counter()
        try:
            if self._shard_rows:
                results = self.inner.generate(
                    requests, shards=[slot.shard for slot in cohort]
                )
            else:
                results = self.inner.generate(requests)
        except PartialBatchError as exc:
            results = list(exc.results)
            row_errors = dict(exc.row_errors)
        except Exception as exc:
            batch_error = exc
            if isinstance(exc, BackendLostError):
                self.backend_lost = True
        # A blocking inner call IS a wait on device results.
        self._iter_block_s += time.perf_counter() - t_dev

        t_merge = time.perf_counter()
        with self._lock:
            tokens = 0
            for i, slot in enumerate(cohort):
                self._retire(slot)
                item = slot.row.item
                if batch_error is not None:
                    self._trace_row_end(slot.row, outcome="error")
                    self._fail_item(item, batch_error)
                elif i in row_errors:
                    self._trace_row_end(slot.row, outcome="error")
                    self._record_row(item, slot.row.index, None, row_errors[i])
                else:
                    result = results[i]
                    ids = getattr(result, "token_ids", None) or ()
                    row_tokens = len(ids) if ids else self._count_text_tokens(
                        getattr(result, "text", "") or ""
                    )
                    tokens += row_tokens
                    self._trace_row_end(
                        slot.row, outcome="retired", tokens=row_tokens)
                    self._record_row(item, slot.row.index, result, None)
            self._iter_tokens += tokens
            self._m_tokens_iter.observe(tokens)
            self._m_tokens_dispatch.observe(tokens)
            self.decode_windows += 1
            self.decoded_tokens += tokens
            self._work.notify_all()
        self._iter_merge_s += time.perf_counter() - t_merge

    # -- multi-token stream dispatch (lock released) --------------------------

    def _open_stream(self, cohort: List[_Slot]) -> None:
        """Start a K-step decode stream for this cohort: the inner backend
        prefills the cohort and launches the FIRST K-step window; the call
        returns as soon as the window is enqueued (asynchronous CUDA launches), so
        the next iteration's host phases run while the device decodes."""
        requests = [slot.row.request for slot in cohort]
        self.dispatch_counts["generate"] += 1
        for slot in cohort:
            self._trace_row_event(
                slot.row, "decode_dispatch", cohort=len(cohort),
                decode_steps=self.decode_steps)
        t_disp = time.perf_counter()
        try:
            kwargs = {"shards": [slot.shard for slot in cohort]} if self._shard_rows else {}
            if self.speculative:
                stream = self.inner.generate_stream(
                    requests, decode_steps=self.decode_steps,
                    speculative=True, **kwargs,
                )
            else:
                stream = self.inner.generate_stream(
                    requests, decode_steps=self.decode_steps, **kwargs
                )
            stream.dispatch()
        except Exception as exc:
            self._iter_dispatch_s += time.perf_counter() - t_disp
            if isinstance(exc, BackendLostError):
                self.backend_lost = True
            t_merge = time.perf_counter()
            with self._lock:
                for slot in cohort:
                    self._retire(slot)
                    self._trace_row_end(slot.row, outcome="error")
                    self._fail_item(slot.row.item, exc)
                self._work.notify_all()
            self._iter_merge_s += time.perf_counter() - t_merge
            return
        self._iter_dispatch_s += time.perf_counter() - t_disp
        self._stream = stream
        self._stream_slots = list(cohort)
        self._stream_spec_seen = (0, 0)

    def _advance_stream(self) -> None:
        """Collect the in-flight K-step window (the only point that blocks
        on the device), retire rows that finished inside it, then launch
        the next window — or drain the stream when every row is done."""
        stream = self._stream
        t_block = time.perf_counter()
        try:
            row_tokens, finished = stream.collect()
        except Exception as exc:
            self._iter_block_s += time.perf_counter() - t_block
            if isinstance(exc, BackendLostError):
                self.backend_lost = True
            self._close_stream(error=exc)
            return
        self._iter_block_s += time.perf_counter() - t_block

        # Draft accounting: the stream's cumulative counters advance at
        # dispatch (proposed) and collect (accepted); the delta since the
        # last read is this window's contribution.
        spec_proposed = int(getattr(stream, "spec_proposed", 0) or 0)
        spec_accepted = int(getattr(stream, "spec_accepted", 0) or 0)
        seen_p, seen_a = self._stream_spec_seen
        self._stream_spec_seen = (spec_proposed, spec_accepted)
        self._iter_spec_proposed += spec_proposed - seen_p
        self._iter_spec_accepted += spec_accepted - seen_a

        t_merge = time.perf_counter()
        with self._lock:
            tokens = sum(row_tokens)
            self._iter_tokens += tokens
            self._m_tokens_iter.observe(tokens)
            self._m_tokens_dispatch.observe(tokens)
            self.decode_windows += 1
            self.decoded_tokens += tokens
            self.spec_proposed_tokens += spec_proposed - seen_p
            self.spec_accepted_tokens += spec_accepted - seen_a
            for i, result in finished.items():
                slot = self._stream_slots[i]
                if slot is None:
                    continue
                self._stream_slots[i] = None
                if self._slots[slot.idx] is not slot:
                    # Evicted mid-stream (cancellation sweep); the stream
                    # kept masking the row on device — drop its result.
                    continue
                self._retire(slot)
                ids = getattr(result, "token_ids", None) or ()
                n_ids = len(ids) if ids else self._count_text_tokens(
                    getattr(result, "text", "") or ""
                )
                self._trace_row_end(
                    slot.row, outcome="retired", tokens=n_ids)
                self._record_row(slot.row.item, slot.row.index, result, None)
            self._work.notify_all()
        self._iter_merge_s += time.perf_counter() - t_merge

        if stream.finished:
            self._stream = None
            self._stream_slots = []
            close = getattr(stream, "close", None)
            if callable(close):
                close()
            return
        t_disp = time.perf_counter()
        try:
            stream.dispatch()
        except Exception as exc:
            self._iter_dispatch_s += time.perf_counter() - t_disp
            if isinstance(exc, BackendLostError):
                self.backend_lost = True
            self._close_stream(error=exc)
            return
        self._iter_dispatch_s += time.perf_counter() - t_disp

    def _close_stream(self, error: BaseException) -> None:
        """Tear down a failed stream: every row still riding it fails the
        way a legacy batch error fails its cohort."""
        stream, slots = self._stream, self._stream_slots
        self._stream, self._stream_slots = None, []
        close = getattr(stream, "close", None)
        if callable(close):
            try:
                close()
            except Exception:
                pass
        t_merge = time.perf_counter()
        with self._lock:
            for slot in slots:
                if slot is None or self._slots[slot.idx] is not slot:
                    continue
                self._retire(slot)
                self._trace_row_end(slot.row, outcome="error")
                self._fail_item(slot.row.item, error)
            self._work.notify_all()
        self._iter_merge_s += time.perf_counter() - t_merge

    def _dispatch_other(self, kind: str, items: List[_Item]) -> None:
        fn = {
            "score": self.inner.score,
            "next_token": self.inner.next_token_logprobs,
            "embed": self.inner.embed,
            "score_matrix": self._inner_score_matrix,
        }[kind]
        merged: List[Any] = []
        for item in items:
            merged.extend(item.requests)
        # Identical score rows in one merged dispatch compute once and fan
        # out (beam search re-scores shared prefixes every round; matrix
        # fallbacks repeat agent rows across co-batched sessions).
        mapping: Optional[List[int]] = None
        dispatch = merged
        if kind == "score":
            from consensus_tpu_torch.backends.score_matrix import dedup_score_requests

            unique, mapping = dedup_score_requests(merged)
            if len(unique) < len(merged):
                self._m_score_dedup.inc(len(merged) - len(unique))
            dispatch = unique
        reserved = 0
        if kind == "score_matrix":
            reserved = self._reserve_matrix_pages(merged)
        self.dispatch_counts[kind] += 1
        for item in items:
            if item.trace is not None:
                item.trace.event(
                    item.span, "engine_dispatch", kind=kind,
                    batch=len(dispatch))
        try:
            t_dev = time.perf_counter()
            try:
                results = fn(dispatch)
            finally:
                self._iter_block_s += time.perf_counter() - t_dev
            if mapping is not None:
                from consensus_tpu_torch.backends.score_matrix import expand_deduped

                results = expand_deduped(results, mapping)
            cursor = 0
            for item in items:
                n = len(item.requests)
                item.result = list(results[cursor : cursor + n])
                cursor += n
                item.event.set()
        except PartialBatchError as exc:
            if mapping is not None:
                from consensus_tpu_torch.backends.score_matrix import (
                    expand_partial_error,
                )

                exc = expand_partial_error(exc, mapping)
            cursor = 0
            for item in items:
                n = len(item.requests)
                slice_errors = {
                    i - cursor: err
                    for i, err in exc.row_errors.items()
                    if cursor <= i < cursor + n
                }
                if not slice_errors:
                    item.result = list(exc.results[cursor : cursor + n])
                elif len(slice_errors) == n:
                    item.error = next(iter(slice_errors.values()))
                else:
                    item.error = PartialBatchError(
                        f"{len(slice_errors)}/{n} rows of this session's "
                        f"{kind} call failed inside an engine iteration",
                        results=list(exc.results[cursor : cursor + n]),
                        row_errors=slice_errors,
                    )
                cursor += n
                item.event.set()
        except Exception as exc:
            if isinstance(exc, BackendLostError):
                self.backend_lost = True
            for item in items:
                item.error = exc
                item.event.set()
        with self._lock:
            if reserved:
                self._reserved[0] -= reserved
            self._work.notify_all()

    def _inner_score_matrix(self, requests: List[Any]) -> List[Any]:
        """Route matrix requests to the inner backend's fused path when it
        has one, else the exact per-call fallback (one batched score)."""
        from consensus_tpu_torch.backends.score_matrix import score_matrix_many

        return score_matrix_many(self.inner, requests)

    def _reserve_matrix_pages(self, requests: List[Any]) -> int:
        """Advisory page accounting for a matrix dispatch: the fused path
        allocates its own page pool on the same device, so reserving its
        estimated footprint against shard 0 makes generate admission back
        off instead of OOMing alongside it.  Estimates use the accounting
        tokenizer (never numerics); clamped so a huge matrix cannot wedge
        admission entirely."""
        ps = self.pool.page_size
        pages = 0
        for request in requests:
            cont = [self._count_text_tokens(c) for c in request.candidates]
            max_cont = max(cont, default=0)
            seen = set()
            for agent in request.agents:
                key = (agent.context, agent.system_prompt)
                if key in seen:
                    continue
                seen.add(key)
                n_ctx = self._count_text_tokens(agent.context)
                if agent.system_prompt:
                    n_ctx += self._count_text_tokens(agent.system_prompt)
                pages += n_ctx // ps
            rows = min(len(request.candidates) * len(request.agents), 64)
            pages += rows * ((ps + max_cont) // ps + 1)
        pages = min(pages, self.pool.num_pages // 2)
        if pages:
            with self._lock:
                self._reserved[0] += pages
        return pages

    # -- bookkeeping (lock held) --------------------------------------------

    def _retire(self, slot: _Slot) -> None:
        pool = self.pools[slot.shard]
        cache = self.prefix_caches[slot.shard]
        if cache is not None and slot.prefilled >= slot.row.prompt_tokens:
            # Donate the fully-prefilled, page-aligned prompt prefix before
            # releasing: the cache takes its own reference, so the pages
            # survive this slot's free below.  (Evicted mid-prefill slots
            # hold partial KV — never cacheable.)
            ps = pool.page_size
            n_pages = slot.row.prompt_tokens // ps
            if n_pages > 0:
                before = cache.evictions
                if cache.insert(
                    slot.row.prompt_ids[: n_pages * ps],
                    slot.table.pages[:n_pages],
                ):
                    self._m_prefix_inserted.inc(n_pages)
                self._m_prefix_evictions.inc(cache.evictions - before)
        slot.table.release(pool)
        self._reserved[slot.shard] -= slot.reserved
        self._slots[slot.idx] = None

    def _evict(self, slot: _Slot, count: bool = True) -> None:
        self._retire(slot)
        self._trace_row_end(slot.row, outcome="evicted")
        if count:
            self._m_evicted.inc()

    def _record_row(
        self, item: _Item, index: int, result, error: Optional[BaseException]
    ) -> None:
        if error is None:
            item.row_results[index] = result
        else:
            item.row_errors[index] = error
        item.rows_left -= 1
        if item.rows_left == 0 and not item.failed:
            self._finalize(item)

    def _finalize(self, item: _Item) -> None:
        if not item.row_errors:
            item.result = [
                item.row_results[i] for i in range(len(item.requests))
            ]
        elif len(item.row_errors) == len(item.requests):
            item.error = next(iter(item.row_errors.values()))
        else:
            item.error = PartialBatchError(
                f"{len(item.row_errors)}/{len(item.requests)} rows of this "
                "session's generate call failed inside an engine iteration",
                results=[
                    item.row_results.get(i) for i in range(len(item.requests))
                ],
                row_errors=dict(item.row_errors),
            )
        item.failed = item.error is not None
        item.event.set()

    def _fail_item(self, item: _Item, exc: BaseException) -> None:
        """Fail a whole item: queued rows are skipped on sight (``failed``),
        resident siblings get evicted by the cancellation sweep."""
        if item.failed or item.event.is_set():
            item.failed = True
            return
        item.failed = True
        item.error = exc
        item.event.set()

    def _reject_oversized(self, row: _Row, needed: int) -> None:
        # Lazy import: backends must not import the serving tier at module
        # load (serve imports batching), but the OOM contract is the
        # scheduler's typed admission signal.
        from consensus_tpu_torch.serve.scheduler import SchedulerRejected

        self._fail_item(
            row.item,
            SchedulerRejected(
                "kv_oom",
                f"request needs {needed} KV pages; the pool holds only "
                f"{self.pool.num_pages} ({self.pool.page_size} tokens/page) "
                "— it can never be scheduled",
            ),
        )

    # -- token accounting ----------------------------------------------------

    def _prompt_token_ids(self, request) -> List[Any]:
        parts = [
            getattr(request, "system_prompt", None) or "",
            getattr(request, "user_prompt", "") or "",
        ]
        return self._tokenize_text(" ".join(p for p in parts if p))

    def _count_text_tokens(self, text: str) -> int:
        return len(self._tokenize_text(text))

    def _tokenize_text(self, text: str) -> List[Any]:
        """Tokens for PAGE accounting and prefix-cache CONTENT KEYS only —
        never for numerics.  Uses the inner backend's real tokenizer when
        it has one; the fake backend's whitespace pseudo-tokenizer
        otherwise."""
        tok = getattr(self.inner, "tokenizer", None)
        if tok is not None and hasattr(tok, "encode"):
            try:
                return list(tok.encode(text))
            except Exception:
                pass
        pseudo = getattr(self.inner, "_tokenize", None)
        if callable(pseudo):
            return list(pseudo(text))
        return text.split()
