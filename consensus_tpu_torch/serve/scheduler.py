"""Request scheduler: bounded admission in front of the batched engine
(PyTorch port of ``consensus_tpu/serve/scheduler.py``, with its request WAL
and welfare telemetry seams).

Continuous-batching serving (Orca / vLLM lineage) splits the server into a
front half that decides WHAT runs and a back half that decides HOW it runs.
The back half already exists here — ``BatchingBackend`` merges concurrent
sessions' generate/score/embed calls into shared padded device batches —
so this module supplies the front half:

* **Bounded FIFO queue + admission control.**  ``submit`` either accepts a
  request or raises :class:`SchedulerRejected` immediately (queue full /
  draining).  Overload produces an explicit, cheap rejection the client
  can retry against another replica — never unbounded queueing latency.
* **Worker pool over ONE shared BatchingBackend.**  ``max_inflight``
  workers each wrap a request in ``batching.session()`` (the same pattern
  as ``experiment.py``'s concurrent path), so whatever is in flight
  co-merges into wider device batches; admission and batching compose
  without knowing about each other.
* **Deadlines with cooperative cancellation.**  Every ticket carries a
  monotonic deadline.  Expiry while queued is detected at pop; the waiter
  (HTTP handler) can also ``cancel()`` a ticket it has given up on.  A
  request already inside a device dispatch finishes (device programs are
  not preemptible) but its result is discarded and counted as timeout.
* **Bounded retry with backoff.**  Transient backend failures (e.g. an
  aborted flush failing every waiter in its batch) retry up to
  ``max_retries`` times with exponential backoff, capped by the ticket's
  remaining deadline.  Validation errors never retry.
* **Graceful drain.**  ``shutdown(drain=True)`` closes admission, lets the
  queue and in-flight work complete, then joins the workers; no ticket is
  ever left unresolved.

Obs families (land in ``metrics.json`` / ``metrics.prom`` / ``/metrics``):
``serve_queue_depth``, ``serve_inflight`` (gauges),
``serve_request_latency_seconds{method,outcome}`` (histogram, submit→done),
``serve_accepted_total``, ``serve_rejected_total{reason}``,
``serve_timeout_total``, ``serve_retried_total``, ``serve_failed_total``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import json
import logging
import pathlib
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from consensus_tpu_torch.backends.base import Backend, TransientBackendError
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.methods.anytime import BudgetClock, BudgetExpired
from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.obs.trace import trace_current, use_trace
from consensus_tpu_torch.serve.brownout import BrownoutController
from consensus_tpu_torch.serve.wal import result_hash as _result_hash
from consensus_tpu_torch.utils.io_atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: Exception types considered transient (retryable).  Validation/config
#: errors (ValueError/KeyError/TypeError) are not in this set on purpose:
#: resubmitting a bad request can never succeed.  Of the backend error
#: taxonomy only :class:`TransientBackendError` is here — integrity and
#: device-lost errors are deterministic, so resubmitting cannot help.
TRANSIENT_EXCEPTIONS = (
    TransientBackendError, RuntimeError, ConnectionError, TimeoutError,
    OSError,
)


class SchedulerRejected(Exception):
    """Admission control refused the request (explicit overload signal).

    ``retry_after_s`` is set for breaker-open rejections: the cooldown
    remaining, surfaced as an HTTP ``Retry-After`` header."""

    def __init__(self, reason: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class RequestTimeout(Exception):
    """The request's deadline expired before a result was produced."""


def idempotency_key(request: Any, method: str = "") -> Optional[str]:
    """Stable identity for one request's result, or None when the request
    carries no ``request_id`` (anonymous requests are never deduplicated).
    The id alone is not enough — a reused id with different content must
    NOT collide — so the key hashes id + method + the semantic fields."""
    request_id = getattr(request, "request_id", None)
    if not request_id:
        return None
    h = hashlib.blake2b(digest_size=16)
    for part in (
        request_id, method,
        getattr(request, "seed", ""), getattr(request, "issue", ""),
        getattr(request, "n", ""), getattr(request, "max_tokens", ""),
    ):
        h.update(str(part).encode("utf-8", "replace"))
        h.update(b"\x1f")
    return h.hexdigest()


#: Snapshot file schema for the durable idempotency cache.
IDEMPOTENCY_SCHEMA = "consensus_tpu.serve.idem.v1"


class IdempotencyCache:
    """Bounded LRU of completed results keyed by request identity.

    Shared across a fleet: every replica's scheduler records terminal
    ok/degraded results; the router consults it before RE-dispatching a
    failed-over ticket, so a request whose first replica died AFTER
    computing the answer is resolved from the cache instead of executed a
    second time — zero duplicated requests under chaos, byte-identical
    re-delivery.

    With ``snapshot_path`` the cache is DURABLE: entries are atomically
    snapshotted every ``snapshot_every`` puts (and at drain), and a new
    cache constructed over the same path restores them — so requests
    replayed from the WAL after a crash-restart are answered from the
    snapshot as ``idempotent_replay`` instead of recomputed."""

    def __init__(self, max_entries: int = 1024,
                 snapshot_path=None, snapshot_every: int = 8):
        self.max_entries = max(1, int(max_entries))
        self.snapshot_path = (
            pathlib.Path(snapshot_path) if snapshot_path else None
        )
        self.snapshot_every = max(1, int(snapshot_every))
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.puts = 0
        self.restored = 0
        if self.snapshot_path is not None and self.snapshot_path.exists():
            try:
                payload = json.loads(self.snapshot_path.read_text())
            except (ValueError, OSError):
                payload = {}
            if payload.get("schema") == IDEMPOTENCY_SCHEMA:
                for key, record in payload.get("entries", []):
                    self._entries[str(key)] = record
                self.restored = len(self._entries)

    def put(self, key: str, record: Dict[str, Any]) -> None:
        snap = False
        with self._lock:
            self.puts += 1
            self._entries[key] = record
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            snap = (self.snapshot_path is not None
                    and self.puts % self.snapshot_every == 0)
        if snap:
            self.snapshot()

    def snapshot(self) -> None:
        """Atomic-replace the on-disk snapshot (no-op when not durable).
        Entries are copied under the lock, written outside it — a crash
        mid-write leaves the previous complete snapshot in place."""
        if self.snapshot_path is None:
            return
        with self._lock:
            entries = [[k, v] for k, v in self._entries.items()]
        atomic_write_json(self.snapshot_path, {
            "schema": IDEMPOTENCY_SCHEMA,
            "entries": entries,
        })

    def get(self, key: Optional[str]) -> Optional[Dict[str, Any]]:
        if key is None:
            return None
        with self._lock:
            record = self._entries.get(key)
            if record is None:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return record

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            stats = {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "puts": self.puts,
            }
            if self.snapshot_path is not None:
                stats["snapshot_path"] = str(self.snapshot_path)
                stats["restored"] = self.restored
            return stats


class Ticket:
    """Handle for one admitted request: wait / result / cancel."""

    def __init__(self, request: Any, deadline: Optional[float]):
        self.request = request
        self.deadline = deadline  # monotonic seconds, None = no deadline
        self.submitted = time.monotonic()
        self.attempts = 0
        # "ok" | "degraded" (anytime partial / browned-out budget) |
        # "timeout" | "failed"
        self.outcome: Optional[str] = None
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancelled = threading.Event()
        #: Request-scoped trace carrier (obs.trace), captured at submit from
        #: the submitting thread's active context; span ids are 0 (= no-op)
        #: when tracing is not active for this request.
        self.trace = None
        self._span_parent: Optional[int] = None
        self._span_queue = 0
        self._span_handler = 0

    # -- waiter side -------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Cooperative: a queued ticket is dropped at pop; a running one
        completes but its result is discarded as a timeout."""
        self._cancelled.set()

    def result(self) -> Any:
        """The response dict; raises the terminal error if the request did
        not complete (RequestTimeout / SchedulerRejected / backend error)."""
        if not self._done.is_set():
            raise RequestTimeout("request still pending")
        if self._error is not None:
            raise self._error
        return self._value

    # -- scheduler side ----------------------------------------------------

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        remaining = self.remaining()
        return remaining is not None and remaining <= 0

    def _finish(self, outcome: str, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        self.outcome = outcome
        self._value = value
        self._error = error
        self._done.set()


class RequestScheduler:
    """Bounded FIFO queue + worker pool over one shared BatchingBackend."""

    def __init__(
        self,
        handler: Callable[[Any, Backend], Any],
        backend: Backend,
        max_queue_depth: int = 64,
        max_inflight: int = 4,
        default_timeout_s: Optional[float] = 120.0,
        max_retries: int = 2,
        retry_backoff_s: float = 0.05,
        flush_ms: float = 10.0,
        registry: Optional[Registry] = None,
        brownout: Optional[BrownoutController] = None,
        anytime_margin_s: float = 0.2,
        engine: bool = True,
        engine_options: Optional[Dict[str, Any]] = None,
        telemetry: Optional[Any] = None,
        idempotency: Optional["IdempotencyCache"] = None,
        wal: Optional[Any] = None,
    ):
        if max_queue_depth < 1 or max_inflight < 1:
            raise ValueError("max_queue_depth and max_inflight must be >= 1")
        self.handler = handler
        #: Graceful degradation (both OFF by default — full-budget serving
        #: is byte-identical to pre-brownout builds):
        #: ``brownout`` maps load pressure to the budget scale stamped on
        #: each dispatched ticket's BudgetClock; ``anytime_margin_s`` is how
        #: far BEFORE the ticket deadline the clock expires, buying the
        #: method time to surface its best-so-far statement while the HTTP
        #: waiter is still listening.
        self.brownout = brownout
        self.anytime_margin_s = float(anytime_margin_s)
        #: Clocks are only built for handlers that accept them — existing
        #: ``(request, backend)`` handlers keep their exact semantics.
        try:
            self._handler_takes_clock = (
                "budget_clock" in inspect.signature(handler).parameters
            )
        except (TypeError, ValueError):
            self._handler_takes_clock = False
        self.inner_backend = backend
        #: Supervised backends expose their breaker; admission consults it
        #: so an open breaker sheds load BEFORE requests queue up behind a
        #: failing device (and the half-open probe admits exactly one).
        self.circuit_breaker = getattr(backend, "circuit_breaker", None)
        self.max_queue_depth = int(max_queue_depth)
        self.max_inflight = int(max_inflight)
        self.default_timeout_s = default_timeout_s
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        #: Shared merge layer: whatever is in flight co-batches.  Sessions
        #: are entered per request (experiment.py's pattern), so the
        #: all-blocked flush sees exactly the in-flight request count.
        reg = registry if registry is not None else get_registry()
        self.batching = BatchingBackend(
            backend,
            flush_ms=flush_ms,
            expected_sessions=self.max_inflight,
            registry=reg,
            # The continuous-batching decode engine is the default merge
            # layer — same byte-identical results as the legacy flush, no
            # flush barrier; slot/page pressure joins stats().
            # ``engine=False`` opts back into the flush-snapshot path.
            engine=engine,
            engine_options=engine_options,
        )
        self._m_queue_depth = reg.gauge(
            "serve_queue_depth", "Requests waiting in the admission queue.")
        self._m_inflight = reg.gauge(
            "serve_inflight", "Requests currently executing on workers.")
        self._m_latency = reg.histogram(
            "serve_request_latency_seconds",
            "End-to-end request latency (submit -> terminal outcome), by "
            "method and outcome (ok|timeout|failed).",
            labels=("method", "outcome"),
        )
        self._m_accepted = reg.counter(
            "serve_accepted_total", "Requests admitted to the queue.")
        self._m_rejected = reg.counter(
            "serve_rejected_total",
            "Requests refused by admission control, by reason "
            "(queue_full|draining|stopped|breaker_open at the queue; "
            "kv_oom from the engine's page-pool admission).",
            labels=("reason",),
        )
        self._m_timeout = reg.counter(
            "serve_timeout_total",
            "Requests that hit their deadline (queued expiry, waiter "
            "cancellation, or mid-retry expiry).")
        self._m_retried = reg.counter(
            "serve_retried_total",
            "Transient-failure retries issued (attempts beyond the first).")
        self._m_failed = reg.counter(
            "serve_failed_total",
            "Requests that terminally failed after exhausting retries.")
        self._m_degraded = reg.counter(
            "serve_degraded_total",
            "Requests resolved with a degraded (anytime partial or "
            "budget-scaled) statement instead of a timeout/full result.")

        #: Stamped by the fleet's Replica wrapper so spans and health report
        #: which replica served; empty for a standalone scheduler.
        self.replica_name = ""
        #: Fleet tier of the owning replica ("full" / "degraded"); feeds the
        #: welfare-by-tier accounting when telemetry is on.
        self.replica_tier = ""
        #: Optional :class:`~consensus_tpu_torch.obs.welfare.ServeTelemetry`.
        #: None (the default) keeps the hot path byte-identical: the only
        #: cost is one attribute check per terminal request.
        self.telemetry = telemetry
        #: Optional fleet-shared :class:`IdempotencyCache`: completed
        #: results are recorded by request identity so a router re-dispatch
        #: of an already-answered request (its first replica died between
        #: computing and delivering) returns the SAME bytes instead of
        #: executing twice.
        self.idempotency = idempotency
        #: Optional :class:`~consensus_tpu_torch.serve.wal.RequestWAL`.  When
        #: armed, ``submit`` fsyncs an ``admitted`` record before
        #: returning and ``_finish`` fsyncs the terminal outcome — the
        #: crash-consistency contract.  None (the default, and always in
        #: fleet mode where durability rides the shared idempotency
        #: snapshot + PageStore spill instead) keeps the admission path
        #: byte-identical to the non-durable build.
        self.wal = wal
        self._m_replay_served = (
            reg.counter(
                "serve_replay_served_total",
                "Requests answered from the durable idempotency snapshot "
                "at admission (WAL replay dedup) instead of recomputed.")
            if wal is not None else None
        )
        #: Monotonic fallback ids for journaling anonymous requests (no
        #: ``request_id`` → no dedup, but the request is still replayed).
        self._wal_seq = 0

        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._queue: Deque[Ticket] = collections.deque()
        self._inflight_count = 0
        self._draining = False
        self._stopped = False
        self._workers: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RequestScheduler":
        if self._workers:
            raise RuntimeError("scheduler already started")
        for i in range(self.max_inflight):
            thread = threading.Thread(
                target=self._worker_loop, name=f"serve-worker-{i}", daemon=True
            )
            thread.start()
            self._workers.append(thread)
        return self

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Close admission; with ``drain`` let queued + in-flight work
        finish, otherwise fail queued tickets immediately.  Always joins
        the workers — after return no ticket is unresolved."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            self._draining = True
            if not drain:
                while self._queue:
                    ticket = self._queue.popleft()
                    ticket._finish(
                        "failed",
                        error=SchedulerRejected(
                            "stopped", "scheduler shut down before this "
                            "request was scheduled"),
                    )
                    self._m_rejected.labels("stopped").inc()
                    if self.wal is not None:
                        # A deliberate non-drain shutdown FAILS queued
                        # work (clients were told "stopped"); journal the
                        # outcome so the sealed journal replays nothing.
                        wal_id = getattr(ticket, "_wal_id", None)
                        if wal_id is not None:
                            self.wal.record_resolved(
                                wal_id, "failed",
                                getattr(ticket, "_wal_key", None), None)
                self._m_queue_depth.set(0)
            while self._queue or self._inflight_count:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                self._idle_cv.wait(timeout=remaining)
            self._stopped = True
            self._work_cv.notify_all()
        for thread in self._workers:
            join_for = None
            if deadline is not None:
                join_for = max(0.0, deadline - time.monotonic())
            thread.join(timeout=join_for)
        # Engine mode holds a scheduler thread of its own; release it once
        # no worker can issue further backend calls.
        self.batching.close()
        # Durable-state epilogue, strictly AFTER the drain completed:
        # final idempotency snapshot, then seal the journal.  A sealed
        # journal is the "clean shutdown" marker — the next start replays
        # nothing.  (The blackbox SIGTERM dump runs after stop() returns,
        # so it can never capture a half-sealed journal.)
        if self.idempotency is not None:
            self.idempotency.snapshot()
        if self.wal is not None:
            self.wal.seal()

    # -- admission ---------------------------------------------------------

    def submit(self, request: Any,
               timeout_s: Optional[float] = None) -> Ticket:
        """Admit ``request`` or raise :class:`SchedulerRejected`.

        ``timeout_s`` (or ``request.timeout_s``, or the server default)
        becomes the ticket's deadline, measured from admission."""
        if timeout_s is None:
            timeout_s = getattr(request, "timeout_s", None)
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        deadline = (
            time.monotonic() + float(timeout_s) if timeout_s is not None
            else None
        )
        ticket = Ticket(request, deadline)
        active = trace_current()
        if active is not None:
            ticket.trace, ticket._span_parent = active
        if self.wal is not None:
            served = self._try_serve_from_snapshot(ticket)
            if served is not None:
                return served
        with self._lock:
            if self._stopped or self._draining:
                self._m_rejected.labels("draining").inc()
                raise SchedulerRejected(
                    "draining", "server is draining; not accepting requests")
            breaker = self.circuit_breaker
            if breaker is not None and not breaker.admission_allowed():
                self._m_rejected.labels("breaker_open").inc()
                raise SchedulerRejected(
                    "breaker_open",
                    "backend circuit breaker is open; retry after cooldown",
                    retry_after_s=breaker.retry_after_s())
            if len(self._queue) >= self.max_queue_depth:
                self._m_rejected.labels("queue_full").inc()
                raise SchedulerRejected(
                    "queue_full",
                    f"admission queue is full "
                    f"({self.max_queue_depth} waiting); retry later")
            if ticket.trace is not None:
                # Begun before the worker can pop the ticket, so queue_wait
                # covers the full admission->dispatch interval.
                ticket._span_queue = ticket.trace.begin(
                    "queue_wait", parent=ticket._span_parent,
                    replica=self.replica_name)
            if self.wal is not None:
                # Fsync'd BEFORE the ticket becomes poppable and before
                # submit returns: once admission is acknowledged, a kill
                # cannot lose the request.  Appending under the lock pins
                # the admitted-before-dispatched ordering.
                self._journal_admitted(ticket)
            self._queue.append(ticket)
            self._m_accepted.inc()
            self._m_queue_depth.set(len(self._queue))
            self._work_cv.notify()
        self._update_brownout()
        return ticket

    def _journal_admitted(self, ticket: Ticket) -> None:
        """Append the ``admitted`` WAL record for one ticket (caller holds
        ``_lock``).  Anonymous requests get a synthetic per-process id —
        still journaled and replayed, just never deduplicated."""
        request = ticket.request
        method = getattr(request, "method", "unknown")
        rid = getattr(request, "request_id", "") or ""
        if not rid:
            self._wal_seq += 1
            rid = f"anon-{self._wal_seq}"
        ticket._wal_id = rid
        ticket._wal_key = idempotency_key(request, method)
        payload: Dict[str, Any] = {}
        if dataclasses.is_dataclass(request):
            payload = dataclasses.asdict(request)
        self.wal.record_admitted(rid, ticket._wal_key, payload)

    def _try_serve_from_snapshot(self, ticket: Ticket) -> Optional[Ticket]:
        """WAL-armed admission dedup: a request whose answer survived in
        the durable idempotency snapshot is resolved instantly as an
        ``idempotent_replay`` — never recomputed, and its bytes are
        cross-checked against the journal's ``result_hash`` (a mismatch
        is a loud :class:`~consensus_tpu_torch.serve.wal.WALIntegrityError`).
        Returns the resolved ticket, or None to fall through to normal
        admission.  Gated on the WAL being armed so the non-durable path
        stays byte-identical."""
        if self.idempotency is None:
            return None
        request = ticket.request
        method = getattr(request, "method", "unknown")
        key = idempotency_key(request, method)
        record = self.idempotency.get(key) if key is not None else None
        if record is None:
            return None
        rid = getattr(request, "request_id", "") or ""
        value = record.get("value")
        if isinstance(value, dict):
            self.wal.verify_replay(rid, value)
            value = dict(value)
            value["idempotent_replay"] = True
            if record.get("replica"):
                value["served_by"] = record["replica"]
            if record.get("tier"):
                value["served_tier"] = record["tier"]
        outcome = record.get("outcome", "ok")
        # The journal still accounts this life's acceptance + resolution.
        with self._lock:
            ticket._wal_id = rid or f"replay-{id(ticket):x}"
            ticket._wal_key = key
            self.wal.record_admitted(ticket._wal_id, key, {})
            self.wal.record_resolved(
                ticket._wal_id, outcome, key, _result_hash(value))
            self._m_accepted.inc()
        if self._m_replay_served is not None:
            self._m_replay_served.inc()
        ticket._finish(outcome, value=value)
        return ticket

    def _update_brownout(self) -> None:
        """Feed the live load signals to the controller (no-op when brownout
        is disabled).  Called outside ``_lock``."""
        if self.brownout is None:
            return
        breaker_state = None
        if self.circuit_breaker is not None:
            breaker_state = self.circuit_breaker.snapshot().get("state")
        with self._lock:
            queue_depth = len(self._queue)
            inflight = self._inflight_count
        self.brownout.update(
            queue_depth=queue_depth,
            max_queue_depth=self.max_queue_depth,
            inflight=inflight,
            max_inflight=self.max_inflight,
            breaker_state=breaker_state,
        )

    def _build_clock(self, ticket: Ticket) -> Optional[BudgetClock]:
        """Per-request BudgetClock: remaining deadline minus the anytime
        margin (so partials surface while the waiter still listens), the
        ticket's cancellation flag, and the current brownout tier's scale."""
        if not self._handler_takes_clock:
            return None
        scale, tier = 1.0, None
        if self.brownout is not None:
            self._update_brownout()
            tier = self.brownout.tier
            scale = self.brownout.tier_scales[tier]
            self.brownout.note_dispatch()
        deadline = None
        remaining = ticket.remaining()
        if remaining is not None:
            deadline = time.monotonic() + remaining - self.anytime_margin_s
        if deadline is None and scale >= 1.0 and tier in (None, 0):
            # Unbounded, unscaled: hand the method its default clock (built
            # from config) rather than pinning an inert one.
            return None
        return BudgetClock(
            deadline=deadline,
            scale=scale,
            cancelled=lambda: ticket.cancelled,
            tier=tier,
        )

    @property
    def draining(self) -> bool:
        """Lock-free drain flag (a stale read is harmless — the fleet
        router re-checks at submit, where the lock is taken)."""
        return self._draining

    def stats(self) -> Dict[str, Any]:
        """Live occupancy for /healthz."""
        with self._lock:
            stats = {
                "queue_depth": len(self._queue),
                "inflight": self._inflight_count,
                "max_queue_depth": self.max_queue_depth,
                "max_inflight": self.max_inflight,
                "draining": self._draining,
                "workers_alive": sum(t.is_alive() for t in self._workers),
                "device_batches": dict(self.batching.batch_counts),
            }
        if self.batching.engine is not None:
            # Slot/page pressure next to queue depth: /healthz shows how
            # full the decode slot table and KV page pool are.
            stats["engine"] = self.batching.engine.stats()
        if self.circuit_breaker is not None:
            stats["circuit_breaker"] = self.circuit_breaker.snapshot()
        if self.brownout is not None:
            stats["brownout"] = self.brownout.snapshot()
        if self.wal is not None:
            # Lands in /healthz via the frontend's stats() passthrough:
            # journal state + durable idempotency cache in one block.
            durability: Dict[str, Any] = {"wal": self.wal.stats()}
            if self.idempotency is not None:
                durability["idempotency"] = self.idempotency.stats()
            stats["durability"] = durability
        return stats

    # -- workers -----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            ticket = self._pop()
            if ticket is None:
                return
            try:
                self._run_ticket(ticket)
            finally:
                with self._lock:
                    self._inflight_count -= 1
                    self._m_inflight.set(self._inflight_count)
                    if not self._queue and not self._inflight_count:
                        self._idle_cv.notify_all()

    def _pop(self) -> Optional[Ticket]:
        with self._lock:
            while not self._queue and not self._stopped:
                self._work_cv.wait()
            if not self._queue:
                return None  # stopped and drained
            ticket = self._queue.popleft()
            self._m_queue_depth.set(len(self._queue))
            self._inflight_count += 1
            self._m_inflight.set(self._inflight_count)
            return ticket

    def _run_ticket(self, ticket: Ticket) -> None:
        method = getattr(ticket.request, "method", "unknown")
        trace = ticket.trace
        if trace is not None:
            trace.end(ticket._span_queue)
            ticket._span_handler = trace.begin(
                "handler", parent=ticket._span_parent,
                replica=self.replica_name, method=method)
        self._update_brownout()
        if ticket.cancelled or ticket.expired():
            # Died in the queue: the cheap overload outcome — no device
            # work was wasted on it (and no wave ran, so there is no
            # partial to degrade to).
            self._m_timeout.inc()
            self._finish(ticket, method, "timeout",
                         error=RequestTimeout("deadline expired in queue"))
            return
        clock = self._build_clock(ticket)
        handler_kwargs = (
            {"budget_clock": clock} if self._handler_takes_clock else {}
        )
        while True:
            ticket.attempts += 1
            try:
                # The ticket's cancellation flag rides into the batching
                # layer: queued device calls of an abandoned ticket are
                # dropped at the flush snapshot (RequestCancelled) instead
                # of spending device time co-batched with live requests.
                # The trace context is re-established on THIS worker thread
                # so the engine's submit() (called from inside the handler)
                # can parent its spans under the handler span.
                with self.batching.session(
                    cancelled=lambda: ticket.cancelled
                ), use_trace(trace, ticket._span_handler):
                    value = self.handler(
                        ticket.request, self.batching, **handler_kwargs
                    )
            except BudgetExpired as exc:
                # The budget died before ANY wave completed — nothing to
                # degrade to; terminal timeout, exactly the pre-anytime
                # outcome.
                self._m_timeout.inc()
                self._finish(ticket, method, "timeout",
                             error=RequestTimeout(
                                 f"budget expired before the first "
                                 f"{exc.method} wave ({exc.reason})"))
                return
            except Exception as exc:
                if ticket.cancelled or ticket.expired():
                    # The failure is moot: the deadline already passed, so
                    # the terminal outcome is the timeout, not the error.
                    self._m_timeout.inc()
                    self._finish(ticket, method, "timeout",
                                 error=RequestTimeout(
                                     f"deadline expired during attempt "
                                     f"{ticket.attempts} ({type(exc).__name__})"))
                    return
                if isinstance(exc, SchedulerRejected):
                    # Deferred admission rejection — the engine's page-pool
                    # check (kv_oom) fires at schedule time, not submit
                    # time.  It is deterministic (the request can NEVER
                    # fit), so: no retry, counted as a rejection rather
                    # than a backend failure, and re-raised to the HTTP
                    # layer which maps kv_oom to 413.
                    self._m_rejected.labels(exc.reason).inc()
                    self._finish(ticket, method, "failed", error=exc)
                    return
                if not self._should_retry(ticket, exc):
                    self._m_failed.inc()
                    logger.exception(
                        "request %s failed terminally after %d attempt(s)",
                        getattr(ticket.request, "request_id", ""),
                        ticket.attempts,
                    )
                    self._finish(ticket, method, "failed", error=exc)
                    return
                self._m_retried.inc()
                backoff = self.retry_backoff_s * (2 ** (ticket.attempts - 1))
                remaining = ticket.remaining()
                if remaining is not None:
                    backoff = min(backoff, max(0.0, remaining))
                time.sleep(backoff)
                continue
            degraded = isinstance(value, dict) and value.get("degraded")
            if (ticket.cancelled or ticket.expired()) and not degraded:
                # A FULL result completed past its deadline: the waiter is
                # gone; report the truth (timeout) rather than a result
                # nobody read.  Degraded results are exempt — they exist
                # precisely to be delivered at/after the deadline, and the
                # HTTP waiter grants a grace window to collect them.
                self._m_timeout.inc()
                self._finish(ticket, method, "timeout",
                             error=RequestTimeout(
                                 "completed after deadline; result discarded"))
                return
            if degraded:
                self._m_degraded.inc()
                self._finish(ticket, method, "degraded", value=value)
                return
            self._finish(ticket, method, "ok", value=value)
            return

    def _should_retry(self, ticket: Ticket, exc: Exception) -> bool:
        if not isinstance(exc, TRANSIENT_EXCEPTIONS):
            return False
        if ticket.attempts > self.max_retries:
            return False
        if ticket.cancelled or ticket.expired():
            return False
        return True

    def _finish(self, ticket: Ticket, method: str, outcome: str,
                value: Any = None,
                error: Optional[BaseException] = None) -> None:
        elapsed = time.monotonic() - ticket.submitted
        self._m_latency.labels(method, outcome).observe(elapsed)
        if self.brownout is not None and outcome in (
            "ok", "degraded", "timeout"
        ):
            # Timeouts feed the tracker too: they ARE the latency tail the
            # controller exists to shave.
            self.brownout.record_latency(elapsed)
        if ticket.trace is not None:
            ticket.trace.end(ticket._span_queue)
            ticket.trace.end(ticket._span_handler, outcome=outcome,
                             attempts=ticket.attempts)
        if self.telemetry is not None:
            # Degraded-tier attribution: a non-full fleet tier wins, else
            # the live brownout tier; "" lets telemetry fall back to the
            # response's degraded_reason.
            tier = ""
            if self.replica_tier and self.replica_tier != "full":
                tier = self.replica_tier
            elif self.brownout is not None and self.brownout.tier:
                tier = f"brownout{self.brownout.tier}"
            self.telemetry.record_request(
                method=method,
                outcome=outcome,
                latency_s=elapsed,
                value=value,
                replica=self.replica_name,
                tier=tier,
                # Exemplar linkage: the request id doubles as the trace id
                # when the request carried a trace (GET /v1/trace/<id>).
                trace_id=(
                    getattr(ticket.request, "request_id", None)
                    if ticket.trace is not None
                    else None
                ),
            )
        if (self.idempotency is not None and value is not None
                and outcome in ("ok", "degraded")):
            key = idempotency_key(ticket.request, method)
            if key is not None:
                self.idempotency.put(key, {
                    "outcome": outcome,
                    "value": value,
                    "replica": self.replica_name,
                    "tier": self.replica_tier,
                })
        if self.wal is not None:
            # EVERY terminal outcome is journaled — timeouts and failures
            # too, else a crash after a timeout would replay a request the
            # client already saw fail.  result_hash only exists for
            # value-bearing outcomes.
            wal_id = getattr(ticket, "_wal_id", None)
            if wal_id is not None:
                self.wal.record_resolved(
                    wal_id, outcome, getattr(ticket, "_wal_key", None),
                    _result_hash(value) if value is not None else None)
        ticket._finish(outcome, value=value, error=error)
