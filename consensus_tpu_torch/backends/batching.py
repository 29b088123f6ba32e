"""Cross-run device batching (PyTorch port of
``consensus_tpu/backends/batching.py``).

The reference hides HTTP latency by fanning (method x param x seed) combos
across a ``ThreadPoolExecutor``.  On the device the model is the
bottleneck, so the win is different: independent runs that are at the same
phase share ONE padded device batch instead of issuing small batches back
to back.

:class:`BatchingBackend` wraps an inner backend.  Worker threads (one per
concurrent run) register a :meth:`session`; each protocol call enqueues its
requests and blocks.  A batch flushes when EVERY active session has a call
pending (all threads blocked: nothing more can arrive) or when a waiter
times out (``flush_ms``, longer for generate: :meth:`_window_s`).  The
flushing thread concatenates same-kind requests, executes them on the inner
backend as one batch with the lock released, and distributes the slices.

Fused token-search sessions step outside the queue, one device program per
call, so nothing merges them.  They take turns on the device
(:class:`_DeviceTurns`): threads that drive eager PyTorch at once contend
for the interpreter at every launch (on an H100, four beam sessions stepped
side by side ran 3x slower than one after another).  A session's thread
keeps its turn through the host work between its steps, so the waiting
threads sit idle instead of contending, and hands it on at its next call
when another thread waits.  A thread gives its turn up before anything
that may wait on another thread: a queued call, or opening a session (the
inner backend's session budget may block until another session closes).
Flushes take no turn, for the same reason: a fused score matrix may wait on
that budget.

Correctness: per-request threefry keys (``torch_backend.py``) make every
sampled draw independent of batch composition.  The logits are not always:
on the card, GEMMs of other row buckets round differently, so a merged
batch can flip a greedy pick or a sampled near-tie
(``TorchBackend.deterministic_greedy`` is False there).  On the CPU in
float32, merged batches give the sequential statements.

With ``engine=True`` (the constructor default, as in the JAX package)
every protocol call routes into the continuous-batching decode engine
(``backends/engine.py``) and the flush-snapshot path is unreachable; fused
sessions still take turns and are tracked on the engine's pressure surface
(``DecodeEngine.track_session``).  ``Experiment`` passes
``engine=bool(config.get("engine", False))`` in both packages, so the
flush-snapshot path is the one experiments run by default; the serving
scheduler runs the engine.

A session's cancellation probe (``session(cancelled=...)``) drops its
queued calls at the flush snapshot with :class:`RequestCancelled`; a
:class:`PartialBatchError` from the inner backend (the supervisor's poison
isolation) is distributed row by row, so one bad row fails one waiter.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from consensus_tpu_torch.backends.base import (
    Backend,
    GenerationRequest,
    GenerationResult,
    NextTokenRequest,
    PartialBatchError,
    RequestCancelled,
    ScoreRequest,
    ScoreResult,
    TokenCandidate,
)
from consensus_tpu_torch.obs.metrics import (
    DEFAULT_COUNT_BUCKETS,
    Registry,
    get_registry,
)


class _Pending:
    __slots__ = (
        "requests", "result", "error", "done", "enqueued", "in_flight",
        "cancelled",
    )

    def __init__(self, requests, cancelled=None):
        self.requests = requests
        self.result = None
        self.error = None
        self.done = False
        self.enqueued = time.perf_counter()
        #: True once a flush has snapshotted this entry off its queue — its
        #: waiter then parks on the kind's DISPATCH condition, which is only
        #: notified when the entry's own batch completes (or aborts).
        self.in_flight = False
        #: Session-scoped cancellation probe (the serving ticket's
        #: ``cancelled`` flag), or None.  Consulted ONCE, at the flush
        #: snapshot: a cancelled entry is dropped from the merged batch and
        #: failed with :class:`RequestCancelled` before any device time is
        #: spent on it.  Once an entry is in flight it always completes —
        #: device programs are not preemptible, and co-batched siblings'
        #: slices must stay bit-identical.
        self.cancelled = cancelled


class _DeviceTurns:
    """Turns on the device for fused sessions' threads: one at a time, handed
    on in arrival order."""

    def __init__(self):
        self._cond = threading.Condition()
        self._owner: Optional[int] = None
        self._waiting: collections.deque = collections.deque()

    def held(self) -> bool:
        return self._owner == threading.get_ident()

    def take(self) -> None:
        """Wait for the device.  The owner keeps it unless another thread
        waits, in which case it goes to the back of the line."""
        me = threading.get_ident()
        with self._cond:
            if self._owner == me:
                if not self._waiting:
                    return
                self._owner = None
                self._cond.notify_all()
            self._waiting.append(me)
            while self._owner is not None or self._waiting[0] != me:
                self._cond.wait()
            self._waiting.popleft()
            self._owner = me

    def give_up(self) -> None:
        """Hand the device on; a no-op for a thread that does not hold it."""
        with self._cond:
            if self._owner == threading.get_ident():
                self._owner = None
                self._cond.notify_all()


class _TurnTakingSession:
    """A fused session that takes the device for every call and keeps it
    until its next call (or ``close``).  Attributes other than callables
    read through to the session."""

    def __init__(self, session, turns: _DeviceTurns):
        self.session = session
        self._turns = turns

    def __getattr__(self, name):
        value = getattr(self.session, name)
        if not callable(value):
            return value

        def call(*args, **kwargs):
            self._turns.take()
            if name != "close":
                return value(*args, **kwargs)
            try:
                return value(*args, **kwargs)
            finally:
                self._turns.give_up()

        return call


class BatchingBackend:
    """Merge concurrent sessions' backend calls into shared device batches.

    ``engine_options`` passes through to the decode engine verbatim —
    notably ``{"decode_steps": K}`` turns on multi-token decode: the engine
    dispatches K-step on-device decode windows per cohort
    (``inner.generate_stream``) instead of one blocking ``generate`` call,
    overlapping host admission/prefill with device decode.
    """

    name = "batching"

    def __init__(
        self,
        inner: Backend,
        flush_ms: float = 10.0,
        expected_sessions: int = 1,
        registry: Optional[Registry] = None,
        engine: bool = True,
        engine_options: Optional[Dict[str, Any]] = None,
        prefix_cache: bool = False,
        mesh: Optional[Any] = None,
    ):
        #: Mesh passthrough (``batching.py:109-113``): ``mesh={'dp': N, 'tp':
        #: M}`` (or "dp=4,tp=2", or a MeshPlan) partitions the engine's slots
        #: and page pools.  Left unset, the engine inherits the inner
        #: backend's mesh (its dp shards and tp width).
        if mesh is not None:
            engine_options = {"mesh": mesh, **dict(engine_options or {})}
        #: Convenience flag: ``prefix_cache=True`` folds into the engine
        #: options (engine mode only — the flush-snapshot path has no page
        #: pool to cache into).  An explicit ``engine_options`` key wins.
        if prefix_cache:
            engine_options = {"prefix_cache": True, **dict(engine_options or {})}
        self.inner = inner
        self.flush_s = flush_ms / 1000.0
        # obs: queue-wait (enqueue -> dispatch), batch-fill (sessions merged
        # per flush), and flush-reason accounting.  ``registry`` isolates
        # tests from the process-global registry.
        reg = registry if registry is not None else get_registry()
        self._queue_wait = reg.histogram(
            "batching_queue_wait_seconds",
            "Time a session's call waited in the merge queue before its "
            "batch dispatched.",
            labels=("kind",),
        )
        self._batch_fill = reg.histogram(
            "batching_batch_fill_sessions",
            "Sessions merged into one device batch per flush.",
            labels=("kind",),
            buckets=DEFAULT_COUNT_BUCKETS,
        )
        self._merged_requests = reg.counter(
            "batching_merged_requests_total",
            "Requests merged into shared device batches.",
            labels=("kind",),
        )
        self._flushes = reg.counter(
            "batching_flushes_total",
            "Batch flushes by trigger: all active sessions blocked vs. "
            "flush_ms quiescence timeout.",
            labels=("kind", "reason"),
        )
        self._spurious_wakeups = reg.counter(
            "batching_spurious_wakeups_total",
            "Mid-flush waiters woken while their own request was still "
            "pending.  Stays 0 when completion wakeups are routed per kind; "
            "a cross-kind broadcast would charge every parked waiter one "
            "wakeup per other kind's dispatch.",
            labels=("kind",),
        )
        self._row_errors = reg.counter(
            "batching_row_errors_total",
            "Rows of a merged device batch that failed with a typed "
            "per-row error while sibling rows succeeded (PartialBatchError "
            "unpacking; poison-row isolation).",
            labels=("kind",),
        )
        self._cancelled_requests = reg.counter(
            "batching_cancelled_requests_total",
            "Queued calls dropped at the flush snapshot because their "
            "session's cancellation probe fired before dispatch (failed "
            "with RequestCancelled; no device time spent).",
            labels=("kind",),
        )
        #: Shares the engine's dedup family: identical score rows merged
        #: into one flush are computed once regardless of which dispatch
        #: loop (engine iteration or flush-snapshot) runs them.
        self._score_dedup = reg.counter(
            "engine_score_dedup_total",
            "Duplicate score rows removed from merged dispatches — "
            "identical (prompt, continuation) rows in one flush are "
            "computed once and fanned back out.",
        )
        #: Until this many sessions have STARTED, the all-blocked heuristic
        #: is suppressed — otherwise the first worker to enqueue during pool
        #: ramp-up sees active==1 and flushes a batch of one.
        self.expected_sessions = max(1, expected_sessions)
        #: One lock guards all queues/flags; each kind waits on its OWN pair
        #: of conditions over that lock.  ``_conds[kind]`` is the QUEUE
        #: condition (entry still on its queue: flush decisions, flush-end
        #: re-evaluation); ``_dispatch_conds[kind]`` is the DISPATCH
        #: condition (entry snapshotted into a running flush: woken exactly
        #: when its batch completes or the flush aborts).  The split is what
        #: lets a completed generate batch wake precisely the waiters whose
        #: entries finished — same-kind requests that arrived DURING the
        #: flush park on the queue condition and sleep through it
        #: (``batching_spurious_wakeups_total`` pins this at 0 under
        #: mixed-kind load).
        self._lock = threading.Lock()
        #: Taken by every fused-session call: one session's thread drives
        #: the device at a time.
        self._device = _DeviceTurns()
        self._active = 0
        self._started = 0
        self._flushing = False
        self._queues: Dict[str, List[_Pending]] = {
            "generate": [], "score": [], "next_token": [], "embed": [],
            "score_matrix": [],
        }
        self._conds: Dict[str, threading.Condition] = {
            kind: threading.Condition(self._lock) for kind in self._queues
        }
        self._dispatch_conds: Dict[str, threading.Condition] = {
            kind: threading.Condition(self._lock) for kind in self._queues
        }
        #: Device batches actually issued per kind — the measurable win:
        #: N concurrent runs << N× the solo batch count.
        self.batch_counts = {
            "generate": 0, "score": 0, "next_token": 0, "embed": 0,
            "score_matrix": 0,
        }
        #: Per-thread session cancellation probe (set by ``session()``).
        self._tls = threading.local()
        #: Continuous-batching engine (backends/engine.py): when enabled,
        #: every protocol call routes straight into the engine's iteration
        #: loop and the whole flush-snapshot path above is UNREACHABLE —
        #: no quiescence windows, so ``flush_reason="timeout"`` can never
        #: be emitted and ``batching_spurious_wakeups_total`` stays pinned
        #: at 0.  ``engine=False`` is the explicit opt-out for the
        #: flush-snapshot path.
        self.engine = None
        if engine:
            from consensus_tpu_torch.backends.engine import DecodeEngine

            self.engine = DecodeEngine(
                inner,
                registry=reg,
                cancelled_counter=self._cancelled_requests,
                **dict(engine_options or {}),
            )
            # Serve stats read ``batch_counts`` for device-batch totals;
            # alias it to the engine's dispatch counters so the surface
            # keeps one meaning across both paths.
            self.batch_counts = self.engine.dispatch_counts

    @property
    def deterministic_greedy(self) -> bool:
        """The inner backend's: per-row keys make draws independent of the
        batch, so whether a greedy pick depends on its batch is a property
        of the inner backend's logits (False for ``TorchBackend`` on the
        card, where the Habermas Machine then keeps its ranking retries)."""
        return bool(getattr(self.inner, "deterministic_greedy", False))

    def open_fused_token_search(self, spec):
        """Fused token-search sessions bypass the request queue: each session
        step is already ONE fused device program on the inner backend, so
        there is nothing to merge — and without this delegation a concurrent
        sweep cell would silently fall back to the O(T^2) full-prefix
        session.  The session takes turns on the device with the other
        sessions (``_device``): its thread keeps the device from one call to
        the next.  The
        inner backend's session budget bounds how many are open at once; if
        the inner backend has no fused sessions (or declines the spec),
        FusedSessionUnavailable propagates and the factory builds the
        full-prefix fallback over THIS wrapper, keeping its calls merged
        through the queue."""
        from consensus_tpu_torch.backends.session import FusedSessionUnavailable

        maker = getattr(self.inner, "open_fused_token_search", None)
        if maker is None:
            raise FusedSessionUnavailable(
                f"inner backend {self.inner.name!r} has no fused sessions"
            )
        # Opening may wait for another session to close: not on a turn.
        self._device.give_up()
        session = _TurnTakingSession(maker(spec), self._device)
        if self.engine is not None:
            # Fused sessions dispatch their own programs, but their slot
            # footprint still counts as engine pressure (/healthz).  The
            # engine wraps ``close``, which still takes and gives up the
            # turn through the wrapper.
            session = self.engine.track_session(session, spec)
        return session

    def close(self) -> None:
        """Stop the decode engine's iteration loop (no-op on the
        flush-snapshot path, which holds no threads of its own)."""
        if self.engine is not None:
            self.engine.close()

    def _notify(self, kinds) -> None:
        """Wake the given kinds' waiters.  Caller holds ``_lock`` (every
        per-kind condition shares it)."""
        for kind in kinds:
            self._conds[kind].notify_all()

    @contextlib.contextmanager
    def session(self, cancelled: Optional[Callable[[], bool]] = None):
        """Register the calling thread as an active run for flush accounting.

        ``cancelled`` (optional) is a zero-arg probe — typically the serving
        ticket's cancellation flag — attached to every call this thread
        enqueues while the session is open.  Queued calls whose probe fires
        are dropped at the next flush snapshot with
        :class:`RequestCancelled` instead of riding the merged device batch;
        calls already in flight complete normally (their co-batched
        siblings' results must not change)."""
        self._tls.cancelled = cancelled
        with self._lock:
            self._active += 1
            self._started += 1
        try:
            yield self
        finally:
            # A run that left a fused session open must not keep the device.
            self._device.give_up()
            self._tls.cancelled = None
            with self._lock:
                self._active -= 1
                # A departing session may complete the "all blocked"
                # condition for a waiter of ANY kind.  Mid-flush the
                # predicate can't be acted on anyway (waiters are parked
                # untimed and re-evaluate at flush end), so skip the
                # broadcast rather than charge every parked waiter a
                # spurious wakeup.
                if not self._flushing:
                    self._notify(self._queues)

    # -- protocol ----------------------------------------------------------

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        return self._call("generate", list(requests), self.inner.generate)

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        return self._call("score", list(requests), self.inner.score)

    def score_matrix(self, requests: Sequence[Any]) -> List[Any]:
        """(candidates x agents) utility matrices through the batching seam:
        queued like any other kind and routed to the inner backend's fused
        path (or the exact per-call fallback for backends without one)."""
        return self._call(
            "score_matrix", list(requests), self._score_matrix_inner
        )

    def _score_matrix_inner(self, requests: List[Any]) -> List[Any]:
        from consensus_tpu_torch.backends.score_matrix import score_matrix_many

        return score_matrix_many(self.inner, requests)

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        return self._call(
            "next_token", list(requests), self.inner.next_token_logprobs
        )

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self._call("embed", list(texts), self.inner.embed)
        return np.asarray(out)

    # -- core --------------------------------------------------------------

    def _window_s(self, kind: str) -> float:
        """Quiescence window before a timeout flush.

        A flat 10 ms window fragments phase transitions: decode steps are
        weights-bound, so a 4-row 700-token generate costs nearly the same
        multi-second wall as a 48-row one, yet the first run to reach a new
        phase used to flush its rows solo while its 29 siblings were still
        parsing the previous phase host-side.  Patience worth ~5% of the
        queued batch's expected decode wall (~8 ms/step) is host-side noise
        next to the dispatch it saves; cheap calls keep the fast window, and
        the all-blocked fast path still flushes singleton sessions
        immediately."""
        if kind != "generate":
            return self.flush_s
        queued = self._queues["generate"]
        if not queued:
            return self.flush_s
        longest = max(r.max_tokens for e in queued for r in e.requests)
        # Cap only the scaled term: a configured flush_s above the cap is an
        # operator choice that generate must honor like every other kind.
        return max(self.flush_s, min(0.5, 0.05 * 0.008 * longest))

    def _call(self, kind: str, requests: List[Any], fn: Callable) -> Any:
        if not requests:
            return fn(requests)
        # A session's thread that queues a call hands the device on: the
        # flush (or engine iteration) that serves the call needs it, and the
        # engine's loop may wait on the session budget.
        self._device.give_up()
        probe = getattr(self._tls, "cancelled", None)
        if self.engine is not None:
            # Engine path: the iteration loop replaces both flush triggers
            # (all-blocked snapshot AND the quiescence timeout), so none of
            # the flush-reason/window accounting below runs.
            return self.engine.submit(kind, requests, probe=probe)
        entry = _Pending(requests, cancelled=probe)
        cond = self._conds[kind]
        with cond:
            self._queues[kind].append(entry)
            # An append changes the pending count that feeds EVERY kind's
            # all-blocked predicate, so it broadcasts across kinds — except
            # mid-flush, when nobody can act on the predicate (parked
            # waiters re-evaluate at flush end, which notifies every kind
            # whose queue refilled).
            if not self._flushing:
                self._notify(self._queues)
            while not entry.done:
                if self._flushing:
                    # A device batch is executing with the lock released.
                    # Snapshotted entries park on the dispatch condition:
                    # it is notified exactly when their own batch completes
                    # (or the flush aborts), so a completed generate batch
                    # never stampedes score waiters in the same flush, and
                    # generate requests that arrived AFTER the snapshot
                    # sleep on the queue condition until flush end.  Both
                    # waits are untimed: flush end / completion wakes them
                    # under the lock, so polling would only burn host
                    # cycles.  Waking here with the flush still running and
                    # this entry still pending means a wakeup was wasted.
                    if entry.in_flight:
                        self._dispatch_conds[kind].wait()
                    else:
                        cond.wait()
                    if self._flushing and not entry.done:
                        self._spurious_wakeups.labels(kind).inc()
                    continue
                pending = sum(len(q) for q in self._queues.values())
                ramped = self._started >= self.expected_sessions
                if ramped and pending >= max(self._active, 1):
                    # Every active session is blocked on a call: flush
                    # EVERYTHING — nobody is coming to widen any batch.
                    self._flush(tuple(self._queues), reason="all_blocked")
                elif not cond.wait(timeout=self._window_s(kind)):
                    # Quiescent for a full window (appends notify): flush
                    # THIS kind only — other kinds run their own windows
                    # (a 10 ms score timeout must not fragment a generate
                    # batch sitting out its longer patience window).  The
                    # wait released the lock, so another thread may have
                    # started a flush meanwhile: re-check before claiming.
                    if not self._flushing and not entry.done:
                        self._flush((kind,), reason="timeout")
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _flush(self, kinds: Sequence[str], reason: str = "all_blocked") -> None:
        """Snapshot the given kinds' queues and execute them with the lock
        RELEASED.

        Called with the lock held and ``_flushing`` False.  Releasing during
        the inner calls lets other sessions enqueue while the device is busy
        — their requests accumulate into one merged batch dispatched the
        moment this flush returns, which is what keeps phase-drifted sweep
        cells riding full-width device batches.  ``_flushing`` keeps the
        flush single-file (one chip; results must map back to their
        waiters)."""
        self._flushing = True
        snapshot: Dict[str, List[_Pending]] = {k: [] for k in self._queues}
        dropped_kinds = set()
        released = False
        try:
            for k in kinds:
                queue = self._queues[k]
                self._queues[k] = []
                live: List[_Pending] = []
                for entry in queue:
                    # Cancellation seam: consult the session's probe exactly
                    # once, here, before the entry joins the merged batch.
                    # Dropping pre-dispatch keeps sibling slices unchanged
                    # and spends zero device time on abandoned work.  A
                    # broken probe must not abort the whole flush — treat it
                    # as not cancelled.
                    probe = entry.cancelled
                    try:
                        is_cancelled = probe is not None and probe()
                    except Exception:
                        is_cancelled = False
                    if is_cancelled:
                        entry.error = RequestCancelled(
                            f"session cancelled before its {k} call "
                            "dispatched"
                        )
                        entry.done = True
                        self._cancelled_requests.labels(k).inc()
                        dropped_kinds.add(k)
                    else:
                        entry.in_flight = True
                        live.append(entry)
                snapshot[k] = live
            # Snapshotted kinds' waiters may be sitting in TIMED queue-cond
            # waits; wake them (still under the lock) so they re-park on the
            # dispatch condition — otherwise they'd miss their completion
            # wakeup and sleep out the rest of their quiescence window.
            # Kinds that only had entries DROPPED also wake: those waiters'
            # entries are done (RequestCancelled) and must return now.
            self._notify(
                k for k in kinds if snapshot[k] or k in dropped_kinds
            )
            self._lock.release()
            released = True
            self._run_batches(snapshot, reason)
        finally:
            # Guard the WHOLE flush, not just _run_batches: an abort during
            # the snapshot/release lines must still clear _flushing (waiters
            # park in an untimed wait) and fail stranded entries.
            if released:
                self._lock.acquire()
            self._flushing = False
            # A non-Exception abort (KeyboardInterrupt between per-kind
            # dispatches) can leave snapshotted entries undone AND already
            # off their queues; without this their waiters would block
            # forever.  Normal completion marks every entry done, so this
            # loop is a no-op on the happy path.
            for queue in snapshot.values():
                for entry in queue:
                    if not entry.done:
                        entry.error = RuntimeError(
                            "batch flush aborted before this request was "
                            "dispatched"
                        )
                        entry.done = True
            # Flush end wakes only conditions that can have a waiter parked:
            # snapshot kinds' DISPATCH conditions (happy-path waiters
            # already woke mid-flush and are gone — this covers the abort
            # path that errored entries just above) and the QUEUE conditions
            # of kinds whose queues refilled during the flush (those waiters
            # sat out the untimed wait and must re-evaluate now that
            # _flushing cleared).
            for k, q in snapshot.items():
                if q:
                    self._dispatch_conds[k].notify_all()
            self._notify(k for k, q in self._queues.items() if q)

    def _run_batches(
        self, snapshot: Dict[str, List[_Pending]], reason: str
    ) -> None:
        """Dispatch each kind's merged batch; no lock held (waiters re-check
        ``entry.done`` under the lock after the flush-end notify)."""
        for kind, fn in (
            ("generate", self.inner.generate),
            ("score", self.inner.score),
            ("next_token", self.inner.next_token_logprobs),
            ("embed", self.inner.embed),
            ("score_matrix", self._score_matrix_inner),
        ):
            queue = snapshot[kind]
            if not queue:
                continue
            merged: List[Any] = []
            now = time.perf_counter()
            for entry in queue:
                merged.extend(entry.requests)
                self._queue_wait.labels(kind).observe(now - entry.enqueued)
            self._flushes.labels(kind, reason).inc()
            self._batch_fill.labels(kind).observe(len(queue))
            self._merged_requests.labels(kind).inc(len(merged))
            self.batch_counts[kind] += 1
            # Identical score rows across co-batched sessions (beam rounds
            # re-scoring shared prefixes, matrix fallbacks repeating agent
            # rows) compute once and fan back out.
            dispatch = merged
            mapping = None
            if kind == "score":
                from consensus_tpu_torch.backends.score_matrix import (
                    dedup_score_requests,
                )

                dispatch, mapping = dedup_score_requests(merged)
                if len(dispatch) < len(merged):
                    self._score_dedup.inc(len(merged) - len(dispatch))
            try:
                results = fn(dispatch)
                if mapping is not None:
                    from consensus_tpu_torch.backends.score_matrix import (
                        expand_deduped,
                    )

                    results = expand_deduped(results, mapping)
                cursor = 0
                for entry in queue:
                    n = len(entry.requests)
                    if kind == "embed":
                        entry.result = np.asarray(results[cursor : cursor + n])
                    else:
                        entry.result = list(results[cursor : cursor + n])
                    cursor += n
                    entry.done = True
            except PartialBatchError as exc:
                # Typed per-row propagation (supervisor poison isolation):
                # a waiter whose rows all survived gets its slice; a waiter
                # owning a failed row gets that row's typed error — one bad
                # row fails one session's call, not the whole device batch.
                if mapping is not None:
                    from consensus_tpu_torch.backends.score_matrix import (
                        expand_partial_error,
                    )

                    exc = expand_partial_error(exc, mapping)
                self._distribute_partial(kind, queue, exc)
            except Exception as exc:  # fail every waiter in this batch
                for entry in queue:
                    entry.error = exc
                    entry.done = True
            # Wake this kind's completed waiters NOW rather than at flush
            # end: their host-side work (parsing, prompt building) overlaps
            # the remaining kinds' device dispatches — mid-flush waiters
            # park in an untimed wait and would otherwise sleep out the
            # whole flush.  Only THIS kind's DISPATCH condition is notified,
            # and only snapshotted (now done) entries wait there: other
            # kinds' waiters have nothing new to learn, and same-kind
            # requests that arrived after the snapshot park on the queue
            # condition until flush end — so every wakeup issued here finds
            # a finished entry (the spurious-wakeup counter pins this at
            # zero).
            cond = self._dispatch_conds[kind]
            with cond:
                cond.notify_all()

    def _distribute_partial(
        self, kind: str, queue: List[_Pending], exc: PartialBatchError
    ) -> None:
        """Slice a PartialBatchError back onto its waiters.

        Entries with only surviving rows get their result slice (the same
        as a clean batch's: per-request keys).  Entries owning failed rows
        get the typed row error — the single-row error itself when the
        whole slice failed, or a per-entry PartialBatchError when the entry
        mixes good and bad rows."""
        cursor = 0
        for entry in queue:
            n = len(entry.requests)
            slice_errors = {
                i - cursor: err
                for i, err in exc.row_errors.items()
                if cursor <= i < cursor + n
            }
            if not slice_errors:
                if kind == "embed":
                    entry.result = np.asarray(exc.results[cursor : cursor + n])
                else:
                    entry.result = list(exc.results[cursor : cursor + n])
            else:
                self._row_errors.labels(kind).inc(len(slice_errors))
                if len(slice_errors) == n:
                    entry.error = next(iter(slice_errors.values()))
                else:
                    entry.error = PartialBatchError(
                        f"{len(slice_errors)}/{n} rows of this session's "
                        f"{kind} call failed inside a merged device batch",
                        results=list(exc.results[cursor : cursor + n]),
                        row_errors=slice_errors,
                    )
            cursor += n
            entry.done = True
