"""Cross-run device batching (PyTorch port of
``consensus_tpu/backends/batching.py``, its flush-snapshot path).

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

The JAX package's continuous-batching decode engine (``engine=True``, its
constructor default) waits for the serving port (ROADMAP.md, queue A8) and
raises here; this constructor defaults to ``engine=False``.  ``Experiment``
passes ``engine=False`` in both packages, so the flush-snapshot path is the
one experiments run.
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
    __slots__ = ("requests", "result", "error", "done", "enqueued", "in_flight")

    def __init__(self, requests):
        self.requests = requests
        self.result = None
        self.error = None
        self.done = False
        self.enqueued = time.perf_counter()
        #: True once a flush has snapshotted this entry off its queue — its
        #: waiter then parks on the kind's DISPATCH condition, which is only
        #: notified when the entry's own batch completes (or aborts).
        self.in_flight = False


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
    """Merge concurrent sessions' backend calls into shared device batches."""

    name = "batching"

    def __init__(
        self,
        inner: Backend,
        flush_ms: float = 10.0,
        expected_sessions: int = 1,
        registry: Optional[Registry] = None,
        engine: bool = False,
    ):
        if engine:
            raise NotImplementedError(
                "BatchingBackend(engine=True), the continuous-batching decode "
                "engine, is not ported yet (ROADMAP.md, queue A8)"
            )
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
        #: The JAX engine's dedup family: identical score rows merged into
        #: one flush are computed once.
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
        return _TurnTakingSession(maker(spec), self._device)

    def close(self) -> None:
        """Nothing to stop: the flush-snapshot path holds no threads of its
        own (the JAX engine path stops its iteration loop here)."""

    def _notify(self, kinds) -> None:
        """Wake the given kinds' waiters.  Caller holds ``_lock`` (every
        per-kind condition shares it)."""
        for kind in kinds:
            self._conds[kind].notify_all()

    @contextlib.contextmanager
    def session(self):
        """Register the calling thread as an active run for flush accounting."""
        with self._lock:
            self._active += 1
            self._started += 1
        try:
            yield self
        finally:
            # A run that left a fused session open must not keep the device.
            self._device.give_up()
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
        # flush that serves the call needs it.
        self._device.give_up()
        entry = _Pending(requests)
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
        released = False
        try:
            for k in kinds:
                snapshot[k], self._queues[k] = self._queues[k], []
                for entry in snapshot[k]:
                    entry.in_flight = True
            # Snapshotted kinds' waiters may be sitting in TIMED queue-cond
            # waits; wake them (still under the lock) so they re-park on the
            # dispatch condition — otherwise they'd miss their completion
            # wakeup and sleep out the rest of their quiescence window.
            self._notify(k for k in kinds if snapshot[k])
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
