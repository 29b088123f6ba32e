"""Backend supervision: retry, integrity guards, poison-row isolation,
and a circuit breaker — at the one seam every model call crosses.

:class:`SupervisedBackend` wraps any :class:`~consensus_tpu_torch.backends.base.
Backend` and turns raw transport failures into the typed taxonomy of
``backends/base.py``:

* **Bounded retry with backoff.**  Raw transient exceptions
  (``RuntimeError``/``TimeoutError``/``ConnectionError``/``OSError``, and
  ``TransientBackendError`` from a nested supervisor) are retried up to
  ``max_retries`` times with exponential backoff; exhaustion raises
  :class:`TransientBackendError`.  Because backends are batch-composition
  invariant (per-request PRNG keys), a successful retry returns results
  bit-identical to a never-faulted call — chaos tests pin this.
* **Integrity guards.**  ``score`` / ``next_token_logprobs`` / ``embed``
  outputs are scanned for NaN/Inf.  A poisoned row is deterministic, so it
  is NEVER retried: with siblings present the call raises
  :class:`PartialBatchError` (valid rows ride along), alone it raises
  :class:`BackendIntegrityError`.  ``BatchingBackend`` unpacks the partial
  error so one bad row fails one waiter, not the whole device batch.
* **Batch bisection.**  When the inner call itself raises a DETERMINISTIC
  error on a multi-row batch, the supervisor bisects: halves re-execute
  until the failing row(s) are isolated, surviving rows return normally.
  (Safe because results are batch-composition invariant.)
* **Circuit breaker.**  ``failure_threshold`` consecutive transient/lost
  failures open the breaker; while open, calls fail fast with
  :class:`BackendLostError` instead of burning the retry budget.  After
  ``cooldown_s`` one probe call is let through (half-open): success closes
  the breaker, failure re-opens it.  State is exported as the
  ``supervisor_breaker_state`` gauge (0 closed / 1 half-open / 2 open) and
  surfaced by serve's ``/healthz``; the scheduler checks
  :meth:`CircuitBreaker.admission_allowed` to reject with
  ``SchedulerRejected(reason="breaker_open")`` → HTTP 503.

Obs families: ``supervisor_retries_total{op}``,
``supervisor_integrity_failures_total{op}``,
``supervisor_bisections_total{op}``, ``supervisor_breaker_state``,
``supervisor_breaker_opens_total``.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from consensus_tpu_torch.backends.base import (
    Backend,
    BackendError,
    BackendIntegrityError,
    BackendLostError,
    GenerationRequest,
    GenerationResult,
    NextTokenRequest,
    PartialBatchError,
    ScoreRequest,
    ScoreResult,
    TokenCandidate,
    TransientBackendError,
)
from consensus_tpu_torch.obs.metrics import Registry, get_registry

logger = logging.getLogger(__name__)

#: Raw exception types the supervisor treats as transient.  Typed
#: BackendError subclasses other than TransientBackendError are excluded
#: even though device runtimes raise RuntimeError: integrity/lost failures
#: are deterministic by definition.
_RAW_TRANSIENT = (RuntimeError, TimeoutError, ConnectionError, OSError)

_STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, TransientBackendError):
        return True
    if isinstance(exc, BackendError):
        return False
    return isinstance(exc, _RAW_TRANSIENT)


class CircuitBreaker:
    """closed → open after N consecutive failures → half-open probe.

    Thread-safe; ``clock`` is injectable so tests drive the cooldown
    without sleeping.  Two consumer surfaces:

    * :meth:`allow_call` — the supervisor asks before every backend call.
      Open + cooldown elapsed transitions to half-open and admits the call
      as the probe; open otherwise refuses (fail fast).  Half-open admits
      (the probe request may issue several backend calls).
    * :meth:`admission_allowed` — the serving scheduler asks at admission.
      Half-open admits exactly ONE request per cooldown window so a wave
      of retries cannot stampede a recovering device.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[Registry] = None,
        name: str = "backend",
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._name = name
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_admitted_at: Optional[float] = None
        reg = registry if registry is not None else get_registry()
        self._m_state = reg.gauge(
            "supervisor_breaker_state",
            "Circuit breaker state: 0 closed, 1 half-open, 2 open.",
            labels=("name",),
        ).labels(name)
        self._m_opens = reg.counter(
            "supervisor_breaker_opens_total",
            "Transitions into the open state.",
            labels=("name",),
        ).labels(name)
        self._m_state.set(0.0)

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        """Caller holds the lock.  ``open`` lazily decays to ``half_open``
        once the cooldown elapses (no background timer thread)."""
        if self._state == "open" and (
            self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._to("half_open")
            self._probe_admitted_at = None
        return self._state

    def _to(self, state: str) -> None:
        if state == "open" and self._state != "open":
            # Flight-recorder breadcrumb: breaker opens are exactly the
            # fleet events a postmortem wants next to the iteration rows.
            from consensus_tpu_torch.obs.trace import get_flight_recorder

            get_flight_recorder().record_event(
                "breaker_open", breaker=self._name,
                consecutive_failures=self._consecutive_failures)
        self._state = state
        self._m_state.set(_STATE_VALUES[state])

    def snapshot(self) -> Dict[str, Any]:
        """Live breaker facts for /healthz."""
        with self._lock:
            state = self._effective_state()
            remaining = 0.0
            if state == "open":
                remaining = max(
                    0.0, self._opened_at + self.cooldown_s - self._clock()
                )
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_remaining_s": round(remaining, 3),
            }

    def retry_after_s(self) -> float:
        """Suggested client backoff (the Retry-After header on 503s)."""
        return max(1.0, math.ceil(self.snapshot()["cooldown_remaining_s"]))

    # -- consumer surfaces ---------------------------------------------------

    def allow_call(self) -> bool:
        with self._lock:
            return self._effective_state() != "open"

    def admission_allowed(self) -> bool:
        with self._lock:
            state = self._effective_state()
            if state == "closed":
                return True
            if state == "open":
                return False
            # half-open: one probe per cooldown window.  A probe whose
            # request died before reporting back must not wedge the
            # breaker, so a stale probe slot reopens after cooldown_s.
            now = self._clock()
            if (
                self._probe_admitted_at is None
                or now - self._probe_admitted_at >= self.cooldown_s
            ):
                self._probe_admitted_at = now
                return True
            return False

    # -- outcome reporting ---------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != "closed":
                self._to("closed")
            self._probe_admitted_at = None

    def record_failure(self) -> None:
        with self._lock:
            state = self._effective_state()
            self._consecutive_failures += 1
            if state == "half_open":
                # The probe failed: straight back to open, fresh cooldown.
                self._opened_at = self._clock()
                self._to("open")
                self._m_opens.inc()
                self._probe_admitted_at = None
            elif (
                state == "closed"
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._to("open")
                self._m_opens.inc()


def _finite(value: float) -> bool:
    return math.isfinite(value)


def _check_score(result: ScoreResult) -> bool:
    return all(_finite(lp) for lp in result.logprobs)


def _check_next_token(candidates: List[TokenCandidate]) -> bool:
    return all(_finite(c.logprob) for c in candidates)


def _check_embed_row(row: np.ndarray) -> bool:
    return bool(np.isfinite(row).all())


class SupervisedBackend:
    """Wrap ``inner`` with retry, integrity guards, bisection, and the
    circuit breaker (module docstring for the full contract)."""

    name = "supervised"

    def __init__(
        self,
        inner: Backend,
        max_retries: int = 2,
        backoff_s: float = 0.05,
        failure_threshold: int = 5,
        cooldown_s: float = 5.0,
        guard_nonfinite: bool = True,
        breaker: Optional[CircuitBreaker] = None,
        registry: Optional[Registry] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.inner = inner
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.guard_nonfinite = bool(guard_nonfinite)
        #: Latched when the INNER backend raises BackendLostError (not when
        #: the breaker refuses a call): the device under this supervisor is
        #: gone for good.  Fleet health checks read this as the passive
        #: "replica lost" signal without waiting for the breaker to trip.
        self.backend_lost = False
        self._sleep = sleep
        reg = registry if registry is not None else get_registry()
        self.circuit_breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=failure_threshold,
            cooldown_s=cooldown_s,
            clock=clock,
            registry=reg,
            name=getattr(inner, "name", "backend"),
        )
        self._m_retries = reg.counter(
            "supervisor_retries_total",
            "Transient backend failures retried at the supervision seam.",
            labels=("op",),
        )
        self._m_integrity = reg.counter(
            "supervisor_integrity_failures_total",
            "Rows failed by the NaN/Inf integrity guard or isolated by "
            "bisection.",
            labels=("op",),
        )
        self._m_bisections = reg.counter(
            "supervisor_bisections_total",
            "Batch bisection passes run to isolate deterministic poison rows.",
            labels=("op",),
        )

    # -- passthrough surface -------------------------------------------------

    @property
    def deterministic_greedy(self) -> bool:
        return bool(getattr(self.inner, "deterministic_greedy", False))

    @property
    def token_counts(self):
        return getattr(self.inner, "token_counts", {})

    # -- protocol ------------------------------------------------------------

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        return self._supervised("generate", list(requests), self.inner.generate)

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        return self._supervised(
            "score", list(requests), self.inner.score, check=_check_score
        )

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        return self._supervised(
            "next_token", list(requests), self.inner.next_token_logprobs,
            check=_check_next_token,
        )

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = self._supervised(
            "embed", list(texts), self.inner.embed, check=_check_embed_row
        )
        return np.asarray(out)

    # -- core ----------------------------------------------------------------

    def _supervised(
        self,
        op: str,
        requests: List[Any],
        fn: Callable,
        check: Optional[Callable[[Any], bool]] = None,
    ) -> Any:
        if not requests:
            return fn(requests)
        if not self.circuit_breaker.allow_call():
            raise BackendLostError(
                f"circuit breaker open: refusing {op} call "
                f"({self.circuit_breaker.snapshot()})"
            )
        attempt = 0
        while True:
            try:
                results = fn(requests)
            except (BackendLostError, BackendIntegrityError,
                    PartialBatchError) as exc:
                if isinstance(exc, BackendLostError):
                    self.backend_lost = True
                self.circuit_breaker.record_failure()
                raise
            except Exception as exc:
                if _is_transient(exc):
                    self.circuit_breaker.record_failure()
                    attempt += 1
                    if attempt > self.max_retries:
                        raise TransientBackendError(
                            f"{op} failed after {attempt} attempt(s): "
                            f"{type(exc).__name__}: {exc}"
                        ) from exc
                    if not self.circuit_breaker.allow_call():
                        raise BackendLostError(
                            f"circuit breaker opened while retrying {op}"
                        ) from exc
                    self._m_retries.labels(op).inc()
                    self._sleep(self.backoff_s * (2 ** (attempt - 1)))
                    continue
                # Deterministic failure: retrying reproduces it, but with
                # siblings in the batch we can still isolate the poison.
                if len(requests) > 1:
                    results, row_errors = self._bisect(op, fn, requests)
                    return self._resolve(op, requests, results, row_errors,
                                         check)
                raise BackendIntegrityError(
                    f"{op} row failed deterministically: "
                    f"{type(exc).__name__}: {exc}"
                ) from exc
            break
        self.circuit_breaker.record_success()
        return self._resolve(op, requests, results, {}, check)

    def _resolve(
        self,
        op: str,
        requests: List[Any],
        results: Any,
        row_errors: Dict[int, BaseException],
        check: Optional[Callable[[Any], bool]],
    ) -> Any:
        if check is not None and self.guard_nonfinite:
            for i in range(len(requests)):
                if i in row_errors:
                    continue
                row = results[i]
                if row is not None and not check(row):
                    row_errors[i] = BackendIntegrityError(
                        f"{op} row {i} returned non-finite values "
                        "(NaN/Inf); deterministic, not retried"
                    )
        if not row_errors:
            return results
        self._m_integrity.labels(op).inc(len(row_errors))
        if len(row_errors) == len(requests):
            raise BackendIntegrityError(
                f"every row of a {len(requests)}-row {op} batch failed: "
                f"{next(iter(row_errors.values()))}"
            )
        raise PartialBatchError(
            f"{len(row_errors)}/{len(requests)} rows of a {op} batch "
            f"failed; surviving rows ride along",
            results=results,
            row_errors=row_errors,
        )

    def _bisect(
        self, op: str, fn: Callable, requests: List[Any]
    ) -> tuple:
        """Isolate deterministically-failing rows by halving.  Safe because
        results are batch-composition invariant (per-request PRNG keys);
        costs O(bad_rows * log n) extra dispatches only on the failure
        path."""
        self._m_bisections.labels(op).inc()
        results: List[Any] = [None] * len(requests)
        row_errors: Dict[int, BaseException] = {}

        def solve(lo: int, hi: int) -> None:
            try:
                sub = fn(requests[lo:hi])
            except Exception as exc:
                if hi - lo == 1:
                    row_errors[lo] = (
                        exc if isinstance(exc, BackendError)
                        else BackendIntegrityError(
                            f"{op} row {lo} failed deterministically: "
                            f"{type(exc).__name__}: {exc}"
                        )
                    )
                    return
                mid = (lo + hi) // 2
                solve(lo, mid)
                solve(mid, hi)
                return
            for offset, row in enumerate(sub):
                results[lo + offset] = row
        solve(0, len(requests))
        return results, row_errors
