"""Thin wrappers around the program's backend seam; none changes a call.

``StatementLog`` sits above the batching layer, one per statement: it keeps
every request and result the method exchanged with the backend, and every
step of its token-search session, so the correctness check can judge what
the timed path produced.  ``CallTimer`` sits below the batching layer, on
the device side: it stamps each call into the model backend on the host
clock, for the spans that ``score_s_share`` and the trace's idle gaps read.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Tuple


class _Delegate:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class RecordedSession(_Delegate):
    """A token-search session whose opening proposals and advances are kept:
    ``steps[0]`` = ((), (), proposals), then (parents, chosen ids,
    proposals) per advance."""

    def __init__(self, inner, spec, kind: str):
        super().__init__(inner)
        self.spec, self.kind = spec, kind
        self.steps: List[Tuple[tuple, tuple, list]] = []

    def propose(self):
        proposals = self.inner.propose()
        self.steps.append(((), (), proposals))
        return proposals

    def advance_and_propose(self, parents, chosen):
        proposals = self.inner.advance_and_propose(parents, chosen)
        self.steps.append((tuple(int(p) for p in parents), tuple(c.token_id for c in chosen), proposals))
        return proposals

    def close(self):
        # Drop the session once closed: it holds the backend and its weights.
        self.inner.close()
        self.inner = None


class StatementLog(_Delegate):
    """One statement's view of the backend.  ``calls`` holds (kind,
    requests, results) in call order; ``sessions`` the recorded sessions."""

    name = "statement-log"

    def __init__(self, inner):
        super().__init__(inner)
        self.calls: List[Tuple[str, list, Any]] = []
        self.sessions: List[RecordedSession] = []

    def _keep(self, kind: str, requests, fn):
        requests = list(requests)
        results = fn(requests)
        self.calls.append((kind, requests, results))
        return results

    def generate(self, requests):
        return self._keep("generate", requests, self.inner.generate)

    def score(self, requests):
        return self._keep("score", requests, self.inner.score)

    def score_matrix(self, requests):
        return self._keep("score_matrix", requests, self.inner.score_matrix)

    def next_token_logprobs(self, requests):
        return self._keep("next_token", requests, self.inner.next_token_logprobs)

    def open_fused_token_search(self, spec):
        """The session factory's own choice (``session.open_token_search``):
        the fused session, or the full-prefix session over this backend
        when the fused one declines."""
        from consensus_tpu_torch.backends.session import (
            FusedSessionUnavailable,
            PrefixTokenSearchSession,
        )

        try:
            session, kind = self.inner.open_fused_token_search(spec), "fused"
        except FusedSessionUnavailable:
            session, kind = PrefixTokenSearchSession(self, spec), "prefix"
        recorded = RecordedSession(session, spec, kind)
        self.sessions.append(recorded)
        return recorded


class _TimedSession(_Delegate):
    def __init__(self, inner, timer: "CallTimer"):
        super().__init__(inner)
        self._timer = timer

    def propose(self):
        return self._timer.timed("session", self.inner.propose)

    def advance_and_propose(self, parents, chosen):
        return self._timer.timed("session", self.inner.advance_and_propose, parents, chosen)

    def close(self):
        return self.inner.close()


class CallTimer(_Delegate):
    """The model backend, with each call's (kind, start, end) kept on the
    host clock.  Every call returns host values, so its end is the end of
    its device work."""

    def __init__(self, inner):
        super().__init__(inner)
        self._lock = threading.Lock()
        self.spans: List[Tuple[str, float, float]] = []

    def timed(self, kind: str, fn, *args):
        start = time.perf_counter()
        try:
            return fn(*args)
        finally:
            end = time.perf_counter()
            with self._lock:
                self.spans.append((kind, start, end))

    def generate(self, requests, *args, **kwargs):
        return self.timed("generate", lambda: self.inner.generate(requests, *args, **kwargs))

    def score(self, requests):
        return self.timed("score", self.inner.score, requests)

    def score_matrix(self, requests):
        return self.timed("score_matrix", self.inner.score_matrix, requests)

    def next_token_logprobs(self, requests):
        return self.timed("next_token", self.inner.next_token_logprobs, requests)

    def open_fused_token_search(self, spec):
        return _TimedSession(self.timed("session_open", self.inner.open_fused_token_search, spec), self)
