"""Request-scoped tracing, iteration ledger, flight recorder, rolling windows.

The serving plane's request-scoped observability (a copy of
``consensus_tpu/obs/trace.py``):

* ``TraceContext`` — a per-request span tree.  A trace is minted in the
  HTTP frontend (trace id == request id), carried on the ticket through
  the scheduler and the fleet router, and into the engine's slot
  lifecycle.  Spans are recorded with ``time.perf_counter()`` so the
  critical-path decomposition sums exactly; a single ``time.time()``
  anchor per trace gives wall-clock alignment for export.

* ``trace_current()`` / ``use_trace()`` — a thread-local carrier so call
  sites that cannot grow new parameters (``scheduler.submit``,
  ``engine.submit``) can pick up the active (trace, parent span) pair.

* ``TraceStore`` — a bounded LRU of recent traces backing
  ``GET /v1/trace/<id>``.

* ``IterationLedger`` — per-iteration records splitting engine wall time
  into host phases (sweep/admit/prefill/cohort/merge) vs device dispatch
  vs idle, aggregated into an ``mfu_attribution`` report.  All timing is
  ``perf_counter``-based and the residual is attributed explicitly, so
  coverage is ~1.0 by construction (the >=95% acceptance bar).

* ``FlightRecorder`` — bounded ring buffers of recent iteration rows and
  fleet events (replica loss, watchdog trip, breaker open, quarantine,
  scale events), dumped atomically to ``blackbox.json`` on watchdog
  trip, replica loss, or SIGTERM.

* ``RollingWindow`` — time-bucketed rps/p95/availability so loadgen can
  report recovery *curves* for chaos and elastic runs.

Everything here is pure stdlib and thread-safe; nothing raises into the
serving path.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "TraceContext",
    "TraceStore",
    "get_trace_store",
    "trace_current",
    "use_trace",
    "IterationLedger",
    "FlightRecorder",
    "get_flight_recorder",
    "RollingWindow",
]

# Bounds keeping a single trace (and the store) from growing without
# limit under adversarial or pathological workloads.
MAX_SPANS_PER_TRACE = 512
MAX_EVENTS_PER_SPAN = 128
DEFAULT_STORE_CAPACITY = 256

# Critical-path phase priority: when intervals overlap, the earlier
# phase in this tuple claims the elementary segment.  Device work
# (decode/prefill) outranks waiting; waiting outranks failover overhead
# (which only claims time nothing else explains).
_PHASE_PRIORITY = (
    "decode",
    "prefill",
    "admission_wait",
    "score",
    "queue_wait",
    "failover_overhead",
)


# ---------------------------------------------------------------------------
# TraceContext


class TraceContext:
    """A per-request span tree.

    Span ids are small ints handed back by :meth:`begin`; id ``0`` is a
    sentinel meaning "dropped / no span" and every operation on it is a
    no-op, so call sites never need to branch on the span cap.
    """

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.created_wall = time.time()
        self.created_perf = time.perf_counter()
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._next_id = 1
        self._spans: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()

    def begin(self, name: str, parent: Optional[int] = None, **attrs: Any) -> int:
        with self._lock:
            if len(self._spans) >= MAX_SPANS_PER_TRACE:
                self.dropped_spans += 1
                return 0
            span_id = self._next_id
            self._next_id += 1
            self._spans[span_id] = {
                "id": span_id,
                "name": name,
                "parent": int(parent) if parent else None,
                "t_start": time.perf_counter(),
                "t_end": None,
                "attrs": dict(attrs),
                "events": [],
            }
            return span_id

    def end(self, span_id: int, **attrs: Any) -> None:
        if not span_id:
            return
        with self._lock:
            span = self._spans.get(span_id)
            if span is None:
                return
            if attrs:
                span["attrs"].update(attrs)
            if span["t_end"] is None:  # idempotent: first end() wins
                span["t_end"] = time.perf_counter()

    def annotate(self, span_id: int, **attrs: Any) -> None:
        if not span_id:
            return
        with self._lock:
            span = self._spans.get(span_id)
            if span is not None:
                span["attrs"].update(attrs)

    def event(self, span_id: int, name: str, **attrs: Any) -> None:
        if not span_id:
            return
        with self._lock:
            span = self._spans.get(span_id)
            if span is None or len(span["events"]) >= MAX_EVENTS_PER_SPAN:
                return
            span["events"].append(
                {"name": name, "t": time.perf_counter(), "attrs": dict(attrs)}
            )

    # -- export ------------------------------------------------------------

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "id": s["id"],
                    "name": s["name"],
                    "parent": s["parent"],
                    "t_start": s["t_start"],
                    "t_end": s["t_end"],
                    "attrs": dict(s["attrs"]),
                    "events": [dict(e) for e in s["events"]],
                }
                for s in self._spans.values()
            ]

    def to_dict(self) -> Dict[str, Any]:
        spans = self._snapshot()
        anchor = min((s["t_start"] for s in spans), default=self.created_perf)
        now = time.perf_counter()
        out: List[Dict[str, Any]] = []
        for s in spans:
            end = s["t_end"] if s["t_end"] is not None else now
            row = {
                "id": s["id"],
                "name": s["name"],
                "parent": s["parent"],
                "start_s": round(s["t_start"] - anchor, 6),
                "duration_s": round(max(0.0, end - s["t_start"]), 6),
                "in_flight": s["t_end"] is None,
                "attrs": s["attrs"],
            }
            if s["events"]:
                row["events"] = [
                    {
                        "name": e["name"],
                        "t_s": round(e["t"] - anchor, 6),
                        "attrs": e["attrs"],
                    }
                    for e in s["events"]
                ]
            out.append(row)
        return {
            "trace_id": self.trace_id,
            "created_wall": self.created_wall,
            "dropped_spans": self.dropped_spans,
            "spans": out,
        }

    # -- critical path -----------------------------------------------------

    def critical_path(self) -> Dict[str, Any]:
        """Decompose the root span's wall time into exclusive phases.

        Phase intervals are clipped to the root interval and swept over
        elementary segments; overlaps resolve by ``_PHASE_PRIORITY`` and
        any residual is attributed to ``other_host``, so the phases sum
        to the root duration exactly.
        """
        spans = self._snapshot()
        if not spans:
            return {"total_s": 0.0, "phases": {}}
        now = time.perf_counter()

        def _end(s: Dict[str, Any]) -> float:
            return s["t_end"] if s["t_end"] is not None else now

        roots = [s for s in spans if s["parent"] is None]
        root = min(roots or spans, key=lambda s: s["t_start"])
        r0, r1 = root["t_start"], _end(root)
        if r1 <= r0:
            return {"total_s": 0.0, "phases": {}}

        children: Dict[Optional[int], List[Dict[str, Any]]] = {}
        for s in spans:
            children.setdefault(s["parent"], []).append(s)

        dispatches = [s for s in spans if s["name"] == "dispatch"]
        final = None
        for s in dispatches:
            if s["attrs"].get("final"):
                final = s
        if final is None and dispatches:
            final = max(dispatches, key=lambda s: s["t_start"])

        # Spans considered for device/score/admission phases: the final
        # dispatch's subtree when dispatches exist (losing attempts only
        # contribute failover_overhead), everything otherwise.
        if final is not None:
            scope_ids = set()
            stack = [final["id"]]
            while stack:
                sid = stack.pop()
                scope_ids.add(sid)
                stack.extend(c["id"] for c in children.get(sid, ()))
            scoped = [s for s in spans if s["id"] in scope_ids]
        else:
            scoped = spans

        intervals: List[Tuple[str, float, float]] = []

        def _add(phase: str, a: float, b: float) -> None:
            a, b = max(a, r0), min(b, r1)
            if b > a:
                intervals.append((phase, a, b))

        for s in spans:
            if s["name"] == "queue_wait":
                _add("queue_wait", s["t_start"], _end(s))
        for s in scoped:
            if s["name"] == "engine_row":
                events = {e["name"]: e["t"] for e in s["events"]}
                admitted = events.get("slot_admitted")
                prefilled = events.get("prefill_complete")
                row_end = _end(s)
                if admitted is not None:
                    _add("admission_wait", s["t_start"], admitted)
                    _add("prefill", admitted, prefilled if prefilled is not None else row_end)
                    if prefilled is not None:
                        _add("decode", prefilled, row_end)
                else:
                    _add("admission_wait", s["t_start"], row_end)
            elif s["name"] in (
                "engine_score",
                "engine_embed",
                "engine_next_token_logprobs",
                "engine_score_matrix",
            ):
                _add("score", s["t_start"], _end(s))
        if final is not None and len(dispatches) > 1:
            first = min(dispatches, key=lambda s: s["t_start"])
            _add("failover_overhead", first["t_start"], final["t_start"])

        # Elementary-segment sweep: at each segment the highest-priority
        # covering phase wins; uncovered time is host/other.
        cuts = sorted({r0, r1, *(a for _, a, _ in intervals), *(b for _, _, b in intervals)})
        rank = {p: i for i, p in enumerate(_PHASE_PRIORITY)}
        phases: Dict[str, float] = {p: 0.0 for p in _PHASE_PRIORITY}
        phases["other_host"] = 0.0
        for a, b in zip(cuts, cuts[1:]):
            covering = [p for p, s0, s1 in intervals if s0 <= a and b <= s1]
            if covering:
                winner = min(covering, key=lambda p: rank[p])
            else:
                winner = "other_host"
            phases[winner] += b - a
        total = r1 - r0
        return {
            "total_s": round(total, 6),
            "phases": {k: round(v, 6) for k, v in phases.items()},
        }


# ---------------------------------------------------------------------------
# Thread-local carrier

_tls = threading.local()


def trace_current() -> Optional[Tuple[TraceContext, Optional[int]]]:
    """The active (trace, parent span id) pair for this thread, if any."""
    return getattr(_tls, "active", None)


@contextlib.contextmanager
def use_trace(
    trace: Optional[TraceContext], parent: Optional[int] = None
) -> Iterator[None]:
    """Establish (trace, parent) as this thread's active trace context.

    A ``None`` trace makes this a passthrough, so call sites can wrap
    unconditionally.
    """
    if trace is None:
        yield
        return
    prev = getattr(_tls, "active", None)
    _tls.active = (trace, parent)
    try:
        yield
    finally:
        _tls.active = prev


# ---------------------------------------------------------------------------
# TraceStore


class TraceStore:
    """Bounded LRU of recent traces, keyed by trace id (== request id)."""

    def __init__(self, capacity: int = DEFAULT_STORE_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, TraceContext]" = OrderedDict()

    def put(self, trace: TraceContext) -> None:
        with self._lock:
            self._traces[trace.trace_id] = trace
            self._traces.move_to_end(trace.trace_id)
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def get(self, trace_id: str) -> Optional[TraceContext]:
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is not None:
                self._traces.move_to_end(trace_id)
            return trace

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


_STORE = TraceStore()


def get_trace_store() -> TraceStore:
    return _STORE


# ---------------------------------------------------------------------------
# IterationLedger


class IterationLedger:
    """Per-iteration wall-time attribution for the decode engine.

    Each ``record()`` call books one ``run_iteration`` worth of time:
    the host phases measured inside the iteration, the device time
    measured around the inner backend calls, the idle gap since the
    previous iteration ended, and an explicit ``other`` residual — so
    the aggregate ``mfu_attribution`` covers engine wall time by
    construction (the >=95% acceptance bar).
    """

    HOST_PHASES = ("sweep", "admit", "prefill", "cohort", "merge", "other")

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._rows: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(capacity)))
        self._iterations = 0
        self._tokens = 0
        self._device_s = 0.0
        self._dispatch_s = 0.0
        self._block_s = 0.0
        self._idle_s = 0.0
        self._host_s = {p: 0.0 for p in self.HOST_PHASES}
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._first_start: Optional[float] = None
        self._last_end: Optional[float] = None

    def record(
        self,
        *,
        start_s: float,
        end_s: float,
        idle_s: float,
        device_s: float = 0.0,
        dispatch_s: float = 0.0,
        block_s: float = 0.0,
        host: Dict[str, float],
        tokens: int = 0,
        cohort: int = 0,
        queue_depth: int = 0,
        pages_in_use: int = 0,
        spec_proposed: int = 0,
        spec_accepted: int = 0,
    ) -> Dict[str, Any]:
        # ``device_s`` is the legacy fused bracket around a blocking inner
        # call; callers that time async dispatch separately pass
        # ``dispatch_s`` (host time to enqueue device work) and ``block_s``
        # (time spent waiting on device results).  A legacy ``device_s``
        # books as pure block time — a blocking call IS a wait.
        dispatch_s = max(0.0, dispatch_s)
        block_s = max(0.0, block_s) + max(0.0, device_s)
        device_s = dispatch_s + block_s
        total = max(0.0, end_s - start_s)
        known_host = sum(max(0.0, host.get(p, 0.0)) for p in self.HOST_PHASES if p != "other")
        other = max(0.0, total - device_s - known_host)
        row = {
            "iteration": 0,  # patched under the lock below
            "total_s": round(total, 6),
            "idle_s": round(max(0.0, idle_s), 6),
            "device_s": round(max(0.0, device_s), 6),
            "dispatch_s": round(dispatch_s, 6),
            "block_s": round(block_s, 6),
            "host_s": {
                **{p: round(max(0.0, host.get(p, 0.0)), 6) for p in self.HOST_PHASES if p != "other"},
                "other": round(other, 6),
            },
            "tokens": int(tokens),
            "cohort": int(cohort),
            "queue_depth": int(queue_depth),
            "pages_in_use": int(pages_in_use),
            "spec_proposed": int(spec_proposed),
            "spec_accepted": int(spec_accepted),
        }
        with self._lock:
            self._iterations += 1
            row["iteration"] = self._iterations
            self._tokens += int(tokens)
            self._spec_proposed += int(spec_proposed)
            self._spec_accepted += int(spec_accepted)
            self._device_s += max(0.0, device_s)
            self._dispatch_s += dispatch_s
            self._block_s += block_s
            self._idle_s += max(0.0, idle_s)
            for p in self.HOST_PHASES:
                if p == "other":
                    self._host_s["other"] += other
                else:
                    self._host_s[p] += max(0.0, host.get(p, 0.0))
            if self._first_start is None:
                self._first_start = start_s - max(0.0, idle_s)
            self._last_end = end_s
            self._rows.append(row)
        return row

    def recent(self, n: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            rows = list(self._rows)
        return rows[-max(0, int(n)):]

    def mfu_attribution(self) -> Dict[str, Any]:
        with self._lock:
            iterations = self._iterations
            tokens = self._tokens
            device_s = self._device_s
            dispatch_s = self._dispatch_s
            block_s = self._block_s
            idle_s = self._idle_s
            host = dict(self._host_s)
            spec_proposed = self._spec_proposed
            spec_accepted = self._spec_accepted
            first = self._first_start
            last = self._last_end
        host_s = sum(host.values())
        accounted = device_s + idle_s + host_s
        wall_s = (last - first) if (first is not None and last is not None) else 0.0
        # Loop bookkeeping between the iteration end and the next
        # iteration start is booked as idle, so accounted can exceed the
        # strict first->last window by scheduling noise; coverage is
        # reported against the larger of the two.
        denom = max(wall_s, accounted) or 1.0
        return {
            "iterations": iterations,
            "tokens": tokens,
            "wall_s": round(wall_s, 6),
            "device_s": round(device_s, 6),
            "dispatch_s": round(dispatch_s, 6),
            "block_s": round(block_s, 6),
            "host_s": round(host_s, 6),
            "idle_s": round(idle_s, 6),
            "device_fraction": round(device_s / denom, 4),
            "dispatch_fraction": round(dispatch_s / denom, 4),
            "block_fraction": round(block_s / denom, 4),
            "host_fraction": round(host_s / denom, 4),
            "idle_fraction": round(idle_s / denom, 4),
            "host_breakdown": {k: round(v, 6) for k, v in host.items()},
            "coverage": round(accounted / denom, 4),
            "tokens_per_device_s": round(tokens / device_s, 2) if device_s > 0 else 0.0,
            # Speculative decode attribution: drafts proposed vs accepted
            # across every recorded iteration (0/0 when spec decode is off).
            "draft_proposed_tokens": spec_proposed,
            "draft_accepted_tokens": spec_accepted,
            "draft_acceptance_rate": round(
                spec_accepted / spec_proposed, 4
            ) if spec_proposed else 0.0,
            # The split is only meaningful under real async dispatch: on the
            # CPU backend the "device" executes host-synchronously, so
            # block_s contains the device compute itself and
            # device_fraction ~1.0 / host_fraction ~0 say nothing about
            # host-loop overhead — read those numbers from a GPU run.
            "note": (
                "dispatch_s = host enqueue time, block_s = waiting on device "
                "results; on CPU backends device execution is "
                "host-synchronous, so block_s includes device compute and "
                "the device/host split requires a GPU run to be meaningful."
            ),
        }


# ---------------------------------------------------------------------------
# FlightRecorder


class FlightRecorder:
    """Black-box ring buffers dumped atomically on fleet incidents.

    ``configure(path)`` arms the recorder; with no path configured,
    ``dump()`` is a no-op (recording still happens, so a late
    ``configure`` + ``dump`` captures the recent past).  Never raises
    into the serving path.
    """

    SCHEMA = "consensus_tpu_torch.blackbox.v1"

    def __init__(
        self,
        max_events: int = 512,
        max_iterations: int = 256,
        path: Optional[str] = None,
    ):
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(max_events)))
        self._iterations: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(max_iterations)))
        self._path = path
        self.dumps = 0
        self.last_dump_reason: Optional[str] = None

    def configure(self, path: Optional[str]) -> None:
        with self._lock:
            self._path = path

    @property
    def path(self) -> Optional[str]:
        with self._lock:
            return self._path

    def record_event(self, kind: str, **attrs: Any) -> None:
        event = {"kind": kind, "t_wall": time.time(), **attrs}
        with self._lock:
            self._events.append(event)

    def record_iteration(self, row: Dict[str, Any]) -> None:
        with self._lock:
            self._iterations.append(row)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "schema": self.SCHEMA,
                "events": list(self._events),
                "iterations": list(self._iterations),
                "dumps": self.dumps,
                "last_dump_reason": self.last_dump_reason,
            }

    def dump(self, reason: str) -> Optional[str]:
        with self._lock:
            path = self._path
        if not path:
            return None
        payload = self.snapshot()
        payload["reason"] = reason
        payload["dumped_wall"] = time.time()
        try:
            from ..utils.io_atomic import atomic_write_json

            atomic_write_json(path, payload)
        except Exception:
            return None  # the black box must never take down the plane
        with self._lock:
            self.dumps += 1
            self.last_dump_reason = reason
        return path


_RECORDER = FlightRecorder(path=os.environ.get("CONSENSUS_BLACKBOX") or None)


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


# ---------------------------------------------------------------------------
# RollingWindow


class RollingWindow:
    """Time-bucketed rps / p95 / availability for recovery curves."""

    def __init__(self, bucket_s: float = 1.0):
        self.bucket_s = max(1e-3, float(bucket_s))
        self._lock = threading.Lock()
        self._buckets: Dict[int, Dict[str, Any]] = {}

    def observe(self, t_s: float, ok: bool = True, latency_s: Optional[float] = None) -> None:
        index = int(max(0.0, t_s) // self.bucket_s)
        with self._lock:
            bucket = self._buckets.setdefault(
                index, {"offered": 0, "ok": 0, "latencies": []}
            )
            bucket["offered"] += 1
            if ok:
                bucket["ok"] += 1
            if latency_s is not None:
                bucket["latencies"].append(latency_s)

    @staticmethod
    def _p95(values: List[float]) -> float:
        if not values:
            return 0.0
        ordered = sorted(values)
        rank = max(0, min(len(ordered) - 1, int(round(0.95 * len(ordered) + 0.5)) - 1))
        return ordered[rank]

    def curve(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._buckets.items())
        rows = []
        for index, bucket in items:
            offered = bucket["offered"]
            rows.append(
                {
                    "t_s": round(index * self.bucket_s, 3),
                    "offered": offered,
                    "ok": bucket["ok"],
                    "availability": round(bucket["ok"] / offered, 4) if offered else 1.0,
                    "rps": round(offered / self.bucket_s, 2),
                    "p95_ms": round(self._p95(bucket["latencies"]) * 1000.0, 2),
                }
            )
        return rows
