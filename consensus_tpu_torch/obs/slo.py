"""Declarative SLOs evaluated by a multi-window burn-rate state machine.

PyTorch port of ``consensus_tpu/obs/slo.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

An SLO here is "at most ``1 - objective`` of events may be bad".  What
counts as a bad event is the spec's ``signal``:

===================  ========================================================
signal               bad event
===================  ========================================================
``availability``     a request that terminally failed (5xx / timeout)
``latency``          a request slower than ``threshold_s``
``degraded``         a request answered with a degraded statement
``kv_headroom``      a poll sample with KV-page headroom below
                     ``threshold`` (fraction of free pages)
``welfare_drift``    a poll sample while the ``welfare_drift`` condition
                     (``obs/welfare.py``) is raised
===================  ========================================================

Request signals are *pushed* (``record_request``, one call per terminal
HTTP response); poll signals are *sampled* (``sample_signals`` reads the
registered callables — KV stats, drift status — once per evaluation).

Burn rate is the SRE textbook quantity: observed bad fraction divided by
the error budget ``1 - objective``.  Burn 1.0 spends the budget exactly at
the objective's horizon; burn 14 torches it in hours.  Each spec is judged
over TWO windows — a short ``fast_window_s`` that reacts in seconds and a
long ``slow_window_s`` that refuses to alert on a blip — and walks a
three-state machine with single-step transitions (so every violation
passes through ``burning``, and recovery is observable):

    ok       --[fast burn >= fast_threshold]-->                 burning
    burning  --[fast AND slow burns over their thresholds]-->   violated
    burning  --[fast AND slow burns under their thresholds]-->  ok
    violated --[fast burn back under fast_threshold]-->         burning

Entering ``violated`` dumps the flight-recorder blackbox: the
moment an SLO is formally torched is exactly when you want the last N
iterations and events on disk.  The clock is injectable; the whole machine
is deterministic under a fake clock (``tests/test_torch_slo.py``).

Surfaces: ``GET /v1/slo`` (full snapshot), the ``/healthz`` ``slo`` block
(state per spec), and ``slo_burn_rate{slo,window}`` / ``slo_state{slo}``
gauges + ``slo_transitions_total{slo,to}`` counters when a registry is
attached.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from consensus_tpu_torch.obs.metrics import Registry

OK = "ok"
BURNING = "burning"
VIOLATED = "violated"

_STATE_ORDER = {OK: 0, BURNING: 1, VIOLATED: 2}

#: Signals fed per-request vs sampled per-evaluation.
REQUEST_SIGNALS = ("availability", "latency", "degraded")
POLL_SIGNALS = ("kv_headroom", "welfare_drift")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.  JSON-friendly via ``from_dict``."""

    name: str
    signal: str
    #: Fraction of events that must be good.  Budget = 1 - objective.
    objective: float = 0.99
    #: Latency cut for ``signal="latency"``; headroom floor (fraction of
    #: free KV pages) for ``signal="kv_headroom"``.
    threshold: float = 0.0
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn_threshold: float = 10.0
    slow_burn_threshold: float = 2.0

    def __post_init__(self) -> None:
        if self.signal not in REQUEST_SIGNALS + POLL_SIGNALS:
            raise ValueError(
                f"unknown SLO signal {self.signal!r}; want one of "
                f"{REQUEST_SIGNALS + POLL_SIGNALS}"
            )
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s} / {self.slow_window_s}"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "SLOSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown SLO spec fields: {sorted(unknown)}")
        return cls(**dict(data))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: The default serving SLOs installed by ``create_server(slo=True)``.
DEFAULT_SLO_SPECS = (
    SLOSpec(name="availability", signal="availability", objective=0.99),
    SLOSpec(
        name="latency_p95", signal="latency", objective=0.95, threshold=2.0
    ),
    SLOSpec(name="degraded_fraction", signal="degraded", objective=0.80),
    SLOSpec(
        name="kv_headroom", signal="kv_headroom", objective=0.90,
        threshold=0.10,
    ),
    SLOSpec(name="welfare_drift", signal="welfare_drift", objective=0.95),
)


class _EventWindow:
    """Good/bad counts in one-second buckets over a bounded horizon.

    O(1) amortized per event; ``rates`` prunes lazily.  Bucketing to whole
    seconds keeps memory bounded at ``horizon_s`` entries regardless of
    request rate."""

    __slots__ = ("horizon_s", "_buckets")

    def __init__(self, horizon_s: float) -> None:
        self.horizon_s = float(horizon_s)
        # deque of [bucket_second, good, bad], ascending time
        self._buckets: deque = deque()

    def add(self, now: float, bad: bool) -> None:
        second = int(now)
        if self._buckets and self._buckets[-1][0] == second:
            slot = self._buckets[-1]
        else:
            slot = [second, 0, 0]
            self._buckets.append(slot)
            self._prune(now)
        if bad:
            slot[2] += 1
        else:
            slot[1] += 1

    def _prune(self, now: float) -> None:
        floor = int(now - self.horizon_s)
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.popleft()

    def counts(self, now: float, window_s: float) -> Dict[str, int]:
        self._prune(now)
        floor = now - window_s
        good = bad = 0
        for second, g, b in reversed(self._buckets):
            if second < floor:
                break
            good += g
            bad += b
        return {"good": good, "bad": bad, "total": good + bad}


class SLOEngine:
    """Evaluates a set of :class:`SLOSpec` over pushed + sampled events."""

    def __init__(
        self,
        specs: Optional[Sequence[Any]] = None,
        registry: Optional[Registry] = None,
        clock: Callable[[], float] = time.monotonic,
        dump_blackbox: Optional[Callable[[str], Any]] = None,
        signals: Optional[Dict[str, Callable[[], Any]]] = None,
        max_transitions: int = 64,
    ) -> None:
        raw = DEFAULT_SLO_SPECS if specs is None else specs
        self.specs: List[SLOSpec] = [
            spec if isinstance(spec, SLOSpec) else SLOSpec.from_dict(spec)
            for spec in raw
        ]
        names = [spec.name for spec in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names: {names}")
        self._clock = clock
        self._dump = dump_blackbox if dump_blackbox is not None else _dump_blackbox
        #: name -> callable for poll signals: ``kv_headroom`` returns a
        #: float fraction (or None when unknown); ``welfare_drift`` returns
        #: a status mapping with a ``drifted`` bool (or a bare bool).
        self.signals: Dict[str, Callable[[], Any]] = dict(signals or {})
        self._lock = threading.Lock()
        self._windows: Dict[str, _EventWindow] = {
            spec.name: _EventWindow(spec.slow_window_s) for spec in self.specs
        }
        self._states: Dict[str, str] = {spec.name: OK for spec in self.specs}
        self._burns: Dict[str, Dict[str, float]] = {
            spec.name: {"fast": 0.0, "slow": 0.0} for spec in self.specs
        }
        self._transitions: deque = deque(maxlen=max_transitions)
        self._m_burn = self._m_state = self._m_transitions = None
        if registry is not None:
            self._m_burn = registry.gauge(
                "slo_burn_rate",
                "Error-budget burn rate per SLO and window (1.0 spends the "
                "budget exactly at the horizon).",
                labels=("slo", "window"),
            )
            self._m_state = registry.gauge(
                "slo_state",
                "SLO state machine position (0 ok, 1 burning, 2 violated).",
                labels=("slo",),
            )
            self._m_transitions = registry.counter(
                "slo_transitions_total",
                "SLO state transitions, by target state.",
                labels=("slo", "to"),
            )

    # -- event feeds -------------------------------------------------------

    def record_request(
        self,
        ok: bool,
        latency_s: Optional[float] = None,
        degraded: bool = False,
        now: Optional[float] = None,
    ) -> None:
        """One terminal HTTP response.  Cheap: a few deque appends."""
        t = self._clock() if now is None else now
        with self._lock:
            for spec in self.specs:
                if spec.signal == "availability":
                    self._windows[spec.name].add(t, bad=not ok)
                elif spec.signal == "latency":
                    if latency_s is not None:
                        self._windows[spec.name].add(
                            t, bad=latency_s > spec.threshold
                        )
                elif spec.signal == "degraded":
                    self._windows[spec.name].add(t, bad=degraded)

    def sample_signals(self, now: Optional[float] = None) -> None:
        """Poll the registered gauge signals into their windows."""
        t = self._clock() if now is None else now
        for spec in self.specs:
            if spec.signal not in POLL_SIGNALS:
                continue
            fn = self.signals.get(spec.signal)
            if fn is None:
                continue
            try:
                raw = fn()
            except Exception:
                continue
            bad = self._classify_poll(spec, raw)
            if bad is None:
                continue
            with self._lock:
                self._windows[spec.name].add(t, bad=bad)

    @staticmethod
    def _classify_poll(spec: SLOSpec, raw: Any) -> Optional[bool]:
        if raw is None:
            return None
        if spec.signal == "kv_headroom":
            return float(raw) < spec.threshold
        # welfare_drift: a status mapping or a bare bool
        if isinstance(raw, Mapping):
            return bool(raw.get("drifted"))
        return bool(raw)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Sample poll signals, advance every state machine one step, and
        return the full snapshot.  Deterministic under a fake clock."""
        t = self._clock() if now is None else now
        self.sample_signals(now=t)
        dumps: List[str] = []
        with self._lock:
            for spec in self.specs:
                window = self._windows[spec.name]
                fast = _burn_rate(
                    window.counts(t, spec.fast_window_s), spec.budget
                )
                slow = _burn_rate(
                    window.counts(t, spec.slow_window_s), spec.budget
                )
                self._burns[spec.name] = {"fast": fast, "slow": slow}
                state = self._states[spec.name]
                fast_hot = fast >= spec.fast_burn_threshold
                slow_hot = slow >= spec.slow_burn_threshold
                new_state = state
                if state == OK and fast_hot:
                    new_state = BURNING
                elif state == BURNING:
                    if fast_hot and slow_hot:
                        new_state = VIOLATED
                    elif not fast_hot and not slow_hot:
                        new_state = OK
                elif state == VIOLATED and not fast_hot:
                    new_state = BURNING
                if new_state != state:
                    self._states[spec.name] = new_state
                    self._transitions.append(
                        {
                            "slo": spec.name,
                            "from": state,
                            "to": new_state,
                            "t": round(t, 3),
                            "fast_burn": round(fast, 3),
                            "slow_burn": round(slow, 3),
                        }
                    )
                    if self._m_transitions is not None:
                        self._m_transitions.labels(spec.name, new_state).inc()
                    if new_state == VIOLATED:
                        dumps.append(spec.name)
                if self._m_burn is not None:
                    self._m_burn.labels(spec.name, "fast").set(round(fast, 4))
                    self._m_burn.labels(spec.name, "slow").set(round(slow, 4))
                    self._m_state.labels(spec.name).set(
                        _STATE_ORDER[self._states[spec.name]]
                    )
        for name in dumps:
            # Outside the lock: the dump serializes the whole recorder.
            try:
                self._dump(f"slo_violated:{name}")
            except Exception:
                pass
        return self.snapshot(now=t)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        t = self._clock() if now is None else now
        with self._lock:
            specs_out = []
            for spec in self.specs:
                window = self._windows[spec.name]
                specs_out.append(
                    {
                        "name": spec.name,
                        "signal": spec.signal,
                        "objective": spec.objective,
                        "threshold": spec.threshold,
                        "state": self._states[spec.name],
                        "burn": dict(self._burns[spec.name]),
                        "thresholds": {
                            "fast": spec.fast_burn_threshold,
                            "slow": spec.slow_burn_threshold,
                        },
                        "windows": {
                            "fast_s": spec.fast_window_s,
                            "slow_s": spec.slow_window_s,
                            "fast": window.counts(t, spec.fast_window_s),
                            "slow": window.counts(t, spec.slow_window_s),
                        },
                    }
                )
            worst = OK
            for state in self._states.values():
                if _STATE_ORDER[state] > _STATE_ORDER[worst]:
                    worst = state
            return {
                "worst": worst,
                "specs": specs_out,
                "transitions": list(self._transitions),
            }

    def states(self) -> Dict[str, str]:
        """Compact name -> state view (the /healthz block)."""
        with self._lock:
            return dict(self._states)


def _burn_rate(counts: Mapping[str, int], budget: float) -> float:
    total = counts["total"]
    if total == 0:
        return 0.0
    return (counts["bad"] / total) / max(budget, 1e-9)


def _dump_blackbox(reason: str) -> None:
    from consensus_tpu_torch.obs.trace import get_flight_recorder

    get_flight_recorder().dump(reason)
