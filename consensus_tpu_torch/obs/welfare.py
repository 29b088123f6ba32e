"""Welfare telemetry: the serving path learns to watch its own fairness.

PyTorch port of ``consensus_tpu/obs/welfare.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

Everything before this module measured *time* (latency histograms, MFU
attribution) or *availability* (breakers, brownout tiers).  The paper's
actual objective — egalitarian welfare over the agents — had no serving
signal at all: a fleet could quietly trade fairness for throughput
(brownout shrinking searches, failovers landing on degraded tiers) and no
metric would move.  This module closes that gap:

* ``ServeTelemetry`` — per-request welfare telemetry recorded at the
  scheduler's terminal ``_finish`` seam: ``welfare_{rule}`` sketches (one
  per welfare rule, per replica), a ``min_agent_utility`` sketch (the
  egalitarian quantity itself: the worst-off agent), a
  ``welfare_gap_util_egal`` gauge (running utilitarian-minus-egalitarian
  mean — how much "average goodness" masks unfairness), and per-tier
  degraded-vs-full welfare accounting (``serve_degraded_welfare_gap``
  gauges extending the offline ``degraded_welfare_gap`` histogram from the
  anytime/brownout work).  The score-matrix seam feeds the same plane via
  a module-level sink (:func:`set_welfare_sink`), so internal search
  welfare is visible even for requests that skip evaluation.
* ``WelfareDriftDetector`` — compares a rolling window of egalitarian
  welfare against a *pinned baseline snapshot* (a mergeable sketch, so a
  baseline can be saved, shipped, or federated) and raises the named
  condition ``welfare_drift`` when the median or lower tail shifts by more
  than a configured relative threshold.  The condition is a *signal*, not
  an exception: it surfaces in ``/healthz``, feeds the ``welfare_drift``
  SLO in ``obs/slo.py``, and stamps a flight-recorder event on the
  transition.

Telemetry OFF (the default — no ``ServeTelemetry`` constructed, sink left
``None``) leaves the hot path byte-identical: every call site guards on a
single attribute/global read and allocates nothing.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.obs.sketch import QuantileSketch

#: Welfare rules tracked by the telemetry plane (must match
#: ``consensus_tpu_torch.ops.welfare.WELFARE_RULES``).
WELFARE_RULES = ("egalitarian", "utilitarian", "log_nash")

#: The evaluator's response keys this plane taps (cosine channel — the
#: embedding-based utility is the one every backend produces).
_WELFARE_RESPONSE_KEYS = {
    rule: f"{rule}_welfare_cosine" for rule in WELFARE_RULES
}

_EPS = 1e-6


class WelfareDriftDetector:
    """Rolling-window vs pinned-baseline drift on a welfare stream.

    The baseline is a :class:`QuantileSketch` snapshot — pinned explicitly
    (``pin_baseline()`` after a known-good reference run, or from a saved
    snapshot dict) or automatically from the first ``min_samples``
    observations.  ``status()`` reports the named condition
    ``welfare_drift``: drifted when the rolling window's median OR 10th
    percentile moved more than ``threshold`` (relative) from the baseline.
    The p10 term is the point: a *skew* that hurts the worst-off agents
    shifts the lower tail long before it moves the median.
    """

    condition = "welfare_drift"

    def __init__(
        self,
        window: int = 256,
        min_samples: int = 32,
        threshold: float = 0.25,
        relative_accuracy: float = 0.01,
    ) -> None:
        if window < 2 or min_samples < 2:
            raise ValueError("window and min_samples must be >= 2")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.threshold = float(threshold)
        self.relative_accuracy = float(relative_accuracy)
        self._lock = threading.Lock()
        self._values: deque = deque(maxlen=self.window)
        self._baseline: Optional[QuantileSketch] = None
        self._was_drifted = False

    # -- inputs ------------------------------------------------------------

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))
            if (
                self._baseline is None
                and len(self._values) >= self.min_samples
            ):
                self._pin_locked()

    def pin_baseline(
        self, snapshot: Optional[Mapping[str, Any]] = None
    ) -> Dict[str, Any]:
        """Pin the baseline: from a saved sketch snapshot dict, or from the
        current rolling window.  Returns the pinned snapshot."""
        with self._lock:
            if snapshot is not None:
                self._baseline = QuantileSketch.from_dict(snapshot)
            else:
                self._pin_locked()
            return self._baseline.to_dict() if self._baseline else {}

    def _pin_locked(self) -> None:
        sketch = QuantileSketch(
            relative_accuracy=self.relative_accuracy, extreme="low"
        )
        for value in self._values:
            sketch.observe(value)
        self._baseline = sketch

    def baseline_snapshot(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._baseline.to_dict() if self._baseline else None

    # -- the named condition ----------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The condition's current state (never raises, never blocks long)."""
        with self._lock:
            out: Dict[str, Any] = {
                "condition": self.condition,
                "drifted": False,
                "samples": len(self._values),
                "threshold": self.threshold,
            }
            if self._baseline is None or len(self._values) < self.min_samples:
                out["reason"] = "warming_up"
                return out
            ordered = sorted(self._values)
            n = len(ordered)
            window_median = ordered[(n - 1) // 2]
            window_p10 = ordered[int(0.1 * (n - 1))]
            base_median = self._baseline.quantile(0.5)
            base_p10 = self._baseline.quantile(0.1)
            shift_median = _relative_shift(base_median, window_median)
            shift_p10 = _relative_shift(base_p10, window_p10)
            drifted = max(shift_median, shift_p10) > self.threshold
            out.update(
                drifted=drifted,
                baseline={"median": base_median, "p10": base_p10},
                window={"median": window_median, "p10": window_p10},
                shift={
                    "median": round(shift_median, 4),
                    "p10": round(shift_p10, 4),
                },
            )
            newly = drifted and not self._was_drifted
            self._was_drifted = drifted
        if newly:
            # Stamp the transition into the flight recorder so a later
            # blackbox dump shows WHEN fairness started sliding.
            from consensus_tpu_torch.obs.trace import get_flight_recorder

            get_flight_recorder().record_event(
                "welfare_drift",
                shift_median=round(shift_median, 4),
                shift_p10=round(shift_p10, 4),
            )
        return out

    @property
    def drifted(self) -> bool:
        return self.status()["drifted"]


def _relative_shift(baseline: Optional[float], current: float) -> float:
    if baseline is None:
        return 0.0
    return abs(current - baseline) / max(abs(baseline), _EPS)


class _RunningMean:
    __slots__ = ("total", "count")

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def add(self, value: float) -> None:
        self.total += value
        self.count += 1

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None


class ServeTelemetry:
    """The per-request welfare + latency telemetry plane.

    Constructed once per server (``create_server(telemetry=True)``) and
    handed to every scheduler; ``record_request`` runs inside the
    scheduler's ``_finish`` under no scheduler lock.  All sketch families
    carry a ``replica`` label so the fleet ``/metrics`` view can federate
    them (``obs/sketch.py``).
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        relative_accuracy: float = 0.01,
        drift_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.relative_accuracy = float(relative_accuracy)
        self._m_latency = reg.sketch(
            "serve_latency_sketch_seconds",
            "End-to-end request latency sketch (mergeable; federates into "
            "an exact fleet percentile), by replica and outcome.",
            labels=("replica", "outcome"),
            relative_accuracy=relative_accuracy,
            extreme="high",
        )
        self._m_welfare = {
            rule: reg.sketch(
                f"welfare_{rule}",
                f"Per-request {rule} welfare (cosine channel) of evaluated "
                "responses, by replica.",
                labels=("replica",),
                relative_accuracy=relative_accuracy,
                extreme="low",
            )
            for rule in WELFARE_RULES
        }
        self._m_min_agent = reg.sketch(
            "min_agent_utility",
            "Worst-off agent's cosine utility per evaluated response — the "
            "egalitarian quantity itself, by replica.",
            labels=("replica",),
            relative_accuracy=relative_accuracy,
            extreme="low",
        )
        self._m_gap = reg.gauge(
            "welfare_gap_util_egal",
            "Running mean utilitarian-minus-egalitarian welfare: how much "
            "the average hides the worst-off agent, by replica.",
            labels=("replica",),
        )
        self._m_tier_welfare = reg.sketch(
            "welfare_by_tier",
            "Per-request egalitarian welfare by serving tier ('full' vs "
            "the degraded tier that actually served).",
            labels=("tier",),
            relative_accuracy=relative_accuracy,
            extreme="low",
        )
        self._m_tier_gap = reg.gauge(
            "serve_degraded_welfare_gap",
            "Running mean egalitarian welfare a degraded tier gives up vs "
            "full-fidelity responses (serving-path counterpart of the "
            "offline degraded_welfare_gap histogram), by tier.",
            labels=("tier",),
        )
        self._m_score_welfare = reg.sketch(
            "score_path_welfare",
            "Welfare of the chosen candidate at the score-matrix seam "
            "(internal search welfare; includes non-evaluated requests), "
            "by rule.",
            labels=("rule",),
            relative_accuracy=relative_accuracy,
            extreme="low",
        )
        self._m_score_min_agent = reg.sketch(
            "score_path_min_agent_utility",
            "Worst-off agent's utility in the chosen score-matrix row.",
            relative_accuracy=relative_accuracy,
            extreme="low",
        )
        self._m_drift = reg.gauge(
            "welfare_drift",
            "1 while the welfare drift condition is raised, else 0.",
        )
        self._m_drift_events = reg.counter(
            "welfare_drift_events_total",
            "Transitions into the raised welfare_drift condition.",
        )
        self.drift = WelfareDriftDetector(**(drift_options or {}))
        self._lock = threading.Lock()
        self._gap_means: Dict[str, Dict[str, _RunningMean]] = {}
        self._tier_means: Dict[str, _RunningMean] = {}
        self._drift_raised = False

    # -- serving-path records ---------------------------------------------

    def record_request(
        self,
        method: str,
        outcome: str,
        latency_s: float,
        value: Any = None,
        replica: str = "",
        tier: str = "",
        trace_id: Optional[str] = None,
    ) -> None:
        """One terminal request outcome.  Never raises."""
        try:
            self._m_latency.labels(replica, outcome).observe(
                latency_s, trace_id
            )
            if not isinstance(value, Mapping):
                return
            welfare = value.get("welfare")
            if isinstance(welfare, Mapping):
                self._record_welfare(welfare, value, replica, tier, trace_id)
            utilities = value.get("utilities")
            if isinstance(utilities, Mapping) and utilities:
                worst = min(
                    float(u.get("cosine_similarity", 0.0))
                    for u in utilities.values()
                )
                self._m_min_agent.labels(replica).observe(worst, trace_id)
        except Exception:  # telemetry must never take down serving
            pass

    def _record_welfare(
        self,
        welfare: Mapping[str, Any],
        value: Mapping[str, Any],
        replica: str,
        tier: str,
        trace_id: Optional[str],
    ) -> None:
        observed: Dict[str, float] = {}
        for rule, key in _WELFARE_RESPONSE_KEYS.items():
            raw = welfare.get(key)
            if raw is None:
                continue
            observed[rule] = float(raw)
            self._m_welfare[rule].labels(replica).observe(
                observed[rule], trace_id
            )
        egal = observed.get("egalitarian")
        util = observed.get("utilitarian")
        with self._lock:
            if egal is not None and util is not None:
                means = self._gap_means.setdefault(
                    replica,
                    {"egalitarian": _RunningMean(), "utilitarian": _RunningMean()},
                )
                means["egalitarian"].add(egal)
                means["utilitarian"].add(util)
                self._m_gap.labels(replica).set(
                    means["utilitarian"].mean - means["egalitarian"].mean
                )
            if egal is not None:
                tier_label = (
                    "full"
                    if not value.get("degraded")
                    else (tier or str(value.get("degraded_reason") or "degraded"))
                )
                self._m_tier_welfare.labels(tier_label).observe(egal, trace_id)
                self._tier_means.setdefault(tier_label, _RunningMean()).add(egal)
                full = self._tier_means.get("full")
                if full is not None and full.count:
                    for label, stats in self._tier_means.items():
                        if label == "full" or not stats.count:
                            continue
                        self._m_tier_gap.labels(label).set(
                            max(0.0, full.mean - stats.mean)
                        )
        if egal is not None:
            self.drift.observe(egal)
            self._refresh_drift()

    def _refresh_drift(self) -> None:
        status = self.drift.status()
        drifted = bool(status.get("drifted"))
        self._m_drift.set(1.0 if drifted else 0.0)
        with self._lock:
            newly = drifted and not self._drift_raised
            self._drift_raised = drifted
        if newly:
            self._m_drift_events.inc()

    # -- score-matrix sink -------------------------------------------------

    def record_matrix(self, result: Any, welfare_rule: Optional[str] = None) -> None:
        """Welfare of the chosen candidate at the matrix seam.  ``result``
        is a ``ScoreMatrixResult``; never raises."""
        try:
            welfare = result.welfare
            if welfare is None or len(welfare) == 0:
                return
            best = int(result.best)
            self._m_score_welfare.labels(welfare_rule or "unknown").observe(
                float(welfare[best])
            )
            utilities = result.utilities
            if utilities is not None and getattr(utilities, "size", 0):
                row = utilities[best]
                self._m_score_min_agent.observe(float(min(row)))
        except Exception:
            pass

    # -- views -------------------------------------------------------------

    def drift_status(self) -> Dict[str, Any]:
        return self.drift.status()

    def snapshot(self) -> Dict[str, Any]:
        """Compact welfare view for /healthz and loadgen."""
        with self._lock:
            tiers = {
                label: {"mean": stats.mean, "count": stats.count}
                for label, stats in sorted(self._tier_means.items())
            }
        return {"tiers": tiers, "drift": self.drift.status()}


# -- the score-matrix sink ---------------------------------------------------
#
# ``backends/score_matrix.py`` cannot know whether a telemetry plane
# exists; it checks this module-level sink on every recorded matrix.  When
# no server enabled telemetry the read is a single global load returning
# None — the off path allocates nothing.

_SINK: Optional[ServeTelemetry] = None


def set_welfare_sink(sink: Optional[ServeTelemetry]) -> Optional[ServeTelemetry]:
    """Install (or clear, with None) the process-wide score-path welfare
    sink.  Last server wins; tests clear it in teardown."""
    global _SINK
    _SINK = sink
    return sink


def get_welfare_sink() -> Optional[ServeTelemetry]:
    return _SINK
