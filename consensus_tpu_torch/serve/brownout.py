"""Brownout controller: load-pressure tiers → search-budget scaling.

The admission layer sheds load at the DOOR — queue-full 429s,
breaker-open 503s.  Brownout is the complementary knob for requests already
inside: when the server runs hot, shrink how much SEARCH each request buys
(fewer best-of-N candidates, narrower beams, shallower lookahead, fewer
MCTS simulations, fewer deliberation rounds) so service time per request
drops and the queue drains — the answer degrades, the availability doesn't.
What never changes under brownout: sampling temperature and the welfare
rule.  A browned-out statement is a *smaller search over the same
objective*, not a different distribution — so the fairness semantics of the
paper are preserved at every tier.

Pressure signal (recomputed on every scheduler event, O(1)):

    pressure = max(queue_frac,            # admission queue occupancy
                   p95_ewma / target_p95, # latency vs SLO (when targeted)
                   0.6 * inflight_frac,   # capped: saturation alone (busy
                                          # workers, empty queue) must not
                                          # cross the tier-1 enter threshold
                   breaker term)          # half_open 0.9, open 1.2

The p95 estimate is a tail-biased EWMA: a sample above the estimate pulls
it up with weight ``alpha``; a sample below pulls it down with weight
``alpha * (1-q)/q`` (q = 0.95), so in steady state ~5% of samples sit above
the estimate — a constant-memory quantile tracker.

Tiers and hysteresis (the flap-killer):

    tier   scale   enter when pressure >=   exit (back to tier-1) when <=
    0      1.00    —                        —
    1      0.70    0.65                     0.40
    2      0.45    0.85                     0.60
    3      0.25    1.10                     0.80

Escalation is immediate (straight to the highest tier whose enter threshold
is met — a pressure spike must not climb one tier per event).  De-escalation
is conservative: one tier at a time, only after ``min_dwell_s`` in the
current tier AND pressure at or below the lower exit threshold.  The gap
between enter and exit thresholds plus the dwell makes oscillation around a
boundary impossible by construction.

The scheduler stamps every dispatched ticket's :class:`BudgetClock` with the
CURRENT tier's scale — tier changes affect future dispatches, never a search
already in flight.

Obs: ``brownout_tier`` / ``brownout_pressure`` / ``brownout_budget_scale``
gauges, ``brownout_tier_changes_total{direction}`` counter.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

from consensus_tpu_torch.obs.metrics import Registry, get_registry

#: Budget scale per tier; tier 0 is full budget.
DEFAULT_TIER_SCALES = (1.0, 0.7, 0.45, 0.25)
#: Pressure at or above ``enter[i]`` escalates to tier i+1.
DEFAULT_ENTER_THRESHOLDS = (0.65, 0.85, 1.1)
#: Pressure at or below ``exit[i]`` (plus dwell) de-escalates from tier i+1.
DEFAULT_EXIT_THRESHOLDS = (0.4, 0.6, 0.8)

#: Breaker-state pressure: half_open probes mean the backend JUST failed
#: (stay browned out while it proves itself); open pins the top tier so the
#: probe request itself runs at minimum budget.
_BREAKER_PRESSURE = {"closed": 0.0, "half_open": 0.9, "open": 1.2}


class BrownoutController:
    """Hysteretic pressure→tier mapper; thread-safe; O(1) per event."""

    def __init__(
        self,
        target_p95_s: Optional[float] = None,
        tier_scales: Sequence[float] = DEFAULT_TIER_SCALES,
        enter_thresholds: Sequence[float] = DEFAULT_ENTER_THRESHOLDS,
        exit_thresholds: Sequence[float] = DEFAULT_EXIT_THRESHOLDS,
        min_dwell_s: float = 2.0,
        ewma_alpha: float = 0.3,
        quantile: float = 0.95,
        registry: Optional[Registry] = None,
        now: Callable[[], float] = time.monotonic,
    ):
        if len(enter_thresholds) != len(tier_scales) - 1:
            raise ValueError("need one enter threshold per non-zero tier")
        if len(exit_thresholds) != len(tier_scales) - 1:
            raise ValueError("need one exit threshold per non-zero tier")
        for enter, exit_ in zip(enter_thresholds, exit_thresholds):
            if exit_ >= enter:
                raise ValueError(
                    "each exit threshold must sit strictly below its enter "
                    f"threshold (hysteresis band), got exit {exit_} >= "
                    f"enter {enter}"
                )
        if not (0.0 < quantile < 1.0):
            raise ValueError("quantile must be in (0, 1)")
        self.target_p95_s = target_p95_s
        self.tier_scales = tuple(float(s) for s in tier_scales)
        self.enter_thresholds = tuple(float(t) for t in enter_thresholds)
        self.exit_thresholds = tuple(float(t) for t in exit_thresholds)
        self.min_dwell_s = float(min_dwell_s)
        self._alpha_up = float(ewma_alpha)
        self._alpha_down = float(ewma_alpha) * (1.0 - quantile) / quantile
        self._now = now

        self._lock = threading.Lock()
        self._tier = 0
        self._pressure = 0.0
        self._p95_ewma: Optional[float] = None
        self._entered_at = self._now()
        self._tier_request_counts: Dict[int, int] = {
            i: 0 for i in range(len(self.tier_scales))
        }

        reg = registry if registry is not None else get_registry()
        self._m_tier = reg.gauge(
            "brownout_tier",
            "Current brownout tier (0 = full budget).")
        self._m_pressure = reg.gauge(
            "brownout_pressure",
            "Current load pressure (max of queue fraction, p95/target, "
            "capped inflight fraction, breaker term).")
        self._m_scale = reg.gauge(
            "brownout_budget_scale",
            "Search-budget scale applied to newly dispatched requests.")
        self._m_changes = reg.counter(
            "brownout_tier_changes_total",
            "Brownout tier transitions, by direction.",
            labels=("direction",),
        )
        self._m_tier.set(0)
        self._m_scale.set(self.tier_scales[0])

    # -- inputs --------------------------------------------------------------

    def record_latency(self, latency_s: float) -> None:
        """Feed one request's end-to-end latency into the p95 tracker."""
        with self._lock:
            if self._p95_ewma is None:
                self._p95_ewma = float(latency_s)
            elif latency_s > self._p95_ewma:
                self._p95_ewma += self._alpha_up * (latency_s - self._p95_ewma)
            else:
                self._p95_ewma += self._alpha_down * (
                    latency_s - self._p95_ewma
                )

    def update(
        self,
        queue_depth: int,
        max_queue_depth: int,
        inflight: int,
        max_inflight: int,
        breaker_state: Optional[str] = None,
    ) -> int:
        """Recompute pressure from the live load signals; apply the tier
        transition rules; return the current tier."""
        queue_frac = queue_depth / max(1, max_queue_depth)
        inflight_frac = inflight / max(1, max_inflight)
        pressure = max(queue_frac, 0.6 * inflight_frac)
        if breaker_state is not None:
            pressure = max(pressure, _BREAKER_PRESSURE.get(breaker_state, 0.0))
        with self._lock:
            if (
                self.target_p95_s is not None
                and self.target_p95_s > 0
                and self._p95_ewma is not None
            ):
                pressure = max(pressure, self._p95_ewma / self.target_p95_s)
            self._pressure = pressure
            now = self._now()

            # Escalate immediately to the highest tier whose enter
            # threshold is met.
            target = self._tier
            for i, enter in enumerate(self.enter_thresholds):
                if pressure >= enter:
                    target = max(target, i + 1)
            if target > self._tier:
                self._tier = target
                self._entered_at = now
                self._m_changes.labels("up").inc()
            elif (
                self._tier > 0
                and pressure <= self.exit_thresholds[self._tier - 1]
                and now - self._entered_at >= self.min_dwell_s
            ):
                # De-escalate ONE tier after dwelling below the exit
                # threshold — never a multi-tier drop in one event.
                self._tier -= 1
                self._entered_at = now
                self._m_changes.labels("down").inc()

            self._m_tier.set(self._tier)
            self._m_pressure.set(round(pressure, 4))
            self._m_scale.set(self.tier_scales[self._tier])
            return self._tier

    def note_dispatch(self) -> None:
        """Count one request dispatched at the current tier (loadgen /
        acceptance reporting: per-tier request counts)."""
        with self._lock:
            self._tier_request_counts[self._tier] += 1

    # -- outputs -------------------------------------------------------------

    @property
    def tier(self) -> int:
        with self._lock:
            return self._tier

    @property
    def scale(self) -> float:
        with self._lock:
            return self.tier_scales[self._tier]

    def snapshot(self) -> Dict[str, Any]:
        """Live controller facts for /healthz and scheduler stats."""
        with self._lock:
            return {
                "tier": self._tier,
                "budget_scale": self.tier_scales[self._tier],
                "pressure": round(self._pressure, 4),
                "p95_ewma_s": (
                    round(self._p95_ewma, 4)
                    if self._p95_ewma is not None else None
                ),
                "target_p95_s": self.target_p95_s,
                "tier_scales": list(self.tier_scales),
                "tier_request_counts": {
                    str(k): v for k, v in self._tier_request_counts.items()
                },
            }
