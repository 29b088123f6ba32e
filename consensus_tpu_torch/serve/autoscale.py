"""Pressure-driven replica autoscaler: capacity as the lever BEFORE quality.

PyTorch port of ``consensus_tpu/serve/autoscale.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

The serving stack already has two degradation levers — the per-replica
brownout controller (scale the search budget down under pressure) and the
fleet tier lever (route to a smaller model tier).  Both trade answer
QUALITY for availability.  The autoscaler adds the lever that should fire
first when capacity exists: change the REPLICA COUNT, via the
:class:`~consensus_tpu_torch.serve.fleet.ReplicaManager`'s target.

Composition contract (pinned by tests/test_torch_elastic.py):

* The default ``scale_up_pressure`` (0.8) sits BELOW the brownout
  controller's tier-2 enter threshold (0.85) and the router tier lever's
  enter threshold (0.85): as pressure climbs, the fleet first ADDS a
  replica; only if pressure keeps climbing past the quality thresholds
  (scale-up capped out, or the new replica not absorbing load) do the
  quality levers engage.  Brownout tier 1 (enter 0.65) may engage earlier
  — mild per-request budget trimming while capacity spins up is the
  intended overlap.
* Scale-DOWN is deliberately sluggish: pressure must dwell below
  ``scale_down_pressure`` (default 0.35 — below every de-escalation exit
  threshold) for ``down_dwell_s`` continuously, plus a global
  ``cooldown_s`` between any two scale events.  The asymmetry (fast up,
  slow down) is what prevents the autoscaler and the hysteresis levers
  from oscillating against each other: adding capacity drops pressure,
  and a symmetric scaler would immediately give the capacity back.

The pressure signal is the max over live replicas' brownout controller
pressure (``BrownoutController.snapshot()["pressure"]`` — queue, inflight,
p95-vs-SLO, breaker) when any replica carries a controller, else the
router's aggregate ``_pressure()``.  Max, not mean: one saturated replica
is a capacity problem even when its peers idle (affinity concentrates hot
scenarios).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from consensus_tpu_torch.obs.metrics import Registry, get_registry

#: Defaults — see the composition contract above before changing them.
DEFAULT_SCALE_UP_PRESSURE = 0.8
DEFAULT_SCALE_DOWN_PRESSURE = 0.35
DEFAULT_UP_DWELL_S = 0.5
DEFAULT_DOWN_DWELL_S = 3.0
DEFAULT_COOLDOWN_S = 2.0


class Autoscaler:
    """Drives ``manager.set_target`` from a pressure signal with dwell +
    cooldown hysteresis."""

    def __init__(
        self,
        manager,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        scale_up_pressure: float = DEFAULT_SCALE_UP_PRESSURE,
        scale_down_pressure: float = DEFAULT_SCALE_DOWN_PRESSURE,
        up_dwell_s: float = DEFAULT_UP_DWELL_S,
        down_dwell_s: float = DEFAULT_DOWN_DWELL_S,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        check_interval_s: float = 0.25,
        pressure_fn: Optional[Callable[[], float]] = None,
        registry: Optional[Registry] = None,
        auto_start: bool = True,
        clock=time.monotonic,
    ):
        if scale_down_pressure >= scale_up_pressure:
            raise ValueError(
                f"scale_down_pressure ({scale_down_pressure}) must sit "
                f"below scale_up_pressure ({scale_up_pressure}) — equal or "
                "inverted thresholds oscillate by construction"
            )
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas=} {max_replicas=}"
            )
        self.manager = manager
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_pressure = float(scale_up_pressure)
        self.scale_down_pressure = float(scale_down_pressure)
        self.up_dwell_s = float(up_dwell_s)
        self.down_dwell_s = float(down_dwell_s)
        self.cooldown_s = float(cooldown_s)
        self.check_interval_s = float(check_interval_s)
        self._pressure_fn = pressure_fn or self._fleet_pressure
        self._clock = clock
        self._lock = threading.Lock()
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_change: Optional[float] = None
        self.last_pressure = 0.0
        self.scale_ups = 0
        self.scale_downs = 0

        reg = registry if registry is not None else get_registry()
        self._m_pressure = reg.gauge(
            "autoscaler_pressure",
            "Pressure signal the autoscaler last sampled (max over live "
            "replicas' brownout pressure, or the router aggregate).",
        )
        self._m_target = reg.gauge(
            "autoscaler_target_replicas",
            "Replica target the autoscaler last set on the manager.",
        )
        self._m_events = reg.counter(
            "autoscaler_scale_events_total",
            "Scale events issued to the replica manager, by direction.",
            labels=("direction",),
        )
        self._m_target.set(manager.target)

        manager.router.autoscaler = self
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self._thread = threading.Thread(
                target=self._loop, name="autoscaler", daemon=True
            )
            self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover - monitor must survive
                pass

    # -- signal -------------------------------------------------------------

    def _fleet_pressure(self) -> float:
        router = self.manager.router
        pressures = []
        for replica in router.replicas:
            if replica.lost or replica.brownout is None:
                continue
            try:
                pressures.append(
                    float(replica.brownout.snapshot()["pressure"]))
            except Exception:
                continue
        if pressures:
            return max(pressures)
        return float(router._pressure())

    # -- control law --------------------------------------------------------

    def tick(self) -> None:
        """One control step (public so tests can drive it with a fake
        pressure_fn and clock)."""
        pressure = float(self._pressure_fn())
        now = self._clock()
        with self._lock:
            self.last_pressure = pressure
            self._m_pressure.set(pressure)
            target = self.manager.target
            if pressure >= self.scale_up_pressure:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                if (
                    now - self._above_since >= self.up_dwell_s
                    and self._cooled(now)
                    and target < self.max_replicas
                ):
                    self._change(target + 1, "up", now)
            elif pressure <= self.scale_down_pressure:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                if (
                    now - self._below_since >= self.down_dwell_s
                    and self._cooled(now)
                    and target > self.min_replicas
                ):
                    self._change(target - 1, "down", now)
            else:
                # Dead band: dwell clocks reset — pressure must hold a
                # threshold CONTINUOUSLY, not just visit it.
                self._above_since = None
                self._below_since = None

    def _cooled(self, now: float) -> bool:
        return (
            self._last_change is None
            or now - self._last_change >= self.cooldown_s
        )

    def _change(self, target: int, direction: str, now: float) -> None:
        self.manager.set_target(target)
        self._m_target.set(target)
        self._m_events.labels(direction).inc()
        self._last_change = now
        self._above_since = None
        self._below_since = None
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "target": self.manager.target,
                "pressure": round(self.last_pressure, 4),
                "scale_up_pressure": self.scale_up_pressure,
                "scale_down_pressure": self.scale_down_pressure,
                "up_dwell_s": self.up_dwell_s,
                "down_dwell_s": self.down_dwell_s,
                "cooldown_s": self.cooldown_s,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
            }
