"""Replica lifecycle for fleet serving.

PyTorch port of ``consensus_tpu/serve/fleet.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

A :class:`Replica` owns one complete single-replica serving stack — its
own backend instance, fault-tolerance wrappers (fault injection below a
supervised backend with its own circuit breaker), kill switch, optional
brownout controller, :class:`~consensus_tpu_torch.serve.service.ConsensusService`
and :class:`~consensus_tpu_torch.serve.scheduler.RequestScheduler` (which in turn
owns the replica's ``BatchingBackend`` / ``DecodeEngine``).  The fleet
router (``serve/router.py``) composes N of these: replica failure becomes
an isolated, routable event instead of an outage.

The wrapper stack, bottom to top::

    supervisor( killswitch( faults( engine ) ) )

* ``faults`` (optional) is the chaos seam — ``FaultPlan.replica_lost``
  arms a deterministic per-replica death.
* ``killswitch`` is the operational seam — ``Replica.kill()`` makes every
  subsequent backend call raise ``BackendLostError``, exactly what a
  preempted device looks like from above.  It sits ABOVE fault injection
  (a killed replica stops injecting anything else) and BELOW the
  supervisor (so the breaker records the loss and trips: the passive
  health signal the router reads).
* ``supervisor`` retries transients, bisects poison rows, and owns the
  replica's :class:`~consensus_tpu_torch.backends.supervisor.CircuitBreaker`.

Health is a derived property, not a stored state: ``lost`` latches (from
an explicit kill, a probe timeout, or the passive device-loss flags the
supervisor and engine latch), draining follows the scheduler, and an open
breaker demotes the replica to ``degraded`` — routable as a last resort,
skipped while healthier peers exist.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from consensus_tpu_torch.backends.base import Backend, BackendLostError
from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.obs.trace import get_flight_recorder
from consensus_tpu_torch.serve.brownout import BrownoutController
from consensus_tpu_torch.serve.scheduler import RequestScheduler
from consensus_tpu_torch.serve.service import ConsensusService

#: Health states, in decreasing order of routability.
HEALTHY = "healthy"
DEGRADED = "degraded"  # breaker open: routable only as a last resort
DRAINING = "draining"
LOST = "lost"


class ReplicaKillSwitch:
    """Backend wrapper with an off button.

    Until :meth:`kill`, every call passes straight through.  After it,
    every call raises :class:`BackendLostError` — the sticky device-loss
    contract, so the supervised stack above reacts exactly as it would to
    a real preemption.  Deliberately does NOT expose
    ``open_fused_token_search``: fused sessions bypass the protocol seam,
    and a killed replica must be dead on EVERY path.
    """

    name = "killswitch"

    def __init__(self, inner: Backend):
        self.inner = inner
        self._lost = threading.Event()
        self._reason = ""

    def kill(self, reason: str = "killed") -> None:
        self._reason = reason
        self._lost.set()

    @property
    def lost(self) -> bool:
        return self._lost.is_set()

    # -- passthrough surface ----------------------------------------------

    @property
    def deterministic_greedy(self) -> bool:
        return bool(getattr(self.inner, "deterministic_greedy", False))

    @property
    def token_counts(self):
        return getattr(self.inner, "token_counts", {})

    # -- protocol -----------------------------------------------------------

    def _check(self, op: str) -> None:
        if self._lost.is_set():
            raise BackendLostError(
                f"replica backend is gone ({self._reason}); {op} refused"
            )

    def generate(self, requests):
        self._check("generate")
        return self.inner.generate(requests)

    def score(self, requests):
        self._check("score")
        return self.inner.score(requests)

    def next_token_logprobs(self, requests):
        self._check("next_token_logprobs")
        return self.inner.next_token_logprobs(requests)

    def embed(self, texts):
        self._check("embed")
        return self.inner.embed(texts)


class Replica:
    """One backend replica: wrapped stack + service + scheduler + health."""

    def __init__(
        self,
        name: str,
        backend: Backend,
        *,
        tier: str = "full",
        registry: Optional[Registry] = None,
        fault_plan=None,
        supervise=True,
        brownout: Optional[BrownoutController] = None,
        generation_model: str = "",
        scheduler_options: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.tier = tier
        reg = registry if registry is not None else get_registry()
        stack: Backend = backend
        if fault_plan is not None:
            from consensus_tpu_torch.backends.faults import FaultInjectingBackend

            stack = FaultInjectingBackend(stack, fault_plan, registry=reg)
        self.kill_switch = ReplicaKillSwitch(stack)
        stack = self.kill_switch
        self._supervisor = None
        if supervise:
            from consensus_tpu_torch.backends.supervisor import (
                CircuitBreaker,
                SupervisedBackend,
            )

            options = dict(supervise) if isinstance(supervise, dict) else {}
            breaker = CircuitBreaker(
                failure_threshold=options.get("failure_threshold", 5),
                cooldown_s=options.get("cooldown_s", 5.0),
                registry=reg,
                name=name,
            )
            stack = SupervisedBackend(
                stack, breaker=breaker, registry=reg, **options
            )
            self._supervisor = stack
        self.backend = stack
        self.brownout = brownout
        service = ConsensusService(stack, generation_model=generation_model)
        self.scheduler = RequestScheduler(
            handler=service.run,
            backend=stack,
            registry=reg,
            brownout=brownout,
            **(scheduler_options or {}),
        )
        # Spans and per-replica health report which replica served; the
        # tier label feeds welfare-by-tier telemetry (obs/welfare.py) so
        # degraded-tier responses are accounted against full-tier welfare.
        self.scheduler.replica_name = name
        self.scheduler.replica_tier = tier
        self._lost = threading.Event()
        self._lost_reason = ""
        #: Transport-seam health (set by the manager's transport probes):
        #: a partitioned replica is DEGRADED — routed around while healthy
        #: peers exist, but still a last resort (a partitioned seam stops
        #: warm handoff, not serving) — and auto-heals when probes pass.
        self.transport_ok = True
        self.transport_reason = ""

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Replica":
        self.scheduler.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        self.scheduler.shutdown(drain=drain, timeout=timeout)

    def kill(self, reason: str = "killed") -> None:
        """Operational kill: the backend starts raising BackendLostError
        (in-flight requests fail fast and fail over) and routing skips the
        replica immediately."""
        self.kill_switch.kill(reason)
        self.mark_lost(reason)

    def mark_lost(self, reason: str) -> None:
        """Routing-only loss mark (probe timeout, observed BackendLostError):
        the backend is left as-is — if it is truly gone its own calls keep
        failing; marking just stops new placements."""
        if not self._lost.is_set():
            self._lost_reason = reason
            self._lost.set()
            recorder = get_flight_recorder()
            recorder.record_event(
                "replica_lost", replica=self.name, reason=reason)
            recorder.dump("replica_loss")

    # -- health -------------------------------------------------------------

    @property
    def lost(self) -> bool:
        """Explicit mark, kill switch, or the passive device-loss flags the
        supervisor / engine latched while serving."""
        if self._lost.is_set() or self.kill_switch.lost:
            return True
        if self._supervisor is not None and getattr(
            self._supervisor, "backend_lost", False
        ):
            return True
        engine = self.scheduler.batching.engine
        if engine is not None and engine.backend_lost:
            return True
        return False

    @property
    def health(self) -> str:
        if self.lost:
            return LOST
        if self.scheduler.draining:
            return DRAINING
        breaker = self.scheduler.circuit_breaker
        if breaker is not None and breaker.state == "open":
            return DEGRADED
        if not self.transport_ok:
            return DEGRADED
        return HEALTHY

    @property
    def lost_reason(self) -> str:
        if self._lost_reason:
            return self._lost_reason
        return "backend_lost" if self.lost else ""

    def probe(self, timeout_s: float) -> bool:
        """Active liveness probe: one tiny ``embed`` call against the
        wrapped stack (below the batching layer, so it cannot jam the
        request path), bounded by ``timeout_s``.  A hung or lost backend
        marks the replica lost.  Off by default at the router (active
        probes consume fault-plan call indices, which deterministic chaos
        tests pin)."""
        if self.lost:
            return False
        result: Dict[str, Any] = {}
        done = threading.Event()

        def run() -> None:
            try:
                self.backend.embed(["__fleet_probe__"])
                result["ok"] = True
            except Exception as exc:  # noqa: BLE001 - classified below
                result["error"] = exc
            done.set()

        thread = threading.Thread(
            target=run, name=f"probe-{self.name}", daemon=True
        )
        thread.start()
        if not done.wait(timeout_s):
            self.mark_lost("probe_timeout")
            return False
        if "ok" in result:
            return True
        if isinstance(result.get("error"), BackendLostError):
            self.mark_lost("backend_lost")
        return False

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Per-replica /healthz block: tier, health, breaker, brownout,
        occupancy — the router aggregates these."""
        stats = self.scheduler.stats()
        snap: Dict[str, Any] = {
            "tier": self.tier,
            "health": self.health,
            "queue_depth": stats["queue_depth"],
            "inflight": stats["inflight"],
            "max_queue_depth": stats["max_queue_depth"],
            "max_inflight": stats["max_inflight"],
            "workers_alive": stats["workers_alive"],
            "device_batches": stats["device_batches"],
        }
        if self.lost_reason:
            snap["lost_reason"] = self.lost_reason
        if not self.transport_ok:
            snap["transport"] = {
                "ok": False, "reason": self.transport_reason,
            }
        for key in ("engine", "circuit_breaker", "brownout"):
            if key in stats:
                snap[key] = stats[key]
        return snap


#: How long a respawn on the card waits for its corpse's backend to be
#: freed: a replica lost inside a backend call finishes that device work
#: first (a kill takes effect at the next call), and its engine thread only
#: then lets go of the backend.
DEVICE_RELEASE_TIMEOUT_S = 60.0


def _release_device_memory(stack: Optional["weakref.ref"] = None,
                           timeout_s: float = DEVICE_RELEASE_TIMEOUT_S) -> None:
    """Give a retired replica's device memory back before a fresh stack is
    built: wait (bounded) until the dead backend stack ``stack`` names is
    garbage, then return the caching allocator's freed blocks to the card.
    A card that holds two resident replicas has no room for a third, so a
    respawn must not overlap its corpse.  Without a card (no torch, or CUDA
    never initialised) there is no device pool: one collection, no wait."""
    gc.collect()
    if not _device_pool_active():
        return
    deadline = time.monotonic() + timeout_s
    while stack is not None and stack() is not None and time.monotonic() < deadline:
        time.sleep(0.05)
        gc.collect()
    sys.modules["torch"].cuda.empty_cache()


def _device_pool_active() -> bool:
    """Whether this process holds a CUDA caching allocator's pool."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized()


def _name_index(name: str) -> int:
    """Numeric suffix of a replica name (``r12`` -> 12); -1 when absent.
    Spawn naming and scale-down victim selection both key on it."""
    digits = ""
    for ch in reversed(name):
        if ch.isdigit():
            digits = ch + digits
        else:
            break
    return int(digits) if digits else -1


class ReplicaManager:
    """Replica lifecycle: respawn lost members, reconcile a target count,
    and warm-hand prefix KV over the replica seam.

    The health ladder (above) DETECTS loss; this layer makes loss
    recoverable.  A monitor thread runs three duties per tick:

    1. **Harvest** — healthy replicas' prefix caches are captured into the
       fleet :class:`~consensus_tpu_torch.serve.pagestore.PageStore` on a
       bounded cadence, so the store always holds a recent snapshot of the
       fleet's hottest page runs (a replica's last harvest survives its
       death — that is the whole point).
    2. **Respawn** — a member whose ladder latched ``lost`` is removed
       from the router immediately, its corpse retired on a background
       thread (``drain=False`` with a short timeout: a wedged worker must
       not block the fleet), and a fresh stack is built by the
       ``replica_factory`` under the SAME name after a bounded exponential
       backoff — same name means rendezvous hashing restores the exact
       pre-loss scenario mapping, so the warm pages seeded from the store
       land where their scenarios route.  A flap detector quarantines a
       name that dies ``flap_threshold`` times within ``flap_window_s``
       instead of respawn-looping it; quarantined slots are NOT backfilled
       (the effective target shrinks) until an operator calls
       :meth:`clear_quarantine` — a flapping unit signals a fault no fresh
       stack will outrun.
    3. **Reconcile** — live-plus-pending membership converges on
       ``target`` (driven by the autoscaler or :meth:`set_target`):
       scale-up spawns fresh names seeded warm from the store; scale-down
       retires the highest-numbered healthy member with a full drain.

    ``replica_factory(name, tier)`` must return an UNSTARTED
    :class:`Replica` over a fresh backend instance; the manager starts it,
    seeds its engine's prefix caches from the store, and only then
    registers it with the router — a joining replica never takes traffic
    cold.
    """

    def __init__(
        self,
        router,
        replica_factory: Callable[[str, Optional[str]], Replica],
        *,
        page_store=None,
        registry: Optional[Registry] = None,
        respawn_backoff_s: float = 0.25,
        respawn_backoff_max_s: float = 5.0,
        flap_window_s: float = 30.0,
        flap_threshold: int = 3,
        check_interval_s: float = 0.2,
        harvest_interval_s: float = 0.5,
        retire_timeout_s: float = 2.0,
        transport_probe_failures: int = 2,
        auto_start: bool = True,
        clock=time.monotonic,
    ):
        self.router = router
        self.factory = replica_factory
        self.page_store = page_store
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_max_s = float(respawn_backoff_max_s)
        self.flap_window_s = float(flap_window_s)
        self.flap_threshold = max(1, int(flap_threshold))
        self.check_interval_s = float(check_interval_s)
        self.harvest_interval_s = float(harvest_interval_s)
        self.retire_timeout_s = float(retire_timeout_s)
        self._clock = clock
        self._lock = threading.RLock()
        self.target = len(router.replicas)
        self.respawns = 0
        self.losses = 0
        self._loss_times: Dict[str, List[float]] = {}
        self._backoffs: Dict[str, float] = {}
        #: name -> (due time, tier) for pending respawns.
        self._pending: Dict[str, Any] = {}
        self._quarantined: Dict[str, str] = {}
        self._last_harvest = 0.0
        #: Transport-probe ladder: consecutive failures per replica name;
        #: at ``transport_probe_failures`` the replica is marked
        #: transport-partitioned (DEGRADED, auto-healing) — the seam
        #: analogue of the flap quarantine, except probes clear it.
        self.transport_probe_failures = max(1, int(transport_probe_failures))
        self._transport_fails: Dict[str, int] = {}
        self._partitioned: Dict[str, float] = {}
        self._partition_events: List[Dict[str, float]] = []
        self._next_index = 1 + max(
            (_name_index(r.name) for r in router.replicas), default=-1
        )
        #: Rolling-restart state: while True, reconciliation is paused so
        #: the one-at-a-time drain window is not "fixed" by a scale-up.
        self._restarting = False
        self.restarts = 0
        #: Completed per-replica restart events (monotonic stamps, for the
        #: loadgen timeline): {replica, started_s, completed_s,
        #: warm_seeded}.
        self._restart_events: List[Dict[str, Any]] = []
        #: name -> runs adopted by the last _spawn's warm seed (the
        #: warm-seed-fraction evidence for respawned/restarted replicas).
        self._warm_seeded: Dict[str, int] = {}
        #: name -> (the thread tearing down that name's last corpse, a weak
        #: reference to the corpse's backend stack); a respawn under the
        #: name waits for both, so the corpse's device memory is free before
        #: the fresh backend is built.
        self._retiring: Dict[str, Any] = {}

        reg = registry if registry is not None else get_registry()
        self._m_respawns = reg.counter(
            "fleet_respawns_total",
            "Lost replicas replaced with a fresh stack under the same "
            "name (warm-seeded from the PageStore when one is attached).",
        )
        self._m_quarantined = reg.counter(
            "fleet_quarantined_total",
            "Replica names quarantined by the flap detector (>= threshold "
            "losses inside the window) instead of respawned.",
        )
        self._m_target = reg.gauge(
            "fleet_target_replicas",
            "Replica count the lifecycle manager is converging the fleet "
            "toward (autoscaler-driven when one is attached).",
        )
        self._m_target.set(self.target)
        self._m_rolling = reg.counter(
            "fleet_rolling_restarts_total",
            "Replicas cycled by rolling_restart() (drain -> capture -> "
            "respawn -> warm-seed -> health-gated rejoin).",
        )

        router.manager = self
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self._thread = threading.Thread(
                target=self._loop, name="replica-manager", daemon=True
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

    # -- control surface ----------------------------------------------------

    def set_target(self, n: int) -> int:
        """Desired replica count (autoscaler / operator).  Clamped to >= 1;
        reconciliation happens on the next tick."""
        with self._lock:
            self.target = max(1, int(n))
            self._m_target.set(self.target)
            get_flight_recorder().record_event(
                "scale_target", target=self.target)
            return self.target

    def clear_quarantine(self, name: str) -> bool:
        """Operator override: forget a name's flap history and schedule an
        immediate respawn for it."""
        with self._lock:
            if name not in self._quarantined:
                return False
            del self._quarantined[name]
            self._loss_times.pop(name, None)
            self._backoffs.pop(name, None)
            self._pending[name] = (self._clock(), None)
            return True

    # -- monitor duties -----------------------------------------------------

    def tick(self) -> None:
        """One monitor pass (public so tests can step deterministically)."""
        now = self._clock()
        self._probe_transport(now)
        self._harvest(now)
        self._detect_losses(now)
        self._process_pending(now)
        self._reconcile(now)

    def _store_client(self, name: str):
        """The store's named transport client for one replica (falls back
        to the store itself for stores without the transport seam)."""
        client_of = getattr(self.page_store, "client", None)
        return client_of(name) if callable(client_of) else self.page_store

    def _probe_transport(self, now: float) -> None:
        """Per-replica transport health: each live replica probes the
        store through its OWN named client, so a partition isolating one
        peer fails exactly that peer's probes.  ``transport_probe_failures``
        consecutive failures mark the replica DEGRADED (routed around,
        not lost); the first passing probe heals it and records the
        partition event with its detect/clear timestamps — recovery time
        after a partition heals is ``cleared_s`` minus the window end."""
        if self.page_store is None:
            return
        if not callable(getattr(self.page_store, "client", None)):
            return
        for replica in self.router.replicas:
            if replica.lost:
                continue
            try:
                ok = self._store_client(replica.name).probe(attempts=1)
            except Exception:
                ok = False
            name = replica.name
            if ok:
                self._transport_fails[name] = 0
                detected = self._partitioned.pop(name, None)
                if detected is not None:
                    replica.transport_ok = True
                    replica.transport_reason = ""
                    with self._lock:
                        self._partition_events.append({
                            "replica": name,
                            "detected_s": detected,
                            "cleared_s": now,
                        })
                        del self._partition_events[:-32]
                    get_flight_recorder().record_event(
                        "transport_heal", replica=name,
                        partitioned_s=now - detected)
                continue
            fails = self._transport_fails.get(name, 0) + 1
            self._transport_fails[name] = fails
            if fails >= self.transport_probe_failures and (
                    name not in self._partitioned):
                self._partitioned[name] = now
                replica.transport_ok = False
                replica.transport_reason = (
                    f"transport probe failed x{fails}")
                get_flight_recorder().record_event(
                    "transport_partition", replica=name, failures=fails)

    def _harvest(self, now: float) -> None:
        if self.page_store is None:
            return
        if now - self._last_harvest < self.harvest_interval_s:
            return
        self._last_harvest = now
        for replica in self.router.replicas:
            if replica.lost:
                continue
            engine = replica.scheduler.batching.engine
            if engine is not None:
                try:
                    self._store_client(replica.name).capture_engine(engine)
                except Exception:
                    # A replica dying mid-harvest is the loss path's
                    # problem, not the harvester's.
                    continue

    def _detect_losses(self, now: float) -> None:
        for replica in self.router.replicas:
            if not replica.lost:
                continue
            corpse = self.router.remove_replica(replica.name)
            if corpse is None:
                continue
            self._retire_async(corpse, drain=False)
            with self._lock:
                self.losses += 1
                history = [
                    t for t in self._loss_times.get(replica.name, [])
                    if now - t <= self.flap_window_s
                ]
                history.append(now)
                self._loss_times[replica.name] = history
                if len(history) >= self.flap_threshold:
                    self._quarantined[replica.name] = (
                        f"{len(history)} losses in {self.flap_window_s:g}s"
                    )
                    self._pending.pop(replica.name, None)
                    self._m_quarantined.inc()
                    get_flight_recorder().record_event(
                        "quarantine", replica=replica.name,
                        losses=len(history),
                        window_s=self.flap_window_s)
                    continue
                backoff = self._backoffs.get(
                    replica.name, self.respawn_backoff_s
                )
                self._backoffs[replica.name] = min(
                    backoff * 2.0, self.respawn_backoff_max_s
                )
                self._pending[replica.name] = (now + backoff, corpse.tier)

    def _process_pending(self, now: float) -> None:
        with self._lock:
            due = [
                (name, tier) for name, (at, tier) in self._pending.items()
                if now >= at
            ]
            for name, _ in due:
                del self._pending[name]
        for name, tier in due:
            try:
                self._spawn(name, tier, respawn=True)
            except Exception:
                # Factory failure: back off and try again — a transient
                # (e.g. the replaced backend still tearing down) must not
                # permanently shrink the fleet.
                with self._lock:
                    backoff = self._backoffs.get(
                        name, self.respawn_backoff_s)
                    self._backoffs[name] = min(
                        backoff * 2.0, self.respawn_backoff_max_s)
                    self._pending[name] = (now + backoff, tier)

    def _reconcile(self, now: float) -> None:
        if self._restarting:
            # A rolling restart deliberately runs one member below target
            # during each drain window; backfilling that hole would spawn
            # an extra replica the restart never asked for.
            return
        with self._lock:
            effective_target = max(1, self.target - len(self._quarantined))
            pending = len(self._pending)
        live = [r for r in self.router.replicas if not r.lost]
        have = len(live) + pending
        if have < effective_target:
            for _ in range(effective_target - have):
                with self._lock:
                    name = f"r{self._next_index}"
                    self._next_index += 1
                try:
                    self._spawn(name, None, respawn=False)
                except Exception:
                    break
        elif have > effective_target and live:
            # Retire the newest (highest-numbered) healthy member with a
            # full drain; in-flight work completes, then the stack closes.
            victims = sorted(
                (r for r in live if r.health == HEALTHY),
                key=lambda r: _name_index(r.name),
            )
            for _ in range(min(have - effective_target, len(victims))):
                victim = victims.pop()
                removed = self.router.remove_replica(victim.name)
                if removed is not None:
                    get_flight_recorder().record_event(
                        "scale_down", replica=removed.name)
                    self._retire_async(removed, drain=True)

    # -- rolling restart ----------------------------------------------------

    def rolling_restart(
        self,
        drain_timeout_s: float = 10.0,
        health_timeout_s: float = 10.0,
        poll_interval_s: float = 0.02,
    ) -> Dict[str, Any]:
        """Cycle every live replica through a zero-loss restart, ONE at a
        time: drain → capture prefix KV to the store (and, when the store
        is disk-backed, to disk) → respawn a fresh stack under the same
        name → warm-seed it from the store → health-gated rejoin.  The
        next member starts only after the previous one rejoined HEALTHY;
        a member that fails its health gate ABORTS the remainder (the
        fleet is left with N-0 members serving — the unhealthy respawn
        stays registered so the loss ladder/respawn path deals with it).

        Removing the member from the router BEFORE its drain means new
        traffic fails over immediately; in-flight work completes inside
        the drain.  Reconciliation is paused for the duration so the
        deliberate one-member hole is not backfilled, and the member's
        flap history is cleared — a deliberate restart is not a flap.

        Returns ``{restarted, aborted, events}`` (monotonic stamps, ready
        for the loadgen timeline)."""
        plan = [
            (r.name, r.tier) for r in self.router.replicas if not r.lost
        ]
        result: Dict[str, Any] = {
            "restarted": [], "aborted": None, "events": [],
        }
        self._restarting = True
        get_flight_recorder().record_event(
            "rolling_restart_begin", replicas=len(plan))
        try:
            for name, tier in plan:
                replica = next(
                    (r for r in self.router.replicas if r.name == name),
                    None,
                )
                if replica is None or replica.lost:
                    continue  # lost since planning: the respawn path owns it
                started = self._clock()
                if self.page_store is not None:
                    engine = replica.scheduler.batching.engine
                    if engine is not None:
                        try:
                            self._store_client(name).capture_engine(engine)
                        except Exception:
                            pass  # restart proceeds; the rejoin seeds cold
                corpse = self.router.remove_replica(name)
                if corpse is None:
                    continue
                # Synchronous drain — the "one at a time" contract.
                corpse.shutdown(drain=True, timeout=drain_timeout_s)
                # Drop the drained stack before its successor is built.
                stack = weakref.ref(corpse.kill_switch.inner)
                corpse = replica = None
                _release_device_memory(stack)
                with self._lock:
                    # A deliberate restart is not a flap.
                    self._loss_times.pop(name, None)
                    self._backoffs.pop(name, None)
                fresh = self._spawn(name, tier, respawn=False)
                deadline = self._clock() + health_timeout_s
                while (fresh.health != HEALTHY
                       and self._clock() < deadline):
                    time.sleep(poll_interval_s)
                if fresh.health != HEALTHY:
                    result["aborted"] = name
                    get_flight_recorder().record_event(
                        "rolling_restart_abort", replica=name,
                        health=fresh.health)
                    break
                completed = self._clock()
                with self._lock:
                    self.restarts += 1
                    event = {
                        "replica": name,
                        "started_s": started,
                        "completed_s": completed,
                        "warm_seeded": self._warm_seeded.get(name, 0),
                    }
                    self._restart_events.append(event)
                    del self._restart_events[:-32]
                self._m_rolling.inc()
                result["restarted"].append(name)
                result["events"].append(dict(event))
                get_flight_recorder().record_event(
                    "rolling_restart_member", replica=name,
                    took_s=completed - started,
                    warm_seeded=event["warm_seeded"])
        finally:
            self._restarting = False
        return result

    # -- spawn / retire -----------------------------------------------------

    def _spawn(self, name: str, tier: Optional[str],
               respawn: bool) -> Replica:
        retiring = self._retiring.pop(name, None)
        if retiring is not None:
            thread, stack = retiring
            thread.join(self.retire_timeout_s)
            _release_device_memory(stack)
        replica = self.factory(name, tier)
        replica.start()
        if self.page_store is not None:
            engine = replica.scheduler.batching.engine
            if engine is not None:
                try:
                    adopted = self._store_client(name).seed_engine(engine)
                except Exception:
                    adopted = 0  # cold join is a degraded start, not a failure
                with self._lock:
                    self._warm_seeded[name] = int(adopted or 0)
        self.router.add_replica(replica)
        get_flight_recorder().record_event(
            "respawn" if respawn else "scale_up", replica=name)
        if respawn:
            with self._lock:
                self.respawns += 1
            self._m_respawns.inc()
        return replica

    def _retire_async(self, corpse: Replica, drain: bool) -> None:
        """Corpse teardown on a background thread: a wedged worker (the
        hang the watchdog just converted to a loss) would otherwise block
        the monitor for the full drain timeout."""
        thread = threading.Thread(
            target=corpse.shutdown,
            kwargs={"drain": drain, "timeout": self.retire_timeout_s},
            name=f"retire-{corpse.name}", daemon=True,
        )
        self._retiring[corpse.name] = (thread, weakref.ref(corpse.kill_switch.inner))
        thread.start()

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "target": self.target,
                "effective_target": max(
                    1, self.target - len(self._quarantined)),
                "respawns": self.respawns,
                "losses": self.losses,
                "pending_respawns": sorted(self._pending),
                "quarantined": dict(self._quarantined),
                "partitioned": dict(self._partitioned),
                "partition_events": [
                    dict(e) for e in self._partition_events],
                "flap_threshold": self.flap_threshold,
                "flap_window_s": self.flap_window_s,
                "restarts": self.restarts,
                "restarting": self._restarting,
                "restart_events": [dict(e) for e in self._restart_events],
                "warm_seeded": dict(self._warm_seeded),
                "page_store": (
                    self.page_store.stats()
                    if self.page_store is not None else None
                ),
            }
