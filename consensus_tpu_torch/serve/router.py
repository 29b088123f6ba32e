"""Fleet router: health-gated, scenario-affine routing over N replicas.

PyTorch port of ``consensus_tpu/serve/router.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

Sits where a single :class:`RequestScheduler` used to sit (the HTTP front
end is oblivious — :class:`FleetRouter` and :class:`FleetTicket` duck-type
the scheduler/ticket surface) and adds the fleet semantics:

* **Health-gated routing.**  Placement only considers replicas whose
  derived health allows it: ``lost`` and ``draining`` replicas are never
  candidates; ``degraded`` (breaker-open) replicas are last-resort
  fallbacks.  Health combines passive signals (the breaker state and the
  device-loss flags the supervisor/engine latch while serving) with an
  optional periodic active probe.
* **Scenario affinity.**  Rendezvous (highest-random-weight) hashing on
  the request's issue text: requests for the same scenario land on the
  same replica while it is healthy, and ONLY the dead replica's scenarios
  move when one is lost.  This is what makes the per-replica prefix KV
  cache (backends/engine.py) effective under fleet serving: the scenario's
  cached prompt pages live on its rendezvous-first replica, so the router
  tracks an ``affinity_hit_rate`` — the fraction of dispatches that landed
  there (misses are spillover, failover, and hedges: the cold-cache
  dispatches).
* **Transparent failover.**  A request whose replica dies mid-flight
  (``BackendLostError``, probe timeout, drain) is re-dispatched to a
  healthy replica under its ORIGINAL deadline.  Results are bit-identical
  across replicas by construction — every request carries its own seed and
  the backends derive per-request PRNG keys from it, so a failed-over
  retry reproduces the exact bytes the first attempt would have produced.
  Failed-over requests are re-queued, never re-rejected: admission decided
  once, at the original ``submit``; after that a momentary queue-full on
  the survivors is absorbed by a bounded retry loop under the deadline.
* **Hedged dispatch** (optional).  With ``hedge_after_s`` set, a ticket
  still unresolved after that long is duplicated onto a second healthy
  replica; first completion wins, the loser is cancelled.  Bit-identity
  makes hedging safe: both copies would return the same bytes.
* **Model-tier routing.**  Replicas carry a ``tier`` label (e.g. ``full``
  vs a smaller/quantized ``small`` model pool).  Under aggregate pressure
  the tier lever escalates and new requests route to the next tier — a
  fleet-level brownout lever that trades model quality for availability,
  complementing the per-replica budget-scaling brownout.  Responses served
  by a non-default tier are stamped ``degraded`` with
  ``degraded_reason="tier_routed"``; every fleet response records
  ``served_tier`` and ``served_by``.

Obs families: ``fleet_replicas_{healthy,draining,lost}`` (gauges),
``fleet_failovers_total{reason}``, ``fleet_routed_total{replica,tier}``,
``fleet_hedges_total``, ``fleet_affinity_{hits,misses}_total`` (counters),
``fleet_serving_tier`` (gauge).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from consensus_tpu_torch.backends.base import BackendLostError
from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.obs.trace import trace_current, use_trace
from consensus_tpu_torch.serve.fleet import DEGRADED, HEALTHY, Replica
from consensus_tpu_torch.serve.scheduler import (
    IdempotencyCache,
    RequestTimeout,
    SchedulerRejected,
    Ticket,
    idempotency_key,
)

#: Waiter-loop granularity: how often a parked waiter re-checks the serving
#: replica's liveness (bounds detection of a replica that hangs without
#: erroring).  Event-driven completion is still immediate.
_CHECK_S = 0.2
#: Poll granularity while TWO inner tickets are live (hedged): stdlib
#: events cannot be waited on as a set, so the waiter polls both.
_PAIR_POLL_S = 0.02
#: Backoff between failover re-queue attempts while survivors' queues are
#: momentarily full.
_FAILOVER_RETRY_S = 0.05

#: SchedulerRejected reasons that mean "this replica went away", not "this
#: request is bad" — failover-eligible.
_FAILOVER_REJECTIONS = frozenset({"draining", "stopped"})


def _rendezvous_weight(key: str, name: str) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(key.encode("utf-8", "replace"))
    h.update(b"\x1f")
    h.update(name.encode("utf-8", "replace"))
    return int.from_bytes(h.digest(), "big")


def _scenario_key(request: Any) -> str:
    if isinstance(request, dict):
        return str(request.get("issue", ""))
    return str(getattr(request, "issue", ""))


class _TierLever:
    """Hysteresis for the fleet-level tier: escalate at ``enter`` pressure,
    de-escalate at ``exit``, with a minimum dwell so the lever cannot
    flap request-to-request (same discipline as the brownout controller's
    tier ladder, one level up)."""

    def __init__(self, n_tiers: int, enter: float = 0.85, exit: float = 0.5,
                 min_dwell_s: float = 2.0, clock=time.monotonic):
        self.n_tiers = max(1, n_tiers)
        self.enter = enter
        self.exit = exit
        self.min_dwell_s = min_dwell_s
        self._clock = clock
        self._lock = threading.Lock()
        self.index = 0
        self._changed_at = clock()

    def update(self, pressure: float) -> int:
        with self._lock:
            now = self._clock()
            if now - self._changed_at < self.min_dwell_s:
                return self.index
            if pressure >= self.enter and self.index < self.n_tiers - 1:
                self.index += 1
                self._changed_at = now
            elif pressure <= self.exit and self.index > 0:
                self.index -= 1
                self._changed_at = now
            return self.index


class FleetTicket:
    """Fleet-level handle for one admitted request.

    Duck-types the scheduler :class:`Ticket` surface the HTTP front end
    uses (``wait`` / ``done`` / ``cancel`` / ``result`` / ``remaining`` /
    ``outcome`` / ``attempts``).  Failover and hedging run on the waiter's
    thread inside :meth:`wait` — there is no per-request escort thread;
    the contract is that every admitted fleet ticket has a waiter (the
    HTTP handler thread that submitted it).
    """

    def __init__(self, router: "FleetRouter", request: Any,
                 deadline: Optional[float]):
        self._router = router
        self.request = request
        self.deadline = deadline
        self.submitted = time.monotonic()
        self.outcome: Optional[str] = None
        self.dispatches = 0  # inner submissions (1 + failovers + hedges)
        self.failovers = 0
        self.hedged = False
        self.tried: set = set()  # replica names this request touched
        self._lock = threading.Lock()
        #: Live (inner ticket, replica) pairs: [primary] or [primary, hedge].
        self._pairs: List[Tuple[Ticket, Replica]] = []
        #: Set with a failover reason when no inner ticket is live and the
        #: request still needs a replica (re-queue loop).
        self._needs_dispatch: Optional[str] = None
        self._value: Any = None
        self._error: Optional[BaseException] = None
        #: Best terminal error to surface if the whole fleet dies mid-failover.
        self._last_error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancelled = threading.Event()
        #: Request-scoped trace carrier: captured once at fleet submit;
        #: every dispatch (primary / failover / hedge) opens a "dispatch"
        #: span keyed here by the inner ticket's identity so the waiter
        #: loop can close it with the dispatch's fate.
        self.trace = None
        self._span_parent: Optional[int] = None
        self._span_by_ticket: Dict[int, int] = {}

    # -- waiter surface ----------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        end = time.monotonic() + timeout if timeout is not None else None
        while not self._done.is_set():
            now = time.monotonic()
            if end is not None and now >= end:
                break
            slice_s = _CHECK_S if end is None else min(_CHECK_S, end - now)
            self._router._advance(self, slice_s)
        return self._done.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        self._cancelled.set()
        with self._lock:
            pairs = list(self._pairs)
        for ticket, _ in pairs:
            ticket.cancel()

    def result(self) -> Any:
        if not self._done.is_set():
            raise RequestTimeout("request still pending")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        remaining = self.remaining()
        return remaining is not None and remaining <= 0

    @property
    def attempts(self) -> int:
        with self._lock:
            inner = sum(t.attempts for t, _ in self._pairs)
        return max(self.dispatches, inner)

    # -- router side -------------------------------------------------------

    def _attach(self, ticket: Ticket, replica: Replica,
                span: int = 0) -> None:
        with self._lock:
            self._pairs.append((ticket, replica))
            self._needs_dispatch = None
        if span:
            self._span_by_ticket[id(ticket)] = span
        self.dispatches += 1
        self.tried.add(replica.name)

    def _end_dispatch_span(self, inner: Ticket, **attrs: Any) -> None:
        """Close the dispatch span opened for ``inner`` (no-op untraced)."""
        if self.trace is None:
            return
        span = self._span_by_ticket.pop(id(inner), 0)
        self.trace.end(span, **attrs)

    def _resolve(self, outcome: str, value: Any = None,
                 error: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self.outcome = outcome
            self._value = value
            self._error = error
            pairs, self._pairs = self._pairs, []
        for ticket, _ in pairs:
            if not ticket.done():
                ticket.cancel()
            # A hedge loser (or an attempt obsoleted by resolution) closes
            # as cancelled; the winner's span was already closed final.
            self._end_dispatch_span(ticket, outcome="cancelled")
        self._done.set()


class FleetRouter:
    """Routing tier above N per-replica :class:`RequestScheduler` stacks."""

    def __init__(
        self,
        replicas: List[Replica],
        *,
        registry: Optional[Registry] = None,
        default_timeout_s: Optional[float] = 120.0,
        hedge_after_s: Optional[float] = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: Optional[float] = None,
        tier_enter_pressure: float = 0.85,
        tier_exit_pressure: float = 0.5,
        tier_min_dwell_s: float = 2.0,
        idempotency_cache: Optional[IdempotencyCache] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        #: Membership is copy-on-write: every mutation (join/retire) builds
        #: a fresh list under ``_members_lock`` and swaps the reference, so
        #: the many lock-free readers (placement, pressure, stats, probe)
        #: see a consistent snapshot without taking a lock per read.
        self.replicas = list(replicas)
        self._members_lock = threading.Lock()
        #: Attached lifecycle layers (set by serve wiring when elastic):
        #: the ReplicaManager that respawns lost members and the Autoscaler
        #: driving its target count.  The router closes both at shutdown.
        self.manager = None
        self.autoscaler = None
        self.default_timeout_s = default_timeout_s
        self.hedge_after_s = hedge_after_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        #: Tier order = first appearance across the replica list; index 0
        #: ("full" by default) is the default tier — anything else stamps
        #: the response degraded/tier_routed.
        self.tiers: List[str] = []
        for replica in self.replicas:
            if replica.tier not in self.tiers:
                self.tiers.append(replica.tier)
        self._lever = _TierLever(
            len(self.tiers), enter=tier_enter_pressure,
            exit=tier_exit_pressure, min_dwell_s=tier_min_dwell_s,
        )

        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._m_healthy = reg.gauge(
            "fleet_replicas_healthy",
            "Replicas currently routable at full preference.")
        self._m_draining = reg.gauge(
            "fleet_replicas_draining", "Replicas draining (not routable).")
        self._m_lost = reg.gauge(
            "fleet_replicas_lost",
            "Replicas whose backend is gone for good.")
        self._m_failovers = reg.counter(
            "fleet_failovers_total",
            "Requests re-dispatched to another replica after theirs died "
            "mid-flight, by reason "
            "(backend_lost|replica_lost|probe_timeout|drain).",
            labels=("reason",),
        )
        self._m_routed = reg.counter(
            "fleet_routed_total",
            "Requests dispatched to a replica (failovers and hedges count "
            "each dispatch), by replica and tier.",
            labels=("replica", "tier"),
        )
        self._m_hedges = reg.counter(
            "fleet_hedges_total",
            "Hedge dispatches issued for tail-latency-critical tickets.")
        #: Shared completed-result cache (set by fleet wiring): a failover
        #: whose request already finished on the dying replica resolves
        #: from here instead of executing twice — the zero-duplicates
        #: invariant the chaos conformance suite pins.
        self.idempotency_cache = idempotency_cache
        self._m_idempotent = reg.counter(
            "fleet_idempotent_hits_total",
            "Failover re-dispatches resolved from the fleet idempotency "
            "cache (the first replica completed the request before dying; "
            "the cached result is re-delivered, not recomputed).")
        #: Scenario affinity effectiveness: a hit means the request landed
        #: on its rendezvous-first replica — the one holding the scenario's
        #: warm prefix-cache entries.  Misses (spillover under backpressure,
        #: failover, hedges) are exactly the dispatches that start cold.
        self._m_affinity_hits = reg.counter(
            "fleet_affinity_hits_total",
            "Dispatches that landed on the scenario's rendezvous-first "
            "replica (warm prefix cache).")
        self._m_affinity_misses = reg.counter(
            "fleet_affinity_misses_total",
            "Dispatches that landed off the scenario's rendezvous-first "
            "replica (spillover, failover, or hedge — cold prefix cache).")
        self._m_tier = reg.gauge(
            "fleet_serving_tier",
            "Current tier-lever index (0 = full-model tier).")

        self._counts_lock = threading.Lock()
        self.failovers_total = 0
        self.failover_reasons: Dict[str, int] = {}
        self.hedges_total = 0
        self.routed_counts: Dict[str, int] = {r.name: 0 for r in self.replicas}
        self.affinity_hits = 0
        self.affinity_misses = 0

        self._draining = False
        self._stop_probe = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetRouter":
        for replica in self.replicas:
            replica.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-probe", daemon=True
        )
        self._probe_thread.start()
        self._refresh_gauges()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        self._draining = True
        # Lifecycle layers first: a respawn or scale event racing the
        # drain would re-add members mid-shutdown.
        if self.autoscaler is not None:
            self.autoscaler.close()
        if self.manager is not None:
            self.manager.close()
        self._stop_probe.set()
        threads = [
            threading.Thread(
                target=replica.shutdown,
                kwargs={"drain": drain, "timeout": timeout},
                name=f"drain-{replica.name}", daemon=True,
            )
            for replica in self.replicas
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=timeout)
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
        self._refresh_gauges()

    @property
    def inner_backend(self):
        return self.replicas[0].scheduler.inner_backend

    def kill_replica(self, name: str, reason: str = "killed") -> None:
        """Operational kill switch (loadgen ``--kill-replica-at-s``, chaos
        benches): the named replica's backend starts raising
        BackendLostError and routing drops it immediately."""
        self._replica(name).kill(reason)
        self._refresh_gauges()

    def _replica(self, name: str) -> Replica:
        for replica in self.replicas:
            if replica.name == name:
                return replica
        raise KeyError(f"no replica named {name!r}")

    # -- elastic membership -------------------------------------------------

    def add_replica(self, replica: Replica) -> None:
        """Join a (started) replica.  Rendezvous hashing makes the
        rebalance minimal by construction: only scenario keys the new name
        wins move to it; every other key keeps its replica and its warm
        prefix pages.  Re-joining under a RETIRED member's name restores
        that name's rendezvous mapping exactly — which is why the manager
        respawns under the corpse's name."""
        with self._members_lock:
            if any(r.name == replica.name for r in self.replicas):
                raise ValueError(
                    f"replica name {replica.name!r} already in the fleet")
            if replica.tier not in self.tiers:
                self.tiers.append(replica.tier)
                self._lever.n_tiers = len(self.tiers)
            self.replicas = self.replicas + [replica]
        with self._counts_lock:
            self.routed_counts.setdefault(replica.name, 0)
        self._refresh_gauges()

    def remove_replica(self, name: str) -> Optional[Replica]:
        """Drop a member from routing (corpse retirement or scale-down).
        The replica object is returned so the caller can drain/shut it
        down; its routed_counts history is kept — lifetime accounting
        outlives membership.  Unknown names are a no-op (the manager and a
        concurrent shutdown may race)."""
        removed: Optional[Replica] = None
        with self._members_lock:
            keep = []
            for replica in self.replicas:
                if replica.name == name and removed is None:
                    removed = replica
                else:
                    keep.append(replica)
            if removed is not None and keep:
                self.replicas = keep
            elif removed is not None:
                # Never route against an empty list — keep the corpse; its
                # lost health already excludes it from placement.
                removed = None
        self._refresh_gauges()
        return removed

    # -- placement ---------------------------------------------------------

    def route_for(self, request: Any) -> Optional[Replica]:
        """The replica a request would be placed on right now (None when
        nothing is routable).  Debug/test surface."""
        candidates = self._candidates(
            _scenario_key(request), self.tiers[self._lever.index]
        )
        return candidates[0] if candidates else None

    def _candidates(self, key: str, tier: str,
                    exclude: Optional[set] = None) -> List[Replica]:
        """Routable replicas, best first: healthy in the serving tier, then
        healthy elsewhere (spillover — serving from another tier beats
        rejecting), then breaker-open replicas as a last resort.  Within
        each class, rendezvous order on the scenario key."""

        def ranked(pool: List[Replica]) -> List[Replica]:
            return sorted(
                pool,
                key=lambda r: _rendezvous_weight(key, r.name),
                reverse=True,
            )

        exclude = exclude or set()
        healthy = [
            r for r in self.replicas
            if r.health == HEALTHY and r.name not in exclude
        ]
        degraded = [
            r for r in self.replicas
            if r.health == DEGRADED and r.name not in exclude
        ]
        in_tier = [r for r in healthy if r.tier == tier]
        off_tier = [r for r in healthy if r.tier != tier]
        return ranked(in_tier) + ranked(off_tier) + ranked(degraded)

    def _pressure(self) -> float:
        """Aggregate load signal feeding the tier lever: worst of mean
        queue occupancy and (damped) mean inflight occupancy across live
        replicas, plus the lost fraction — a half-dead fleet is under
        pressure even while the survivors' queues are short."""
        total = len(self.replicas)
        live_stats = []
        lost = 0
        for replica in self.replicas:
            if replica.lost:
                lost += 1
                continue
            stats = replica.scheduler.stats()
            live_stats.append((
                stats["queue_depth"] / max(1, stats["max_queue_depth"]),
                stats["inflight"] / max(1, stats["max_inflight"]),
            ))
        if not live_stats:
            return 2.0
        queue_frac = sum(s[0] for s in live_stats) / len(live_stats)
        inflight_frac = sum(s[1] for s in live_stats) / len(live_stats)
        return max(queue_frac, 0.6 * inflight_frac) + lost / total

    def _serving_tier(self) -> str:
        if len(self.tiers) > 1:
            self._lever.update(self._pressure())
        self._m_tier.set(self._lever.index)
        return self.tiers[self._lever.index]

    # -- admission ---------------------------------------------------------

    def submit(self, request: Any,
               timeout_s: Optional[float] = None) -> FleetTicket:
        """Admit ``request`` onto the best replica or raise
        :class:`SchedulerRejected`.  Admission happens exactly once, here:
        failover later re-queues without re-admission."""
        if self._draining:
            raise SchedulerRejected(
                "draining", "fleet is draining; not accepting requests")
        if timeout_s is None:
            timeout_s = getattr(request, "timeout_s", None)
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        deadline = (
            time.monotonic() + float(timeout_s) if timeout_s is not None
            else None
        )
        ticket = FleetTicket(self, request, deadline)
        active = trace_current()
        if active is not None:
            ticket.trace, ticket._span_parent = active
        tier = self._serving_tier()
        candidates = self._candidates(_scenario_key(request), tier)
        if not candidates:
            raise SchedulerRejected(
                "no_replica", "no routable replica in the fleet")
        last: Optional[SchedulerRejected] = None
        for replica in candidates:
            span = self._begin_dispatch_span(ticket, replica, "primary")
            try:
                with use_trace(ticket.trace, span):
                    inner = replica.scheduler.submit(
                        request, timeout_s=ticket.remaining())
            except SchedulerRejected as exc:
                if ticket.trace is not None:
                    ticket.trace.end(span, outcome="rejected",
                                     rejected_reason=exc.reason)
                last = exc
                continue
            ticket._attach(inner, replica, span)
            self._count_routed(replica, affinity_hit=replica is candidates[0])
            self._refresh_gauges()
            return ticket
        assert last is not None
        raise last

    @staticmethod
    def _begin_dispatch_span(ticket: FleetTicket, replica: Replica,
                             reason: str) -> int:
        """Open a "dispatch" span: one per inner submission, tagged with
        the replica, its tier, and WHY this dispatch happened (primary /
        failover reason / hedge)."""
        if ticket.trace is None:
            return 0
        return ticket.trace.begin(
            "dispatch", parent=ticket._span_parent,
            replica=replica.name, tier=replica.tier, reason=reason)

    # -- waiter-driven progression -----------------------------------------

    def _advance(self, ticket: FleetTicket, slice_s: float) -> None:
        """One step of the waiter loop: resolve finished inner tickets,
        fail over, hedge, or park on the live ticket's event."""
        if ticket.done():
            return
        with ticket._lock:
            pairs = list(ticket._pairs)
            needs = ticket._needs_dispatch

        if not pairs:
            if needs is None:
                # Defensive: nothing live and nothing pending means the
                # ticket was resolved between our checks.
                return
            if not self._try_redispatch(ticket):
                time.sleep(min(_FAILOVER_RETRY_S, max(slice_s, 0.0)))
            return

        finished = [(t, r) for t, r in pairs if t.done()]
        if finished:
            self._settle(ticket, finished, pairs)
            return

        # Nothing finished: is a serving replica gone?  (Covers replicas
        # that hang without erroring — probe timeout marks them lost and
        # the parked waiter picks it up here within _CHECK_S.)
        for inner, replica in pairs:
            if replica.lost and not inner.done():
                inner.cancel()
                reason = replica.lost_reason or "replica_lost"
                self._drop_pair(ticket, inner, reason)
                return

        # Hedge: one live dispatch, tail threshold crossed, budget left.
        if (
            self.hedge_after_s is not None
            and not ticket.hedged
            and len(pairs) == 1
            and not ticket.cancelled
            and time.monotonic() - ticket.submitted >= self.hedge_after_s
            and not ticket.expired()
        ):
            self._hedge(ticket, pairs[0][1])
            return

        # Park.  With two live tickets poll (stdlib events cannot be
        # awaited as a set); with one, wait event-driven on it.
        wait_s = slice_s if len(pairs) == 1 else min(slice_s, _PAIR_POLL_S)
        pairs[0][0].wait(max(0.0, wait_s))

    def _settle(self, ticket: FleetTicket,
                finished: List[Tuple[Ticket, Replica]],
                pairs: List[Tuple[Ticket, Replica]]) -> None:
        """Classify finished inner tickets: a win resolves the fleet
        ticket; a replica-death failure drops the pair and triggers
        failover; any other failure is terminal."""
        for inner, replica in finished:
            if inner.outcome in ("ok", "degraded"):
                self._resolve_value(ticket, inner, replica)
                return
            if inner.outcome == "timeout":
                ticket._end_dispatch_span(inner, outcome="timeout",
                                          final=True)
                try:
                    inner.result()
                except BaseException as exc:  # noqa: BLE001
                    ticket._resolve("timeout", error=exc)
                return
            # outcome == "failed"
            try:
                inner.result()
                error: BaseException = RuntimeError("failed without error")
            except BaseException as exc:  # noqa: BLE001
                error = exc
            reason = self._failover_reason(error)
            if reason is None or ticket.cancelled:
                ticket._end_dispatch_span(inner, outcome="failed",
                                          final=True)
                ticket._resolve("failed", error=error)
                return
            if isinstance(error, BackendLostError):
                replica.mark_lost("backend_lost")
                self._refresh_gauges()
            self._drop_pair(ticket, inner, reason, error=error)
            return

    @staticmethod
    def _failover_reason(error: BaseException) -> Optional[str]:
        if isinstance(error, BackendLostError):
            return "backend_lost"
        if (
            isinstance(error, SchedulerRejected)
            and error.reason in _FAILOVER_REJECTIONS
        ):
            return "drain"
        return None

    def _drop_pair(self, ticket: FleetTicket, inner: Ticket, reason: str,
                   error: Optional[BaseException] = None) -> None:
        """Remove a dead dispatch; if it was the last one, enter the
        failover re-queue state (and count the failover)."""
        if error is not None:
            # The error outlives the dead replica here (as the ticket's
            # best terminal error); its traceback's frames would hold the
            # replica's backend, and with it the device memory a respawn
            # needs, until this request ends on another replica.
            error = error.with_traceback(None)
        ticket._end_dispatch_span(inner, outcome="dropped", dropped=reason)
        with ticket._lock:
            ticket._pairs = [p for p in ticket._pairs if p[0] is not inner]
            survivors = len(ticket._pairs)
            if survivors == 0:
                ticket._needs_dispatch = reason
        ticket.failovers += 1
        self._count_failover(reason)
        if survivors == 0:
            ticket._last_error = error  # best terminal error if no replica
            self._try_redispatch(ticket)

    def _try_redispatch(self, ticket: FleetTicket) -> bool:
        """One failover placement round.  Returns True when re-dispatched
        or terminally resolved; False to let the waiter retry (bounded by
        the original deadline — a failed-over request is re-queued, never
        re-rejected)."""
        if ticket.done():
            return True
        if ticket.expired() or ticket.cancelled:
            ticket._resolve("timeout", error=RequestTimeout(
                "deadline expired while failing over"))
            return True
        # Exactly-once delivery: if the request already completed on the
        # replica that just died (computed but not yet delivered), resolve
        # from the fleet idempotency cache instead of executing it again.
        if self.idempotency_cache is not None:
            record = self.idempotency_cache.get(idempotency_key(
                ticket.request,
                getattr(ticket.request, "method", "unknown"),
            ))
            if record is not None:
                self._m_idempotent.inc()
                value = record["value"]
                if isinstance(value, dict):
                    value = dict(value)
                    value["served_by"] = record.get("replica", "")
                    value["served_tier"] = record.get("tier", "")
                    value["idempotent_replay"] = True
                ticket._resolve(record["outcome"], value=value)
                return True
        tier = self._serving_tier()
        key = _scenario_key(ticket.request)
        with ticket._lock:
            redispatch_reason = ticket._needs_dispatch or "failover"
        # Prefer replicas this request has not yet died on; fall back to
        # any routable one (a retried replica may have recovered workers).
        candidates = (
            self._candidates(key, tier, exclude=ticket.tried)
            or self._candidates(key, tier)
        )
        if not candidates:
            if all(r.lost for r in self.replicas):
                ticket._resolve("failed", error=getattr(
                    ticket, "_last_error", None,
                ) or BackendLostError("every replica in the fleet is lost"))
                return True
            return False  # replicas exist but are busy/draining: retry
        for replica in candidates:
            span = self._begin_dispatch_span(ticket, replica,
                                             redispatch_reason)
            try:
                with use_trace(ticket.trace, span):
                    inner = replica.scheduler.submit(
                        ticket.request, timeout_s=ticket.remaining())
            except SchedulerRejected as exc:
                if ticket.trace is not None:
                    ticket.trace.end(span, outcome="rejected",
                                     rejected_reason=exc.reason)
                continue
            ticket._attach(inner, replica, span)
            self._count_routed(replica)
            return True
        return False

    def _hedge(self, ticket: FleetTicket, serving: Replica) -> None:
        ticket.hedged = True  # one hedge per ticket, even if placement fails
        candidates = [
            r for r in self._candidates(
                _scenario_key(ticket.request), self.tiers[self._lever.index]
            )
            if r.name != serving.name and r.health == HEALTHY
        ]
        for replica in candidates:
            span = self._begin_dispatch_span(ticket, replica, "hedge")
            try:
                with use_trace(ticket.trace, span):
                    inner = replica.scheduler.submit(
                        ticket.request, timeout_s=ticket.remaining())
            except SchedulerRejected as exc:
                if ticket.trace is not None:
                    ticket.trace.end(span, outcome="rejected",
                                     rejected_reason=exc.reason)
                continue
            ticket._attach(inner, replica, span)
            self._count_routed(replica)
            with self._counts_lock:
                self.hedges_total += 1
            self._m_hedges.inc()
            return

    def _resolve_value(self, ticket: FleetTicket, inner: Ticket,
                       replica: Replica) -> None:
        """Stamp the fleet contract onto the response: which replica/tier
        served it, and the degraded marker when the tier lever routed it
        below the default tier."""
        value = inner.result()
        outcome = inner.outcome or "ok"
        ticket._end_dispatch_span(inner, outcome=outcome, final=True)
        if isinstance(value, dict):
            value["served_by"] = replica.name
            value["served_tier"] = replica.tier
            if replica.tier != self.tiers[0]:
                value["degraded"] = True
                value.setdefault("degraded_reason", "tier_routed")
                outcome = "degraded"
        ticket._resolve(outcome, value=value)

    # -- counters / gauges -------------------------------------------------

    def _count_routed(self, replica: Replica,
                      affinity_hit: bool = False) -> None:
        self._m_routed.labels(replica.name, replica.tier).inc()
        if affinity_hit:
            self._m_affinity_hits.inc()
        else:
            self._m_affinity_misses.inc()
        with self._counts_lock:
            self.routed_counts[replica.name] = (
                self.routed_counts.get(replica.name, 0) + 1
            )
            if affinity_hit:
                self.affinity_hits += 1
            else:
                self.affinity_misses += 1

    def _count_failover(self, reason: str) -> None:
        self._m_failovers.labels(reason).inc()
        with self._counts_lock:
            self.failovers_total += 1
            self.failover_reasons[reason] = (
                self.failover_reasons.get(reason, 0) + 1
            )

    def _health_counts(self) -> Dict[str, int]:
        counts = {HEALTHY: 0, DEGRADED: 0, "draining": 0, "lost": 0}
        for replica in self.replicas:
            counts[replica.health] = counts.get(replica.health, 0) + 1
        return counts

    def _refresh_gauges(self) -> None:
        counts = self._health_counts()
        self._m_healthy.set(counts[HEALTHY])
        self._m_draining.set(counts["draining"])
        self._m_lost.set(counts["lost"])

    # -- probe loop --------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop_probe.wait(self.probe_interval_s):
            for replica in self.replicas:
                if self._stop_probe.is_set():
                    return
                # Passive signals are re-derived by reading health; the
                # active probe (off by default — it consumes fault-plan
                # call indices) additionally catches hangs.
                if (
                    self.probe_timeout_s is not None
                    and replica.health == HEALTHY
                ):
                    replica.probe(self.probe_timeout_s)
            self._refresh_gauges()

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Scheduler-shaped aggregate (the HTTP front end reads the same
        keys as for a single scheduler) plus the ``fleet`` block."""
        counts = self._health_counts()
        replicas: Dict[str, Any] = {}
        totals = {
            "queue_depth": 0, "inflight": 0,
            "max_queue_depth": 0, "max_inflight": 0, "workers_alive": 0,
        }
        device_batches: Dict[str, int] = {}
        for replica in self.replicas:
            snap = replica.snapshot()
            replicas[replica.name] = snap
            for key in totals:
                totals[key] += snap.get(key, 0)
            for kind, count in snap.get("device_batches", {}).items():
                device_batches[kind] = device_batches.get(kind, 0) + count
        with self._counts_lock:
            routed = dict(self.routed_counts)
            failovers_total = self.failovers_total
            failover_reasons = dict(self.failover_reasons)
            hedges_total = self.hedges_total
            affinity_hits = self.affinity_hits
            affinity_misses = self.affinity_misses
        size = len(self.replicas)
        stats: Dict[str, Any] = dict(totals)
        stats["draining"] = self._draining
        stats["device_batches"] = device_batches
        stats["fleet"] = {
            "size": size,
            "healthy": counts[HEALTHY],
            "degraded": counts[DEGRADED],
            "draining": counts["draining"],
            "lost": counts["lost"],
            "availability": counts[HEALTHY] / size if size else 0.0,
            "serving_tier": self.tiers[self._lever.index],
            "tiers": {
                tier: sum(1 for r in self.replicas if r.tier == tier)
                for tier in self.tiers
            },
            "failovers_total": failovers_total,
            "failovers": failover_reasons,
            "hedges_total": hedges_total,
            "affinity_hits": affinity_hits,
            "affinity_misses": affinity_misses,
            "affinity_hit_rate": (
                affinity_hits / (affinity_hits + affinity_misses)
                if (affinity_hits + affinity_misses) else 0.0
            ),
            "routed": routed,
            "replicas": replicas,
        }
        if self.idempotency_cache is not None:
            stats["fleet"]["idempotency"] = self.idempotency_cache.stats()
        if self.manager is not None:
            stats["fleet"]["manager"] = self.manager.snapshot()
        if self.autoscaler is not None:
            stats["fleet"]["autoscaler"] = self.autoscaler.snapshot()
        return stats

    def federated_metrics_snapshot(self) -> Dict[str, Any]:
        """Fleet-federated registry snapshot: replica-labelled sketch and
        counter series are merged into synthetic ``replica="fleet"``
        series alongside the per-replica ones.  Sketch merges are exact —
        the fleet p99 equals the sketch of the pooled observations
        (tests/test_torch_welfare_telemetry.py pins the equivalence)."""
        from consensus_tpu_torch.obs.sketch import federate_snapshot

        return federate_snapshot(self.registry.snapshot())
