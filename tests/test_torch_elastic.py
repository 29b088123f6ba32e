"""The port's elastic fleet (``serve/fleet.py`` ReplicaManager and
``serve/autoscale.py`` Autoscaler) against the JAX package's.

Tolerance: exact.  The autoscaler's defaults (scale up at 0.8, down at
0.35) equal the JAX ones, and one pressure trace made from a seed with
numpy, under one injected clock, gives the same target sequence (the up
and down dwells and the cooldown) in both packages.  Over each package's
fake backend, a killed replica respawns under its name with the same
lifecycle snapshot, and a rolling restart of a three-replica fleet cycles
every member with ``warm_seed_fraction`` 1.0.  Port only: a respawn waits
for its corpse's teardown and the dead stack's backend is garbage (the
device memory a respawn on the card needs)."""

import gc
import logging
import threading
import time
import types
import weakref

import numpy as np
import pytest

from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend
from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.serve import autoscale as jax_autoscale
from consensus_tpu.serve import fleet as jax_fleet
from consensus_tpu.serve import pagestore as jax_pagestore
from consensus_tpu.serve import router as jax_router
from consensus_tpu.serve import service as jax_service
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import autoscale, fleet, pagestore, router, service

PORT = types.SimpleNamespace(fleet=fleet, router=router, pagestore=pagestore, service=service,
                             autoscale=autoscale, Fake=FakeBackend, Registry=Registry)
JAX = types.SimpleNamespace(fleet=jax_fleet, router=jax_router, pagestore=jax_pagestore,
                            service=jax_service, autoscale=jax_autoscale, Fake=JaxFakeBackend,
                            Registry=JaxRegistry)

ISSUE = "Should we invest in public transport?"
OPINIONS = {"Agent 1": "Yes, buses are vital.", "Agent 2": "Only with congestion pricing."}


def _payload(seed, issue=ISSUE):
    return {"issue": issue, "agent_opinions": dict(OPINIONS), "method": "best_of_n",
            "params": {"n": 4, "max_tokens": 24}, "seed": seed, "request_id": f"req-{seed}"}


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


class _StubManager:
    def __init__(self, target=3):
        self.target = target
        self.router = types.SimpleNamespace(autoscaler=None, replicas=[], _pressure=lambda: 0.0)
        self.targets_seen = []

    def set_target(self, n):
        self.target = max(1, int(n))
        self.targets_seen.append(self.target)
        return self.target


def test_autoscaler_defaults_equal_jax():
    for pkg in (PORT, JAX):
        scaler = pkg.autoscale.Autoscaler(_StubManager(), pressure_fn=lambda: 0.0,
                                          registry=pkg.Registry(), auto_start=False)
        assert (scaler.scale_up_pressure, scaler.scale_down_pressure) == (0.8, 0.35)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_pressure_trace_same_scale_decisions(seed):
    rng = np.random.RandomState(seed)
    # Phases: overload, a dead-band hover, an idle tail.
    trace = np.concatenate([rng.uniform(0.82, 1.2, 40), rng.uniform(0.4, 0.75, 30),
                            rng.uniform(0.0, 0.3, 80)])
    trace[rng.randint(0, 40, 4)] = 0.5  # spikes that reset the up dwell
    outcomes = []
    for pkg in (PORT, JAX):
        manager, now, pressure = _StubManager(target=2), [0.0], [0.0]
        scaler = pkg.autoscale.Autoscaler(
            manager, pressure_fn=lambda: pressure[0], clock=lambda: now[0],
            registry=pkg.Registry(), auto_start=False, min_replicas=1, max_replicas=6,
            up_dwell_s=0.5, down_dwell_s=3.0, cooldown_s=2.0)
        for step, p in enumerate(trace):
            now[0] = step * 0.25
            pressure[0] = float(p)
            scaler.tick()
        outcomes.append((manager.targets_seen, scaler.scale_ups, scaler.scale_downs))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] > 0 and outcomes[0][2] > 0


def _elastic_fleet(pkg, n=3, registry=None, spill_dir=None, backends=None):
    registry = registry if registry is not None else pkg.Registry()
    options = {"max_inflight": 2, "max_queue_depth": 16, "default_timeout_s": 30.0,
               "retry_backoff_s": 0.001, "engine": True,
               "engine_options": {"prefix_cache": True}}

    def factory(name, tier=None):
        backend = pkg.Fake()
        if backends is not None:
            backends.append(weakref.ref(backend))
        return pkg.fleet.Replica(name, backend, tier=tier or "full", registry=registry,
                                 scheduler_options=dict(options))

    router_ = pkg.router.FleetRouter([factory(f"r{i}") for i in range(n)],
                                     registry=registry).start()
    manager = pkg.fleet.ReplicaManager(
        router_, factory,
        page_store=pkg.pagestore.PageStore(registry=registry, spill_dir=spill_dir),
        registry=registry, respawn_backoff_s=0.05, respawn_backoff_max_s=0.4,
        check_interval_s=0.05, harvest_interval_s=0.1, retire_timeout_s=1.0)
    return router_, manager


def _drive(pkg, router_, seeds, issues=6):
    tickets = [router_.submit(pkg.service.parse_request(_payload(s, f"{ISSUE} {s % issues}")))
               for s in seeds]
    for ticket in tickets:
        assert ticket.wait(30.0)
    return [t.result()["statement"] for t in tickets]


def test_kill_respawns_under_the_same_name_as_in_jax():
    snaps = []
    for pkg in (PORT, JAX):
        registry = pkg.Registry()
        router_, manager = _elastic_fleet(pkg, registry=registry)
        try:
            before = _drive(pkg, router_, range(12))
            router_.kill_replica("r0")
            assert _wait_for(lambda: manager.snapshot()["respawns"] >= 1
                             and router_.stats()["fleet"]["healthy"] == 3)
            after = _drive(pkg, router_, range(12))
            snap = manager.snapshot()
            snaps.append((before, after, sorted(r.name for r in router_.replicas),
                          snap["losses"], snap["respawns"], snap["quarantined"],
                          "fleet_respawns_total 1" in registry.to_prometheus()))
        finally:
            manager.close()
            router_.shutdown(drain=False, timeout=10.0)
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == snaps[0][1] and snaps[0][2] == ["r0", "r1", "r2"]


def test_respawn_frees_the_corpse_before_building_its_successor(monkeypatch):
    """r1 dies inside a request (a sticky device loss at its third call)
    while the slow r0 still serves the failed-over requests: when the
    manager builds r1's successor, the dead backend is already garbage.
    The wait for it runs where a CUDA pool exists; the test stands one in."""
    from consensus_tpu_torch.backends.faults import FaultInjectingBackend

    monkeypatch.setattr(fleet, "_device_pool_active", lambda: True)
    # pytest's log capture keeps every record, and a record of a failed
    # request keeps its traceback's frames, so the dead backend too.
    monkeypatch.setattr(logging.getLogger("consensus_tpu_torch.serve.scheduler"), "disabled", True)

    registry = Registry()
    options = {"max_inflight": 2, "max_queue_depth": 16, "default_timeout_s": 30.0,
               "engine": True}
    built, alive_at_build = [], []
    plans = {"r0": {"faults": [{"kind": "latency", "op": "*", "rate": 1.0, "latency_s": 0.2}]},
             "r1": {"faults": [{"kind": "device_lost", "op": "*", "call_index": 2}]}}

    def factory(name, tier=None):
        if len(built) >= 2:
            gc.collect()
            alive_at_build.append(built[1]() is not None)
        backend = FakeBackend()
        built.append(weakref.ref(backend))
        stack = backend
        if len(built) <= 2:
            stack = FaultInjectingBackend(backend, plans[name], registry=registry)
        return fleet.Replica(name, stack, registry=registry, scheduler_options=dict(options))

    router_ = router.FleetRouter([factory("r0"), factory("r1")], registry=registry).start()
    manager = fleet.ReplicaManager(router_, factory, registry=registry, respawn_backoff_s=0.05,
                                   check_interval_s=0.05, retire_timeout_s=1.0)
    try:
        issues = [f"{ISSUE} {i}" for i in range(12)]
        home = [max(["r0", "r1"], key=lambda n: router._rendezvous_weight(i, n)) for i in issues]
        assert "r1" in home
        tickets = [router_.submit(service.parse_request(_payload(i, issues[i])))
                   for i in range(12)]
        # One waiter per ticket, as the HTTP front end has: failover runs
        # on the waiter's thread.
        waiters = [threading.Thread(target=ticket.wait, args=(60.0,)) for ticket in tickets]
        for waiter in waiters:
            waiter.start()
        for waiter in waiters:
            waiter.join(60.0)
        assert all(ticket.outcome == "ok" for ticket in tickets)
        assert _wait_for(lambda: manager.snapshot()["respawns"] >= 1)
        assert router_.failovers_total >= 1
        assert alive_at_build == [False]
        assert "r1" not in manager._retiring
    finally:
        manager.close()
        router_.shutdown(drain=False, timeout=10.0)


def test_rolling_restart_warm_seeds_every_member(tmp_path):
    results = []
    for pkg, sub in ((PORT, "port"), (JAX, "jax")):
        spill = tmp_path / sub / "pages"
        router_, manager = _elastic_fleet(pkg, spill_dir=spill)
        try:
            _drive(pkg, router_, range(12))
            manager.tick()  # harvest the prefix caches into the store
            assert _wait_for(lambda: len(manager.page_store) > 0)
            outcome = manager.rolling_restart(drain_timeout_s=10.0, health_timeout_s=10.0)
            after = _drive(pkg, router_, range(12))
            events = outcome["events"]
            results.append((outcome["restarted"], outcome["aborted"],
                            all(e["warm_seeded"] > 0 for e in events), after,
                            bool(list(spill.glob("*.run")))))
        finally:
            manager.close()
            router_.shutdown(drain=False, timeout=10.0)
    assert results[0] == results[1]
    assert results[0][:3] == (["r0", "r1", "r2"], None, True) and results[0][4]


def test_autoscale_option_attaches_a_scaler_to_an_elastic_server():
    from consensus_tpu_torch.serve import create_server

    server = create_server(backend="fake", port=0, registry=Registry(), fleet_size=2,
                           fleet_options={"elastic": True, "autoscale": {"max_replicas": 3}})
    try:
        manager = server.scheduler.manager
        assert manager is not None and server.scheduler.autoscaler is not None
        assert server.scheduler.autoscaler.max_replicas == 3
    finally:
        server.scheduler.shutdown(drain=False, timeout=5.0)
        manager.close()
