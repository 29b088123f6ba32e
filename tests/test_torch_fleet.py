"""The port's fleet (``serve/fleet.py`` Replica / ReplicaKillSwitch and
``serve/router.py`` FleetRouter / FleetTicket) against the JAX package's.

Each scenario runs once per package over that package's fake backend (the
two are bit-equal) and compares the outcomes.  Tolerance: exact bytes.
The same requests give the same statements and the same rendezvous
placement; a replica killed mid-run fails its requests over to survivors
with the bytes of a serial run; a slow primary is hedged; the tier lever
routes to the small tier and stamps ``tier_routed``.  A fleet of two
tiny-llama3 ``TorchBackend`` replicas on the CPU (float32) answers exactly
as one replica does."""

import json
import threading
import time
import types
import urllib.request

import pytest

from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend
from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.serve import create_server as jax_create_server
from consensus_tpu.serve import fleet as jax_fleet
from consensus_tpu.serve import router as jax_router
from consensus_tpu.serve import service as jax_service
from consensus_tpu_torch.backends.base import BackendLostError
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import create_server
from consensus_tpu_torch.serve import fleet, router, service

ISSUE = "Should we invest in public transport?"
OPINIONS = {
    "Agent 1": "Yes, buses and trains are vital public goods.",
    "Agent 2": "Only alongside congestion pricing for cars.",
    "Agent 3": "Prefer cycling infrastructure over big rail projects.",
}

PORT = types.SimpleNamespace(fleet=fleet, router=router, service=service,
                             Fake=FakeBackend, Registry=Registry, create_server=create_server)
JAX = types.SimpleNamespace(fleet=jax_fleet, router=jax_router, service=jax_service,
                            Fake=JaxFakeBackend, Registry=JaxRegistry,
                            create_server=jax_create_server)
#: Response fields that are wall-clock readings.
TIMING = ("generation_time_s", "queue_wait_s", "latency_s")


def _payload(seed=7, issue=ISSUE, **overrides):
    payload = {"issue": issue, "agent_opinions": dict(OPINIONS), "method": "best_of_n",
               "params": {"n": 4, "max_tokens": 24}, "seed": seed, "evaluate": False,
               "request_id": f"req-{seed}"}
    payload.update(overrides)
    return payload


class SlowBackend:
    """A package's fake backend with a per-dispatch delay, so kills and
    hedges land while work is in flight."""

    name = "slow-fake"

    def __init__(self, fake_cls, delay_s=0.03):
        self.inner = fake_cls()
        self.delay_s = delay_s

    @property
    def deterministic_greedy(self):
        return self.inner.deterministic_greedy

    @property
    def token_counts(self):
        return self.inner.token_counts

    def _slow(self, fn, arg):
        time.sleep(self.delay_s)
        return fn(arg)

    def generate(self, requests):
        return self._slow(self.inner.generate, requests)

    def score(self, requests):
        return self._slow(self.inner.score, requests)

    def next_token_logprobs(self, requests):
        return self._slow(self.inner.next_token_logprobs, requests)

    def embed(self, texts):
        return self._slow(self.inner.embed, texts)


def _fleet(pkg, n=3, *, delay_s=0.03, tiers=None, backends=None, scheduler_options=None,
           registry=None, **router_kwargs):
    registry = registry if registry is not None else pkg.Registry()
    options = {"max_inflight": 2, "max_queue_depth": 8, "default_timeout_s": 30.0}
    options.update(scheduler_options or {})
    replicas = [
        pkg.fleet.Replica(
            f"r{i}", backends[i] if backends is not None else SlowBackend(pkg.Fake, delay_s),
            tier=tiers[i] if tiers is not None else "full", registry=registry,
            scheduler_options=dict(options),
        )
        for i in range(n)
    ]
    return pkg.router.FleetRouter(replicas, registry=registry, **router_kwargs).start()


def _serial(pkg, payload):
    return pkg.service.ConsensusService(pkg.Fake()).run(pkg.service.parse_request(payload))


def _strip(result):
    return {k: v for k, v in result.items() if k not in TIMING}


def _run_burst(pkg, payloads, kill_first=False, **fleet_kwargs):
    router_ = _fleet(pkg, **fleet_kwargs)
    try:
        requests = [pkg.service.parse_request(p) for p in payloads]
        doomed = router_.route_for(requests[0]).name
        tickets = [router_.submit(r) for r in requests]
        if kill_first:
            deadline = time.monotonic() + 10.0
            victim = next(r for r in router_.replicas if r.name == doomed)
            while victim.scheduler.stats()["inflight"] == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            router_.kill_replica(doomed)
        for ticket in tickets:
            assert ticket.wait(60.0)
        results = [_strip(t.result()) for t in tickets]
        return results, doomed, router_.failovers_total, router_.stats()["fleet"]
    finally:
        router_.shutdown(drain=False, timeout=10.0)


def test_kill_switch_passthrough_then_lost_on_every_op():
    for pkg, lost_error in ((PORT, BackendLostError), (JAX, None)):
        switch = pkg.fleet.ReplicaKillSwitch(pkg.Fake())
        assert switch.embed(["x"]).shape[0] == 1
        switch.kill("chaos")
        assert switch.lost
        with pytest.raises(Exception, match="replica backend is gone") as err:
            switch.embed(["x"])
        if lost_error is not None:
            assert isinstance(err.value, lost_error)


def test_same_requests_same_statements_and_placement():
    issues = [f"{ISSUE} (variant {i})" for i in range(40)]
    names = ["r0", "r1", "r2"]
    for issue in issues:
        assert (max(names, key=lambda n: router._rendezvous_weight(issue, n))
                == max(names, key=lambda n: jax_router._rendezvous_weight(issue, n)))
    payloads = [_payload(seed=100 + i, issue=issues[i % 6]) for i in range(12)]
    port = _run_burst(PORT, payloads, delay_s=0.0)
    ref = _run_burst(JAX, payloads, delay_s=0.0)
    assert port[0] == ref[0]
    assert {r["served_by"] for r in port[0]} == {r["served_by"] for r in ref[0]}
    for payload, result in zip(payloads, port[0]):
        assert result["statement"] == _serial(PORT, payload)["statement"]
    assert port[3]["affinity_hit_rate"] == ref[3]["affinity_hit_rate"] == 1.0


def test_mid_run_kill_fails_over_with_identical_bytes():
    payloads = [_payload(seed=200 + i) for i in range(16)]
    port = _run_burst(PORT, payloads, kill_first=True)
    ref = _run_burst(JAX, payloads, kill_first=True)
    for pkg, (results, doomed, failovers, stats) in ((PORT, port), (JAX, ref)):
        assert failovers > 0 and stats["lost"] == 1
        for payload, result in zip(payloads, results):
            assert result["statement"] == _serial(pkg, payload)["statement"]
            assert result["served_by"] != doomed
    assert [r["statement"] for r in port[0]] == [r["statement"] for r in ref[0]]


def test_slow_primary_is_hedged_with_identical_bytes():
    outcomes = []
    for pkg in (PORT, JAX):
        payload = _payload(seed=9)
        request = pkg.service.parse_request(payload)
        winner = max(["r0", "r1"], key=lambda n: pkg.router._rendezvous_weight(request.issue, n))
        backends = [SlowBackend(pkg.Fake, 2.0 if f"r{i}" == winner else 0.0) for i in range(2)]
        registry = pkg.Registry()
        router_ = _fleet(pkg, 2, backends=backends, registry=registry, hedge_after_s=0.05)
        try:
            ticket = router_.submit(request)
            assert ticket.wait(20.0)
            result = ticket.result()
            assert result["served_by"] != winner and ticket.hedged
            assert "fleet_hedges_total 1" in registry.to_prometheus()
            outcomes.append(_strip(result))
        finally:
            router_.shutdown(drain=False, timeout=10.0)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0]["statement"] == _serial(PORT, _payload(seed=9))["statement"]


def test_tier_lever_routes_to_the_small_tier():
    outcomes = []
    for pkg in (PORT, JAX):
        router_ = _fleet(pkg, 2, delay_s=0.0, tiers=["full", "small"],
                         tier_enter_pressure=0.0, tier_min_dwell_s=0.0)
        try:
            ticket = router_.submit(pkg.service.parse_request(_payload(seed=5)))
            assert ticket.wait(30.0)
            outcomes.append((_strip(ticket.result()), router_.stats()["fleet"]["serving_tier"]))
        finally:
            router_.shutdown(drain=False, timeout=5.0)
    assert outcomes[0] == outcomes[1]
    result, tier = outcomes[0]
    assert (result["served_tier"], result["served_by"], tier) == ("small", "r1", "small")
    assert result["degraded"] is True and result["degraded_reason"] == "tier_routed"


def _post(base_url, payload):
    request = urllib.request.Request(
        base_url + "/v1/consensus", data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(request, timeout=60) as response:
        return json.loads(response.read().decode())


def test_http_fleet_healthz_and_bodies_equal_jax():
    bodies, healths = [], []
    for pkg in (PORT, JAX):
        server = pkg.create_server(backend="fake", port=0, registry=pkg.Registry(),
                                   fleet_size=3, max_inflight=2).start()
        try:
            out = [_strip(_post(server.base_url, _payload(seed=300 + i, issue=f"{ISSUE} {i % 3}")))
                   for i in range(6)]
            with urllib.request.urlopen(server.base_url + "/healthz", timeout=10) as response:
                health = json.loads(response.read().decode())
        finally:
            server.stop(drain=False, timeout=10.0)
        bodies.append(out)
        healths.append((health["status"], health["fleet"]["size"], health["fleet"]["healthy"],
                        sorted(health["fleet"]["replicas"])))
    assert bodies[0] == bodies[1]
    assert healths[0] == healths[1] == ("ok", 3, 3, ["r0", "r1", "r2"])


TINY = {"model": "tiny-llama3", "dtype": "float32", "max_context": 256, "base_seed": 3,
        "device": "cpu"}


def test_two_tiny_llama3_replicas_answer_as_one_replica():
    """``replica_factory`` builds one ``TorchBackend`` per replica (each from
    the same seed: the same weights); every request, wherever it is placed,
    answers byte for byte as the one-replica server does."""
    payloads = [
        _payload(seed=400 + i, issue=f"{ISSUE} {i}", params={"n": 2, "max_tokens": 6})
        for i in range(3)
    ] + [_payload(seed=410, method="zero_shot", params={"max_tokens": 6})]
    answers = []
    for fleet_size in (2, 1):
        server = create_server(backend="torch", backend_options=dict(TINY), port=0,
                               registry=Registry(), fleet_size=fleet_size, max_inflight=2,
                               engine_options={"slots": 4, "num_pages": 256})
        server.start()
        try:
            threads, out = [], [None] * len(payloads)

            def ask(i):
                out[i] = _strip(_post(server.base_url, payloads[i]))

            for i in range(len(payloads)):
                threads.append(threading.Thread(target=ask, args=(i,)))
                threads[-1].start()
            for thread in threads:
                thread.join(120)
            if fleet_size == 2:
                backends = [r.kill_switch.inner for r in server.scheduler.replicas]
                assert len({id(b) for b in backends}) == 2
                assert all(str(b.device) == "cpu" for b in backends)
        finally:
            server.stop(drain=False, timeout=10.0)
        answers.append(out)
    fleet_out, single_out = answers
    for got, want in zip(fleet_out, single_out):
        assert got["statement"] == want["statement"]
        assert got["served_by"] in ("r0", "r1")
    assert {r["served_by"] for r in fleet_out} == {"r0", "r1"}
