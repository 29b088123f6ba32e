"""The port's circuit breaker at the serving front door (the reference's
``tests/test_serve_breaker.py`` on the port): an open breaker rejects with
503 and ``Retry-After``, ``/healthz`` shows the breaker, half-open admits
exactly one probe, drain resolves every ticket with the breaker open, and
a backend without a breaker keeps plain admission."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.base import BackendLostError
from consensus_tpu_torch.backends.supervisor import SupervisedBackend
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import SchedulerRejected, create_server
from consensus_tpu_torch.serve.scheduler import RequestScheduler

pytestmark = pytest.mark.chaos

BODY = {
    "issue": "Should the town build a new park?",
    "agent_opinions": {"a": "yes", "b": "no"},
    "method": "zero_shot",
    "params": {"max_tokens": 8},
    "seed": 1,
}


def post(base_url, payload=None):
    data = json.dumps(payload or BODY).encode("utf-8")
    request = urllib.request.Request(
        base_url + "/v1/consensus", data=data,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(request, timeout=30) as response:
            return response.status, dict(response.headers), \
                json.loads(response.read())
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), json.loads(exc.read())


def get_json(url):
    with urllib.request.urlopen(url, timeout=10) as response:
        return json.loads(response.read())


class TestBreakerOverHTTP:
    def test_breaker_open_rejects_503_with_retry_after(self):
        server = create_server(
            backend="fake", port=0, max_inflight=2,
            fault_plan={"faults": [
                {"kind": "device_lost", "op": "*", "call_index": 0}]},
            supervise={"failure_threshold": 1, "cooldown_s": 60.0},
        ).start()
        try:
            status, _, body = post(server.base_url)
            assert status == 500
            assert body["error"]["exception"] == "BackendLostError"
            status, headers, body = post(server.base_url)
            assert status == 503
            assert body["error"]["reason"] == "breaker_open"
            assert int(headers["Retry-After"]) >= 1
            health = get_json(server.base_url + "/healthz")
            breaker = health["circuit_breaker"]
            assert breaker["state"] == "open"
            assert breaker["cooldown_remaining_s"] > 0
        finally:
            server.stop()

    def test_healthy_server_has_closed_breaker_in_healthz(self):
        server = create_server(
            backend="fake", port=0, max_inflight=2, supervise=True,
        ).start()
        try:
            status, _, body = post(server.base_url)
            assert status == 200 and body["statement"]
            health = get_json(server.base_url + "/healthz")
            assert health["circuit_breaker"]["state"] == "closed"
        finally:
            server.stop()


class TestBreakerAdmission:
    def make_scheduler(self, handler, breaker_kwargs=None, **kwargs):
        registry = Registry()
        backend = SupervisedBackend(
            FakeBackend(), registry=registry, sleep=lambda _s: None,
            **(breaker_kwargs or {}),
        )
        kwargs.setdefault("max_inflight", 1)
        kwargs.setdefault("max_retries", 0)
        scheduler = RequestScheduler(
            handler=handler, backend=backend, registry=registry, **kwargs
        )
        return scheduler, backend.circuit_breaker

    def test_submit_rejects_when_breaker_open(self):
        scheduler, breaker = self.make_scheduler(
            handler=lambda request, backend: {"ok": True},
            breaker_kwargs={"failure_threshold": 1, "cooldown_s": 60.0},
        )
        scheduler.start()
        try:
            breaker.record_failure()
            with pytest.raises(SchedulerRejected) as excinfo:
                scheduler.submit(object())
            assert excinfo.value.reason == "breaker_open"
            assert excinfo.value.retry_after_s >= 1
            assert scheduler.stats()["circuit_breaker"]["state"] == "open"
        finally:
            scheduler.shutdown(drain=True, timeout=5)

    def test_half_open_admits_exactly_one_probe(self):
        now = [0.0]
        registry = Registry()
        backend = SupervisedBackend(
            FakeBackend(), registry=registry, failure_threshold=1,
            cooldown_s=10.0, clock=lambda: now[0], sleep=lambda _s: None,
        )
        done = threading.Event()

        def handler(request, _backend):
            done.wait(5)  # hold the probe in flight
            return {"ok": True}

        scheduler = RequestScheduler(
            handler=handler, backend=backend, registry=registry,
            max_inflight=2,
        ).start()
        try:
            breaker = scheduler.circuit_breaker
            breaker.record_failure()
            assert breaker.state == "open"
            now[0] += 10.0  # cooldown elapses -> half-open
            probe = scheduler.submit(BODY)
            with pytest.raises(SchedulerRejected) as excinfo:
                scheduler.submit(BODY)  # second request: probe slot taken
            assert excinfo.value.reason == "breaker_open"
            done.set()
            assert probe.wait(timeout=10)
            assert probe.result()["ok"]
            # The probe's backend-free handler never reported an outcome;
            # a real success (record_success) reopens admission fully.
            breaker.record_success()
            assert breaker.state == "closed"
            ticket = scheduler.submit(BODY)
            assert ticket.wait(timeout=10)
        finally:
            done.set()
            scheduler.shutdown(drain=True, timeout=5)

    def test_drain_with_breaker_open_resolves_every_ticket(self):
        release = threading.Event()

        def handler(request, _backend):
            release.wait(10)
            raise BackendLostError("device gone")

        scheduler, breaker = self.make_scheduler(
            handler=handler,
            breaker_kwargs={"failure_threshold": 1, "cooldown_s": 60.0},
        )
        scheduler.start()
        try:
            # Admit three tickets while the breaker is still closed; the
            # single worker serializes them behind the first.
            tickets = [scheduler.submit(object()) for _ in range(3)]
            breaker.record_failure()  # breaker opens while work is queued
            assert breaker.state == "open"
            release.set()
            scheduler.shutdown(drain=True, timeout=15)
            for ticket in tickets:
                assert ticket.done()  # drain resolved every ticket
                with pytest.raises(BackendLostError):
                    ticket.result()
        finally:
            release.set()
            scheduler.shutdown(drain=True, timeout=5)

    def test_no_breaker_backend_keeps_legacy_admission(self):
        scheduler = RequestScheduler(
            handler=lambda request, backend: {"ok": True},
            backend=FakeBackend(), registry=Registry(),
        )
        assert scheduler.circuit_breaker is None
        assert "circuit_breaker" not in scheduler.stats()
