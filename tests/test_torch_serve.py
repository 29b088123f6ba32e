"""The port's online serving (``serve/``: ``parse_request``,
``ConsensusService``, ``RequestScheduler``, ``ConsensusServer``,
``create_server`` and ``python -m consensus_tpu_torch.serve``) against the
JAX package's.

The reference's own cases (``tests/test_serve.py``; the load generator's
acceptance run is in ``tests/test_torch_loadgen.py``) run on the port over
its fake backend: validation, admission, deadlines, retries,
drain, coalescing, 504/413 surfaces, and a served statement equal to the
port's ``Experiment`` statement.  The parity cases send one payload to
the port's server and to the JAX package's (each over its own fake
backend: bit-equal) and require equal JSON, timing fields excepted; run
the CLI as a subprocess (startup JSON, a request, ``/healthz``, SIGTERM
drain, exit 0); and check that the fleet, WAL, telemetry, SLO and
speculative options build and serve while ``mesh`` raises
``NotImplementedError`` naming its queue item."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import (
    ConsensusRequest,
    ConsensusServer,
    ConsensusService,
    RequestScheduler,
    RequestTimeout,
    RequestValidationError,
    SchedulerRejected,
    create_server,
    parse_request,
)

TOPIC = "Should we invest in public transport?"
OPINIONS = {
    "Agent 1": "Yes, buses and trains are vital public goods.",
    "Agent 2": "Only alongside congestion pricing for cars.",
    "Agent 3": "Prefer cycling infrastructure over big rail projects.",
}
PARAMS = {"n": 4, "max_tokens": 24}


def _request(seed=7, **overrides):
    payload = {
        "issue": TOPIC,
        "agent_opinions": OPINIONS,
        "method": "best_of_n",
        "params": dict(PARAMS),
        "seed": seed,
        "evaluate": False,
    }
    payload.update(overrides)
    return parse_request(payload)


def _post(base_url, payload, timeout=30.0):
    """POST /v1/consensus; returns (status, decoded body)."""
    request = urllib.request.Request(
        base_url + "/v1/consensus",
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, json.loads(response.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as response:
        return json.loads(response.read().decode())


class SlowCountingBackend:
    """FakeBackend with a dispatch delay (forces request overlap so
    coalescing is deterministic in tests) and device-batch counters."""

    name = "slow-counting"

    def __init__(self, delay_s=0.02):
        self.inner = FakeBackend()
        self.delay_s = delay_s
        self.batches = {"generate": 0, "score": 0, "next_token": 0, "embed": 0}

    def _dispatch(self, kind, fn, requests):
        self.batches[kind] += 1
        time.sleep(self.delay_s)
        return fn(requests)

    def generate(self, requests):
        return self._dispatch("generate", self.inner.generate, requests)

    def score(self, requests):
        return self._dispatch("score", self.inner.score, requests)

    def next_token_logprobs(self, requests):
        return self._dispatch(
            "next_token", self.inner.next_token_logprobs, requests)

    def embed(self, texts):
        return self._dispatch("embed", self.inner.embed, texts)


# ---------------------------------------------------------------------------
# request validation
# ---------------------------------------------------------------------------


class TestParseRequest:
    def test_valid_round_trip(self):
        request = _request(seed=3, timeout_s=5, request_id="r-1")
        assert isinstance(request, ConsensusRequest)
        assert request.method == "best_of_n"
        assert request.seed == 3
        assert request.timeout_s == 5.0
        assert request.request_id == "r-1"

    def test_collects_every_error(self):
        with pytest.raises(RequestValidationError) as excinfo:
            parse_request({"issue": "", "agent_opinions": {},
                           "method": "nope", "seed": "x", "bogus": 1})
        errors = "\n".join(excinfo.value.errors)
        assert "'issue'" in errors
        assert "'agent_opinions'" in errors
        assert "'method'" in errors
        assert "'seed'" in errors
        assert "bogus" in errors

    def test_sweep_grid_params_rejected(self):
        """List-valued params are an offline sweep axis (the
        Experiment.expand_param_grid surface), not a single request."""
        with pytest.raises(RequestValidationError) as excinfo:
            _request(params={"n": [2, 4], "max_tokens": 24})
        assert "sweep" in str(excinfo.value)

    def test_non_object_body_rejected(self):
        with pytest.raises(RequestValidationError):
            parse_request([1, 2, 3])


# ---------------------------------------------------------------------------
# scheduler units
# ---------------------------------------------------------------------------


def _scheduler(handler, registry=None, **kwargs):
    kwargs.setdefault("max_queue_depth", 4)
    kwargs.setdefault("max_inflight", 1)
    kwargs.setdefault("default_timeout_s", 30.0)
    kwargs.setdefault("retry_backoff_s", 0.001)
    return RequestScheduler(
        handler, FakeBackend(),
        registry=registry if registry is not None else Registry(),
        **kwargs,
    )


def _counter_total(registry, name):
    family = registry.snapshot()["families"].get(name)
    if not family:
        return 0
    return sum(s["value"] for s in family["series"])


class TestSchedulerAdmission:
    def test_rejects_at_capacity_with_explicit_reason(self):
        release = threading.Event()
        entered = threading.Event()

        def handler(request, backend):
            entered.set()
            release.wait(10.0)
            return {"ok": True}

        registry = Registry()
        scheduler = _scheduler(
            handler, registry, max_inflight=1, max_queue_depth=2).start()
        try:
            running = scheduler.submit(_request(0))
            assert entered.wait(5.0)
            queued = [scheduler.submit(_request(i)) for i in (1, 2)]
            with pytest.raises(SchedulerRejected) as excinfo:
                scheduler.submit(_request(3))
            assert excinfo.value.reason == "queue_full"
            assert _counter_total(registry, "serve_rejected_total") == 1
            assert _counter_total(registry, "serve_accepted_total") == 3
            release.set()
            for ticket in [running] + queued:
                assert ticket.wait(10.0)
                assert ticket.result() == {"ok": True}
        finally:
            release.set()
            scheduler.shutdown()

    def test_draining_rejects_new_submissions(self):
        scheduler = _scheduler(lambda r, b: {"ok": True}).start()
        scheduler.shutdown(drain=True)
        with pytest.raises(SchedulerRejected) as excinfo:
            scheduler.submit(_request(0))
        assert excinfo.value.reason == "draining"


class TestSchedulerDeadlines:
    def test_queued_request_expires_at_deadline(self):
        release = threading.Event()
        entered = threading.Event()

        def handler(request, backend):
            entered.set()
            release.wait(10.0)
            return {"ok": True}

        registry = Registry()
        scheduler = _scheduler(handler, registry, max_inflight=1).start()
        try:
            blocker = scheduler.submit(_request(0))
            assert entered.wait(5.0)
            doomed = scheduler.submit(_request(1), timeout_s=0.05)
            time.sleep(0.1)  # let the deadline lapse while queued
            release.set()
            assert doomed.wait(10.0)
            assert doomed.outcome == "timeout"
            with pytest.raises(RequestTimeout):
                doomed.result()
            assert blocker.wait(10.0) and blocker.outcome == "ok"
            assert _counter_total(registry, "serve_timeout_total") == 1
        finally:
            release.set()
            scheduler.shutdown()

    def test_cancelled_ticket_reports_timeout(self):
        release = threading.Event()
        entered = threading.Event()

        def handler(request, backend):
            entered.set()
            release.wait(10.0)
            return {"ok": True}

        scheduler = _scheduler(handler, max_inflight=1).start()
        try:
            blocker = scheduler.submit(_request(0))
            assert entered.wait(5.0)
            abandoned = scheduler.submit(_request(1))
            abandoned.cancel()  # waiter gave up before it was popped
            release.set()
            assert abandoned.wait(10.0)
            assert abandoned.outcome == "timeout"
            assert blocker.wait(10.0)
        finally:
            release.set()
            scheduler.shutdown()


class TestSchedulerRetries:
    def test_transient_failure_retries_then_succeeds(self):
        attempts = []

        def handler(request, backend):
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("transient backend wobble")
            return {"ok": True}

        registry = Registry()
        scheduler = _scheduler(handler, registry, max_retries=2).start()
        try:
            ticket = scheduler.submit(_request(0))
            assert ticket.wait(10.0)
            assert ticket.outcome == "ok"
            assert ticket.result() == {"ok": True}
            assert ticket.attempts == 3
            assert _counter_total(registry, "serve_retried_total") == 2
            assert _counter_total(registry, "serve_failed_total") == 0
        finally:
            scheduler.shutdown()

    def test_retries_are_bounded(self):
        def handler(request, backend):
            raise RuntimeError("permanently transient-looking")

        registry = Registry()
        scheduler = _scheduler(handler, registry, max_retries=2).start()
        try:
            ticket = scheduler.submit(_request(0))
            assert ticket.wait(10.0)
            assert ticket.outcome == "failed"
            assert ticket.attempts == 3  # 1 try + 2 retries
            with pytest.raises(RuntimeError):
                ticket.result()
            assert _counter_total(registry, "serve_failed_total") == 1
        finally:
            scheduler.shutdown()

    def test_validation_style_errors_never_retry(self):
        attempts = []

        def handler(request, backend):
            attempts.append(1)
            raise ValueError("bad method config")

        scheduler = _scheduler(handler, max_retries=5).start()
        try:
            ticket = scheduler.submit(_request(0))
            assert ticket.wait(10.0)
            assert ticket.outcome == "failed"
            assert len(attempts) == 1
        finally:
            scheduler.shutdown()


class TestSchedulerDrain:
    def test_drain_completes_everything_and_leaves_no_orphans(self):
        def handler(request, backend):
            time.sleep(0.01)
            return {"seed": request.seed}

        scheduler = _scheduler(
            handler, max_inflight=2, max_queue_depth=16).start()
        tickets = [scheduler.submit(_request(i)) for i in range(10)]
        scheduler.shutdown(drain=True, timeout=30.0)
        # Every ticket resolved with its own result — nothing orphaned.
        for i, ticket in enumerate(tickets):
            assert ticket.done()
            assert ticket.result() == {"seed": i}
        stats = scheduler.stats()
        assert stats["queue_depth"] == 0
        assert stats["inflight"] == 0
        assert stats["workers_alive"] == 0

    def test_non_drain_shutdown_fails_queued_tickets(self):
        release = threading.Event()
        entered = threading.Event()

        def handler(request, backend):
            entered.set()
            release.wait(10.0)
            return {"ok": True}

        scheduler = _scheduler(
            handler, max_inflight=1, max_queue_depth=8).start()
        running = scheduler.submit(_request(0))
        assert entered.wait(5.0)
        queued = [scheduler.submit(_request(i)) for i in (1, 2)]

        def finish_soon():
            time.sleep(0.05)
            release.set()

        threading.Thread(target=finish_soon, daemon=True).start()
        scheduler.shutdown(drain=False, timeout=30.0)
        # In-flight work completed; queued work failed fast and explicitly.
        assert running.result() == {"ok": True}
        for ticket in queued:
            assert ticket.done()
            with pytest.raises(SchedulerRejected):
                ticket.result()


class TestSchedulerCoalescing:
    def test_concurrent_requests_share_device_batches(self):
        """The scheduler's worker pool drives one shared BatchingBackend:
        in-flight requests' generate/score calls merge into wider device
        batches, so N requests cost far fewer than N× the solo dispatch
        count — the whole point of putting a scheduler in front of the
        batched engine."""
        inner = SlowCountingBackend(delay_s=0.02)
        service = ConsensusService(inner)
        registry = Registry()
        scheduler = RequestScheduler(
            service.run, inner,
            max_inflight=4, max_queue_depth=16,
            registry=registry, flush_ms=50.0,
        ).start()
        try:
            tickets = [scheduler.submit(_request(seed=100 + i))
                       for i in range(8)]
            for ticket in tickets:
                assert ticket.wait(60.0)
                assert ticket.outcome == "ok"
        finally:
            scheduler.shutdown()
        # Serial execution = 8 generate + 8 score dispatches; merged must
        # be strictly fewer on both kinds.
        assert inner.batches["generate"] < 8
        assert inner.batches["score"] < 8
        # Per-kind completion wakeups stay surgical under mixed-kind load
        # (ADVICE r5 item 4): nobody is woken while its request is pending.
        assert _counter_total(
            registry, "batching_spurious_wakeups_total") == 0


# ---------------------------------------------------------------------------
# service determinism vs the offline Experiment harness
# ---------------------------------------------------------------------------


def _experiment_statements(tmp_path, seeds, scenario_issue, opinions):
    """Serial (non-concurrent) Experiment runs: seed -> statement."""
    from consensus_tpu_torch.experiment import Experiment

    config = {
        "experiment_name": "serve_parity",
        "output_dir": str(tmp_path / "exp"),
        "scenario": {"issue": scenario_issue, "agent_opinions": opinions},
        "methods_to_run": ["best_of_n"],
        "best_of_n": dict(PARAMS),
        "seed": seeds[0],
        "num_seeds": len(seeds),
        "concurrent_execution": False,
    }
    frame = Experiment(config, backend=FakeBackend()).run()
    assert list(frame["seed"]) == list(seeds)
    assert (frame["error_message"] == "").all()
    return dict(zip(frame["seed"], frame["statement"]))


class TestServiceDeterminism:
    def test_service_matches_experiment(self, tmp_path):
        expected = _experiment_statements(tmp_path, [7], TOPIC, OPINIONS)
        service = ConsensusService(FakeBackend())
        response = service.run(_request(seed=7))
        assert response["statement"] == expected[7]


# ---------------------------------------------------------------------------
# HTTP end-to-end (real socket)
# ---------------------------------------------------------------------------


@pytest.fixture()
def server():
    instance = create_server(
        backend=FakeBackend(), port=0, max_inflight=2, max_queue_depth=8,
        registry=Registry(),
    ).start()
    yield instance
    instance.stop()


class TestHTTPEndToEnd:
    def test_consensus_round_trip_matches_experiment(self, server, tmp_path):
        expected = _experiment_statements(tmp_path, [11], TOPIC, OPINIONS)
        status, body = _post(server.base_url, {
            "issue": TOPIC, "agent_opinions": OPINIONS,
            "method": "best_of_n", "params": PARAMS, "seed": 11,
            "evaluate": True, "request_id": "e2e-1",
        })
        assert status == 200
        assert body["statement"] == expected[11]
        assert body["request_id"] == "e2e-1"
        assert body["method"] == "best_of_n"
        assert set(body["utilities"]) == set(OPINIONS)
        for scores in body["utilities"].values():
            assert {"cosine_similarity", "avg_logprob", "perplexity"} <= set(
                scores)
        assert "egalitarian_welfare_cosine" in body["welfare"]
        assert body["generation_time_s"] >= 0

    def test_healthz_schema(self, server):
        with urllib.request.urlopen(server.base_url + "/healthz") as response:
            assert response.status == 200
            health = json.loads(response.read().decode())
        assert health["status"] == "ok"
        assert health["queue_depth"] == 0
        assert health["inflight"] == 0
        assert health["max_inflight"] == 2
        assert health["max_queue_depth"] == 8
        assert health["workers_alive"] == 2
        assert health["backend"]["alive"] is True
        assert set(health["device_batches"]) == {
            "generate", "score", "next_token", "embed", "score_matrix"}

    def test_metrics_exposes_serve_families(self, server):
        _post(server.base_url, {
            "issue": TOPIC, "agent_opinions": OPINIONS,
            "method": "best_of_n", "params": PARAMS, "seed": 1,
            "evaluate": False,
        })
        with urllib.request.urlopen(server.base_url + "/metrics") as response:
            assert response.status == 200
            assert response.headers["Content-Type"].startswith("text/plain")
            text = response.read().decode()
        for family in (
            "serve_queue_depth",
            "serve_inflight",
            "serve_request_latency_seconds",
            "serve_accepted_total",
        ):
            assert family in text, family
        assert 'outcome="ok"' in text

    def test_validation_error_is_structured_json(self, server):
        status, body = _post(server.base_url, {
            "issue": "", "agent_opinions": {}, "method": "nope"})
        assert status == 400
        assert body["error"]["type"] == "validation"
        assert any("'method'" in d for d in body["error"]["details"])

    def test_bad_json_and_unknown_route(self, server):
        request = urllib.request.Request(
            server.base_url + "/v1/consensus", data=b"not json{",
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            urllib.request.urlopen(request, timeout=10.0)
        assert excinfo.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            urllib.request.urlopen(server.base_url + "/nope", timeout=10.0)
        assert excinfo.value.code == 404

    def test_timeout_returns_504(self):
        instance = create_server(
            backend=SlowCountingBackend(delay_s=0.5), port=0,
            max_inflight=1, registry=Registry(),
        ).start()
        try:
            status, body = _post(instance.base_url, {
                "issue": TOPIC, "agent_opinions": OPINIONS,
                "method": "best_of_n", "params": PARAMS, "seed": 1,
                "evaluate": False, "timeout_s": 0.05,
            })
            assert status == 504
            assert body["error"]["type"] == "timeout"
        finally:
            instance.stop()


# ---------------------------------------------------------------------------
# acceptance proof: 16 concurrent clients vs serial Experiment
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# graceful degradation surface
# ---------------------------------------------------------------------------


class TestDegradationSurface:
    def test_504_carries_retry_after(self):
        """A deadline expiry with no completed wave stays a 504 — now with
        a Retry-After hint (the anytime clock is born expired: the 0.05 s
        budget is smaller than the anytime margin, so BudgetExpired fires
        before any device work)."""
        instance = create_server(
            backend=SlowCountingBackend(delay_s=0.5), port=0,
            max_inflight=1, registry=Registry(),
        ).start()
        try:
            request = urllib.request.Request(
                instance.base_url + "/v1/consensus",
                data=json.dumps({
                    "issue": TOPIC, "agent_opinions": OPINIONS,
                    "method": "best_of_n", "params": PARAMS, "seed": 1,
                    "evaluate": False, "timeout_s": 0.05,
                }).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as excinfo:
                urllib.request.urlopen(request, timeout=30.0)
            assert excinfo.value.code == 504
            assert excinfo.value.headers["Retry-After"] is not None
            body = json.loads(excinfo.value.read().decode())
            assert body["error"]["type"] == "timeout"
        finally:
            instance.stop()

    def test_cancelled_ticket_mid_wave_sibling_unaffected(self):
        """Cancel a ticket while its search is mid-flight in the shared
        BatchingBackend: the cancelled request resolves to its anytime
        partial (outcome "degraded"), and a co-batched sibling's statement
        stays byte-identical to a solo run — a cancelled ticket in a merged
        batch must never corrupt its siblings."""
        from consensus_tpu_torch.methods import get_method_generator

        slow = SlowCountingBackend(delay_s=0.05)
        service = ConsensusService(slow)
        scheduler = RequestScheduler(
            service.run, slow, max_queue_depth=8, max_inflight=2,
            default_timeout_s=60.0, registry=Registry(), flush_ms=20.0,
        )
        scheduler.start()
        try:
            long_ticket = scheduler.submit(_request(
                seed=5, method="beam_search",
                params={"beam_width": 2, "max_tokens": 30}))
            sibling_params = {"n": 4, "max_tokens": 24}
            sibling_ticket = scheduler.submit(_request(
                seed=77, params=dict(sibling_params)))
            time.sleep(0.4)  # both in flight, sharing merged batches
            long_ticket.cancel()
            assert sibling_ticket.wait(timeout=30.0)
            assert long_ticket.wait(timeout=30.0)
        finally:
            scheduler.shutdown(drain=True, timeout=30.0)

        # The sibling is untouched by its co-batched neighbour's death.
        assert sibling_ticket.outcome == "ok"
        expected = get_method_generator(
            "best_of_n", FakeBackend(), {**sibling_params, "seed": 77}
        ).generate_statement(TOPIC, OPINIONS)
        assert sibling_ticket.result()["statement"] == expected

        # The cancelled search surfaced its best-so-far wave.
        assert long_ticket.outcome == "degraded"
        value = long_ticket.result()
        assert value["degraded"] is True
        assert value["degraded_reason"] == "cancelled"
        assert value["statement"]

    def test_untagged_late_success_still_discarded(self):
        """A FULL (non-degraded) result that completes after cancellation
        is still reported as a timeout — only degraded-tagged values earn
        late delivery."""
        release = threading.Event()

        def slow_handler(request, backend):
            release.wait(timeout=10.0)
            return {"statement": "too late", "seed": request.seed}

        scheduler = RequestScheduler(
            slow_handler, FakeBackend(), max_queue_depth=4, max_inflight=1,
            default_timeout_s=30.0, registry=Registry(),
        )
        scheduler.start()
        try:
            ticket = scheduler.submit(_request(seed=1))
            time.sleep(0.05)  # let the worker enter the handler
            ticket.cancel()
            release.set()
            assert ticket.wait(timeout=10.0)
            assert ticket.outcome == "timeout"
            with pytest.raises(RequestTimeout):
                ticket.result()
        finally:
            scheduler.shutdown(drain=True, timeout=10.0)


class TestKvOomRejection:
    def test_oversized_request_maps_to_http_413(self):
        """SchedulerRejected(kv_oom) from the engine's page-pool admission
        surfaces as 413 (the REQUEST is too large — retrying unchanged can
        never succeed), distinct from the 429 queue_full overload path,
        and is counted under serve_rejected_total{reason="kv_oom"}."""
        registry = Registry()
        server = create_server(
            backend=FakeBackend(), port=0, registry=registry,
            engine=True,
            engine_options={"slots": 2, "page_size": 4, "num_pages": 2},
        ).start()
        try:
            status, body = _post(server.base_url, {
                "issue": TOPIC,
                "agent_opinions": OPINIONS,
                "method": "best_of_n",
                "params": {"n": 2, "max_tokens": 256},
                "seed": 3,
            })
        finally:
            server.stop()
        assert status == 413
        assert body["error"]["type"] == "rejected"
        assert body["error"]["reason"] == "kv_oom"
        assert 'serve_rejected_total{reason="kv_oom"} 1' in \
            registry.to_prometheus()


# ---------------------------------------------------------------------------
# Parity with the JAX package's server
# ---------------------------------------------------------------------------

import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend  # noqa: E402
from consensus_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402
from consensus_tpu.serve import create_server as jax_create_server  # noqa: E402

#: Response keys that carry wall-clock time.
_TIMING_KEYS = ("generation_time_s",)

PARITY_PAYLOADS = {
    "best_of_n": {"method": "best_of_n", "params": {"n": 4, "max_tokens": 24}, "seed": 7},
    "beam_search": {"method": "beam_search", "params": {"beam_width": 2, "max_tokens": 6}, "seed": 5},
    "zero_shot": {"method": "zero_shot", "params": {"max_tokens": 30}, "seed": 42},
    "habermas": {"method": "habermas_machine",
                 "params": {"num_candidates": 2, "num_rounds": 1, "max_tokens": 48}, "seed": 3},
    "bad_method": {"method": "nope", "seed": 1},
}


def _served(create, backend, registry, payload, **options):
    server = create(backend=backend, port=0, registry=registry, **options).start()
    try:
        status, body = _post(server.base_url, payload)
    finally:
        server.stop()
    if isinstance(body, dict):
        for key in _TIMING_KEYS:
            body.pop(key, None)
    return status, body


@pytest.mark.parametrize("name", sorted(PARITY_PAYLOADS))
@pytest.mark.parametrize("engine", [True, False])
def test_http_response_equals_jax_server(name, engine):
    payload = {"issue": TOPIC, "agent_opinions": OPINIONS, "request_id": f"parity-{name}",
               **PARITY_PAYLOADS[name]}
    port = _served(create_server, FakeBackend(), Registry(), payload, engine=engine)
    ref = _served(jax_create_server, JaxFakeBackend(), JaxRegistry(), payload, engine=engine)
    assert port == ref
    assert port[0] == (400 if name == "bad_method" else 200)


def test_faulted_supervised_server_equals_jax_server():
    """The same fault plan under ``supervise``: a transient generate fault
    is retried away and the NaN score row fails the request the same way."""
    plan = {"seed": 1, "faults": [
        {"kind": "transient_error", "op": "generate", "call_index": 0},
        {"kind": "nan_logprobs", "op": "score", "call_index": 0, "row_index": 0},
    ]}
    payload = {"issue": TOPIC, "agent_opinions": OPINIONS, "request_id": "faulted",
               **PARITY_PAYLOADS["best_of_n"]}
    opts = dict(fault_plan=plan, supervise={"backoff_s": 0.0}, max_retries=0)
    port = _served(create_server, FakeBackend(), Registry(), payload, **opts)
    ref = _served(jax_create_server, JaxFakeBackend(), JaxRegistry(), payload, **opts)
    assert port == ref


@pytest.mark.parametrize("option, item", [
    ({"fleet_size": 2}, "A8"),
    ({"fleet_options": {"tiers": ["full"]}}, "A8"),
    ({"telemetry": True}, "A8"),
    ({"slo": True}, "A8"),
    ({"state_dir": "state"}, "A8"),
    ({"mesh": "dp=2,tp=1"}, "A9"),
    ({"engine_options": {"speculative": True}}, "A8"),
])
def test_deferred_options_raise_naming_their_item(option, item, tmp_path):
    """The queue-A8 options build their serving planes now and the server
    answers through them.  ``mesh`` (A9) is ported: a dp=2 mesh serves with
    the engine's slots and pools over two shards, as the JAX server's does;
    a tensor-parallel mesh (queue A15) serves too, its healthz naming tp."""
    if "mesh" in option:
        payload = {"issue": TOPIC, "agent_opinions": OPINIONS, "method": "best_of_n",
                   "params": dict(PARAMS), "seed": 7, "request_id": "a9-mesh"}
        port = _served(create_server, FakeBackend(), Registry(), payload, **option)
        ref = _served(jax_create_server, JaxFakeBackend(), JaxRegistry(), payload, **option)
        assert port == ref
        server = create_server(backend=FakeBackend(), port=0, registry=Registry(),
                               **option).start()
        try:
            health = _get_json(server.base_url + "/healthz")
        finally:
            server.stop()
        assert len(health["engine"]["mesh"]["per_shard"]) == 2
        server = create_server(backend="torch", port=0, registry=Registry(), mesh="dp=1,tp=2",
                               backend_options={"model": "tiny-llama3", "device": "cpu",
                                                "max_context": 256}).start()
        try:
            status, body = _post(server.base_url, payload)
            health = _get_json(server.base_url + "/healthz")
        finally:
            server.stop()
        assert status == 200 and health["engine"]["mesh"]["tp"] == 2
        return
    if "state_dir" in option:
        option = {"state_dir": str(tmp_path / option["state_dir"])}
    server = create_server(backend=FakeBackend(), port=0, registry=Registry(), **option)
    server.start()
    try:
        status, body = _post(server.base_url, {
            "issue": TOPIC, "agent_opinions": OPINIONS, "method": "best_of_n",
            "params": dict(PARAMS), "seed": 7, "request_id": f"a8-{sorted(option)[0]}"})
        health = _get_json(server.base_url + "/healthz")
    finally:
        server.stop()
        from consensus_tpu_torch.obs.welfare import set_welfare_sink

        set_welfare_sink(None)
    assert status == 200 and body["statement"]
    if "fleet_size" in option or "fleet_options" in option:
        assert "fleet" in health
    if "state_dir" in option:
        assert health["durability"]["wal"]["unresolved"] == 0
    if "slo" in option:
        assert "slo" in health
    if "telemetry" in option:
        assert "welfare" in health


@pytest.mark.parametrize("name, item", [("api", "API judge"), ("openai", "API judge")])
def test_api_backends_raise(name, item):
    """The API backends (the API judge's module) are ported: a server over
    one, with no client here, answers as the JAX package's server does."""
    payload = {"issue": TOPIC, "agent_opinions": OPINIONS, "request_id": f"api-{name}",
               **PARITY_PAYLOADS["zero_shot"]}
    port = _served(create_server, name, Registry(), payload)
    ref = _served(jax_create_server, name, JaxRegistry(), payload)
    assert port == ref


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensus_tpu_torch.serve", "--backend", "fake",
         "--port", "0", "--log-level", "WARNING", "--blackbox", str(tmp_path / "bb.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        startup = json.loads(proc.stdout.readline())
        base = startup["serving"]
        assert startup["engine"] is True and startup["backend"] == "fake"
        status, body = _post(base, {"issue": TOPIC, "agent_opinions": OPINIONS,
                                    **PARITY_PAYLOADS["best_of_n"]})
        assert status == 200 and body["statement"]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as response:
            health = json.loads(response.read().decode())
        assert health["status"] == "ok" and health["engine"]["decode_windows"] >= 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    blackbox = json.loads((tmp_path / "bb.json").read_text())
    assert blackbox["reason"] == "sigterm"


@pytest.mark.parametrize("flags, item", [
    (["--fleet", "2"], "A8"), (["--speculative"], "A8"), (["--state-dir", "x"], "A8"),
    (["--telemetry"], "A8"), (["--slo"], "A8"), (["--mesh", "dp=2,tp=1"], "A9"),
])
def test_cli_deferred_flags_raise(flags, item, tmp_path):
    """The queue-A8 flags serve now (a subprocess answers one request and
    drains on SIGTERM, its startup JSON naming the plane); so does ``--mesh``
    (A9) with dp=2, and a tensor-parallel mesh (queue A15) answers through
    the torch backend's two CPU ranks."""
    flags = [str(tmp_path / f) if f == "x" else f for f in flags]
    runs = [(["--backend", "fake", *flags], PARITY_PAYLOADS["best_of_n"])]
    if "--mesh" in flags:
        # A tiny model in float32 with a short best_of_n keeps the CPU
        # request well inside the post's timeout.
        runs.append((["--backend", "torch", "--device", "cpu", "--backend-options",
                      '{"model": "tiny-llama3", "dtype": "float32", "max_context": 256}',
                      "--mesh", "dp=1,tp=2"],
                     {"method": "best_of_n", "params": {"n": 2, "max_tokens": 8}, "seed": 7}))
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    for run, payload in runs:
        _serve_one_request(run, payload, env)


def _serve_one_request(run, payload, env):
    """Start the CLI with ``run``'s flags, post one ``payload`` request,
    check the startup JSON and the answer, and drain it with SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensus_tpu_torch.serve", "--port", "0", "--log-level",
         "WARNING", *run],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        startup = json.loads(proc.stdout.readline())
        if "--fleet" in run:
            assert startup["fleet"] == 2
        if "--speculative" in run:
            assert startup["speculative"] is True
        if "--mesh" in run:
            assert startup["mesh"] == run[run.index("--mesh") + 1]
        status, body = _post(startup["serving"], {"issue": TOPIC, "agent_opinions": OPINIONS,
                                                  **payload})
        assert status == 200 and body["statement"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
