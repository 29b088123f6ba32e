"""The port's request-scoped tracing, iteration ledger, flight recorder and
rolling window (``obs/trace.py``) against the JAX package's.

The reference's own cases (``tests/test_trace.py``, without the fleet
failover tree, which waits for the fleet's port) run on the port: the
critical path partitions the root span exactly, server-minted request ids
are echoed in success and rejection bodies, the engine's ledger covers its
wall time, and a watchdog trip dumps a parseable blackbox.  The parity
cases feed the same synthetic span trees and iteration rows to both
packages and require equal exports (exact: both record the same floats)."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.engine import DecodeEngine
from consensus_tpu_torch.backends.faults import (
    FaultInjectingBackend,
    FaultPlan,
    FaultSpec,
)
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.obs.trace import (
    MAX_SPANS_PER_TRACE,
    FlightRecorder,
    IterationLedger,
    RollingWindow,
    TraceContext,
    TraceStore,
    get_flight_recorder,
    get_trace_store,
    trace_current,
    use_trace,
)
from consensus_tpu_torch.serve import (
    SchedulerRejected,
    create_server,
)

TOPIC = "Should we invest in public transport?"
OPINIONS = {
    "Agent 1": "Yes, buses are vital.",
    "Agent 2": "Only with congestion pricing.",
}


def _payload(seed=7, **overrides):
    payload = {
        "issue": TOPIC,
        "agent_opinions": dict(OPINIONS),
        "method": "best_of_n",
        "params": {"n": 2, "max_tokens": 16},
        "seed": seed,
        "request_id": f"req-{seed}",
    }
    payload.update(overrides)
    return payload


def _post(base_url, payload, timeout=30.0):
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


def _get(base_url, path, timeout=10.0):
    try:
        with urllib.request.urlopen(
            base_url + path, timeout=timeout
        ) as response:
            return response.status, json.loads(response.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# ---------------------------------------------------------------------------
# TraceContext unit behaviour
# ---------------------------------------------------------------------------


class TestTraceContext:
    def test_span_tree_export(self):
        trace = TraceContext("t-1")
        root = trace.begin("http_request", method="best_of_n")
        child = trace.begin("queue_wait", parent=root, replica="r0")
        trace.event(child, "probe", detail=1)
        trace.end(child)
        trace.end(root, status=200)
        exported = trace.to_dict()
        assert exported["trace_id"] == "t-1"
        by_name = {s["name"]: s for s in exported["spans"]}
        assert by_name["queue_wait"]["parent"] == root
        assert by_name["http_request"]["attrs"]["status"] == 200
        assert not by_name["http_request"]["in_flight"]
        assert by_name["queue_wait"]["events"][0]["name"] == "probe"

    def test_end_is_idempotent_first_wins(self):
        trace = TraceContext("t-2")
        span = trace.begin("handler")
        trace.end(span, outcome="ok")
        first = trace.to_dict()["spans"][0]["duration_s"]
        time.sleep(0.02)
        trace.end(span, outcome="late")  # attrs update, duration does not
        again = trace.to_dict()["spans"][0]
        assert again["duration_s"] == first
        assert again["attrs"]["outcome"] == "late"

    def test_span_cap_returns_noop_sentinel(self):
        trace = TraceContext("t-3")
        ids = [trace.begin(f"s{i}") for i in range(MAX_SPANS_PER_TRACE + 5)]
        assert ids[-1] == 0
        assert trace.dropped_spans == 5
        trace.end(0, outcome="ignored")  # must not raise
        trace.event(0, "ignored")
        assert len(trace.to_dict()["spans"]) == MAX_SPANS_PER_TRACE

    def test_critical_path_partitions_root_exactly(self):
        trace = TraceContext("t-4")
        root = trace.begin("http_request")
        queue = trace.begin("queue_wait", parent=root)
        time.sleep(0.01)
        trace.end(queue)
        row = trace.begin("engine_row", parent=root)
        time.sleep(0.005)
        trace.event(row, "slot_admitted")
        time.sleep(0.005)
        trace.event(row, "prefill_complete")
        time.sleep(0.01)
        trace.end(row, outcome="retired")
        score = trace.begin("engine_score", parent=root)
        time.sleep(0.005)
        trace.end(score)
        trace.end(root)
        path = trace.critical_path()
        phases = path["phases"]
        assert abs(sum(phases.values()) - path["total_s"]) < 1e-4
        for name in ("queue_wait", "admission_wait", "prefill", "decode",
                     "score"):
            assert phases[name] > 0.0, name
        assert phases["failover_overhead"] == 0.0


class TestUseTrace:
    def test_thread_local_carrier_nests_and_restores(self):
        trace = TraceContext("t-5")
        assert trace_current() is None
        with use_trace(trace, 1):
            assert trace_current() == (trace, 1)
            with use_trace(trace, 2):
                assert trace_current() == (trace, 2)
            assert trace_current() == (trace, 1)
        assert trace_current() is None

    def test_none_trace_is_passthrough(self):
        with use_trace(None, 7):
            assert trace_current() is None


class TestTraceStore:
    def test_lru_bound_and_recency(self):
        store = TraceStore(capacity=3)
        for i in range(5):
            store.put(TraceContext(f"t{i}"))
        assert len(store) == 3
        assert store.get("t0") is None and store.get("t1") is None
        assert store.get("t2") is not None
        # touching t2 makes t3 the eviction victim
        store.put(TraceContext("t5"))
        assert store.get("t3") is None
        assert store.get("t2") is not None


# ---------------------------------------------------------------------------
# IterationLedger / RollingWindow / FlightRecorder units
# ---------------------------------------------------------------------------


class TestIterationLedger:
    def test_residual_is_attributed_and_coverage_full(self):
        ledger = IterationLedger()
        ledger.record(
            start_s=10.0, end_s=10.1, idle_s=0.0, device_s=0.06,
            host={"sweep": 0.01, "admit": 0.005, "prefill": 0.0,
                  "cohort": 0.005, "merge": 0.01},
            tokens=32, cohort=4, queue_depth=2, pages_in_use=16,
        )
        ledger.record(
            start_s=10.15, end_s=10.25, idle_s=0.05, device_s=0.08,
            host={"sweep": 0.005, "admit": 0.0, "prefill": 0.0,
                  "cohort": 0.0, "merge": 0.005},
            tokens=16, cohort=2, queue_depth=0, pages_in_use=8,
        )
        report = ledger.mfu_attribution()
        assert report["iterations"] == 2
        assert report["tokens"] == 48
        assert report["coverage"] >= 0.95
        # residual host time (0.1 - 0.06 - 0.03 = 0.01) lands in "other"
        assert report["host_breakdown"]["other"] == pytest.approx(
            0.02, abs=1e-6)
        fractions = (report["device_fraction"] + report["host_fraction"]
                     + report["idle_fraction"])
        assert fractions == pytest.approx(1.0, abs=0.02)
        assert ledger.recent(1)[0]["iteration"] == 2


class TestRollingWindow:
    def test_buckets_availability_and_p95(self):
        window = RollingWindow(bucket_s=1.0)
        for t in (0.1, 0.5, 0.9):
            window.observe(t, ok=True, latency_s=0.010)
        window.observe(1.2, ok=False)
        window.observe(1.8, ok=True, latency_s=0.100)
        curve = window.curve()
        assert [row["t_s"] for row in curve] == [0.0, 1.0]
        assert curve[0]["offered"] == 3 and curve[0]["availability"] == 1.0
        assert curve[1]["availability"] == 0.5
        assert curve[1]["p95_ms"] == pytest.approx(100.0)
        assert curve[0]["rps"] == pytest.approx(3.0)


class TestFlightRecorderUnit:
    def test_dump_without_path_is_noop(self):
        recorder = FlightRecorder()
        recorder.record_event("replica_lost", replica="r0")
        assert recorder.dump("test") is None
        assert recorder.dumps == 0

    def test_dump_writes_parseable_blackbox(self, tmp_path):
        path = str(tmp_path / "blackbox.json")
        recorder = FlightRecorder(path=path)
        recorder.record_event("breaker_open", breaker="fake")
        recorder.record_iteration({"iteration": 1, "total_s": 0.01})
        assert recorder.dump("unit_test") == path
        with open(path, encoding="utf-8") as handle:
            blackbox = json.load(handle)
        assert blackbox["schema"] == FlightRecorder.SCHEMA
        assert blackbox["reason"] == "unit_test"
        assert blackbox["events"][0]["kind"] == "breaker_open"
        assert blackbox["iterations"][0]["iteration"] == 1
        assert recorder.dumps == 1

    def test_rings_are_bounded(self):
        recorder = FlightRecorder(max_events=4, max_iterations=2)
        for i in range(10):
            recorder.record_event("scale_up", replica=f"r{i}")
            recorder.record_iteration({"iteration": i})
        snapshot = recorder.snapshot()
        assert len(snapshot["events"]) == 4
        assert len(snapshot["iterations"]) == 2
        assert snapshot["events"][-1]["replica"] == "r9"


# ---------------------------------------------------------------------------
# End-to-end: HTTP -> scheduler -> engine span tree
# ---------------------------------------------------------------------------


class TestEndToEndTrace:
    def test_trace_block_endpoint_and_critical_path_sum(self):
        server = create_server(
            backend=FakeBackend(), port=0, registry=Registry()).start()
        try:
            # warm the stack (connection setup, lazy imports, first-flush
            # compile) so the measured request's latency is the span's
            _post(server.base_url, _payload(seed=30))
            start = time.perf_counter()
            status, body = _post(server.base_url, _payload(
                seed=31, request_id="trace-e2e-1", trace=True))
            latency_s = time.perf_counter() - start
            assert status == 200
            trace_block = body["trace"]
            assert trace_block["trace_id"] == "trace-e2e-1"
            names = {s["name"] for s in trace_block["spans"]}
            assert {"http_request", "queue_wait", "handler"} <= names
            assert "engine_row" in names  # slot lifecycle reached
            path = trace_block["critical_path"]
            total = path["total_s"]
            assert abs(sum(path["phases"].values()) - total) < 1e-4
            # the root span lies inside the measured request latency
            assert total <= latency_s

            status, exported = _get(server.base_url, "/v1/trace/trace-e2e-1")
            assert status == 200
            assert exported["trace_id"] == "trace-e2e-1"
            assert {s["name"] for s in exported["spans"]} >= {
                "http_request", "handler"}
            assert "critical_path" in exported

            status, error = _get(server.base_url, "/v1/trace/never-existed")
            assert status == 404
            assert error["error"]["type"] == "trace_not_found"
        finally:
            server.stop(drain=False, timeout=5.0)

    def test_trace_off_responses_have_no_trace_block(self):
        server = create_server(
            backend=FakeBackend(), port=0, registry=Registry()).start()
        try:
            status, body = _post(server.base_url, _payload(seed=32))
            assert status == 200
            assert "trace" not in body
        finally:
            server.stop(drain=False, timeout=5.0)

    def test_server_mints_request_id_and_echoes_in_success(self):
        server = create_server(
            backend=FakeBackend(), port=0, registry=Registry()).start()
        try:
            payload = _payload(seed=33)
            del payload["request_id"]
            status, body = _post(server.base_url, payload)
            assert status == 200
            assert body["request_id"].startswith("srv-")
            # deterministic digest: same payload -> same digest suffix
            status2, body2 = _post(server.base_url, payload)
            assert body["request_id"].split("-")[2] == \
                body2["request_id"].split("-")[2]
            assert body["request_id"] != body2["request_id"]  # seq differs
        finally:
            server.stop(drain=False, timeout=5.0)

    def test_minted_request_id_echoed_in_rejection_body(self):
        class SlowGen:
            name = "slow"

            def __init__(self):
                self.inner = FakeBackend()

            def __getattr__(self, attr):
                return getattr(self.inner, attr)

            def generate(self, requests):
                time.sleep(0.2)
                return self.inner.generate(requests)

        server = create_server(
            backend=SlowGen(), port=0, registry=Registry(),
            max_inflight=1, max_queue_depth=1).start()
        try:
            results = []

            def fire(seed):
                payload = _payload(seed=seed)
                del payload["request_id"]
                results.append(_post(server.base_url, payload))

            threads = [threading.Thread(target=fire, args=(40 + i,),
                                        daemon=True)
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)
            rejected = [b for s, b in results if s == 429]
            assert rejected, "capacity 1+1 under 8 concurrent posts must 429"
            for body in rejected:
                assert body["error"]["request_id"].startswith("srv-")
        finally:
            server.stop(drain=False, timeout=5.0)

    def _rejection_response(self, server, exc):
        """POST (no client request_id) with submit forced to reject."""
        scheduler = server.scheduler

        def rejecting_submit(request):
            raise exc

        scheduler.submit = rejecting_submit
        payload = _payload(seed=60)
        del payload["request_id"]
        request = urllib.request.Request(
            server.base_url + "/v1/consensus",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(request, timeout=10.0):
                raise AssertionError("rejection expected")
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read().decode()), err.headers

    def test_breaker_open_503_carries_request_id(self):
        server = create_server(
            backend=FakeBackend(), port=0, registry=Registry()).start()
        try:
            status, body, headers = self._rejection_response(
                server,
                SchedulerRejected("breaker_open",
                                  "circuit breaker open to backend",
                                  retry_after_s=3.0),
            )
            assert status == 503
            error = body["error"]
            assert error["type"] == "rejected"
            assert error["reason"] == "breaker_open"
            assert error["request_id"].startswith("srv-")
            assert headers["Retry-After"] is not None
        finally:
            server.stop(drain=False, timeout=5.0)

    def test_kv_oom_413_carries_request_id(self):
        server = create_server(
            backend=FakeBackend(), port=0, registry=Registry()).start()
        try:
            status, body, headers = self._rejection_response(
                server,
                SchedulerRejected("kv_oom",
                                  "request KV footprint exceeds pool"),
            )
            assert status == 413
            error = body["error"]
            assert error["type"] == "rejected"
            assert error["reason"] == "kv_oom"
            assert error["request_id"].startswith("srv-")
            # Oversized requests don't shrink on retry: no Retry-After.
            assert headers["Retry-After"] is None
        finally:
            server.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------


class TestEngineMfuAttribution:
    def test_ledger_covers_engine_wall_time(self):
        engine = DecodeEngine(
            FakeBackend(), slots=8, num_pages=512, auto_start=False,
        )
        outboxes = []
        threads = []
        try:
            for i in range(4):
                out = {}

                def worker(i=i, out=out):
                    out["result"] = engine.submit("generate", [
                        GenerationRequest(
                            user_prompt=f"prompt {i} with extra words",
                            max_tokens=8, seed=i,
                        )])

                thread = threading.Thread(target=worker, daemon=True)
                thread.start()
                threads.append(thread)
                outboxes.append(out)
            assert _wait_for(
                lambda: engine.stats()["queue_depth"] == 4)
            for _ in range(3):
                engine.run_iteration()
            for thread in threads:
                thread.join(timeout=10.0)
            assert all("result" in out for out in outboxes)
            report = engine.stats()["mfu_attribution"]
            assert report["iterations"] >= 3
            assert report["tokens"] > 0
            assert report["device_s"] > 0.0
            assert report["coverage"] >= 0.95  # the acceptance bar
            fractions = (report["device_fraction"] + report["host_fraction"]
                         + report["idle_fraction"])
            assert fractions == pytest.approx(1.0, abs=0.05)
            assert set(report["host_breakdown"]) == set(
                IterationLedger.HOST_PHASES)
        finally:
            engine.close()


# ---------------------------------------------------------------------------
# Watchdog trip -> blackbox dump (integration)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestWatchdogBlackbox:
    def test_watchdog_trip_dumps_blackbox(self, tmp_path):
        path = str(tmp_path / "blackbox.json")
        recorder = get_flight_recorder()
        recorder.configure(path)
        plan = FaultPlan(seed=1, faults=[
            FaultSpec(kind="hang", op="generate", call_index=0)])
        faulty = FaultInjectingBackend(FakeBackend(), plan)
        batching = BatchingBackend(
            faulty, engine=True,
            engine_options={"watchdog_timeout_s": 0.2},
        )
        try:
            thread = threading.Thread(
                target=lambda: batching.generate(
                    [GenerationRequest(user_prompt="hello", max_tokens=4)]),
                daemon=True,
            )
            thread.start()
            assert _wait_for(lambda: faulty.hangs_active == 1, timeout=5.0)
            assert _wait_for(
                lambda: batching.engine.watchdog_trips >= 1, timeout=5.0)
            assert _wait_for(lambda: recorder.dumps >= 1, timeout=5.0)
            with open(path, encoding="utf-8") as handle:
                blackbox = json.load(handle)
            assert blackbox["schema"] == FlightRecorder.SCHEMA
            assert blackbox["reason"] == "watchdog_trip"
            kinds = [e["kind"] for e in blackbox["events"]]
            assert "watchdog_trip" in kinds
        finally:
            faulty.release_hangs()
            batching.close()
            recorder.configure(None)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

from consensus_tpu.obs import trace as jax_trace  # noqa: E402
from consensus_tpu_torch.obs import trace as port_trace  # noqa: E402


def _synthetic_trace(mod):
    """A span tree with fixed times: patch the module clock so both packages
    record the same floats."""
    ticks = iter(x * 0.125 for x in range(1000))
    original = mod.time.perf_counter
    mod.time.perf_counter = lambda: next(ticks)
    try:
        trace = mod.TraceContext("parity-1")
        root = trace.begin("http_request", method="best_of_n")
        queue = trace.begin("queue_wait", parent=root)
        trace.end(queue)
        handler = trace.begin("handler", parent=root)
        for i in range(3):
            row = trace.begin("engine_row", parent=handler, row=i)
            trace.event(row, "slot_admitted", slot=i)
            trace.end(row, outcome="retired", tokens=4 + i)
        trace.end(handler, outcome="ok")
        trace.end(root, status=200)
        return trace.to_dict(), trace.critical_path()
    finally:
        mod.time.perf_counter = original


def test_trace_export_and_critical_path_match_jax():
    port_dict, port_path = _synthetic_trace(port_trace)
    jax_dict, jax_path = _synthetic_trace(jax_trace)
    for payload in (port_dict, jax_dict):
        payload.pop("created_wall", None)
    assert port_path == jax_path
    assert port_dict == jax_dict
    assert abs(sum(port_path["phases"].values()) - port_path["total_s"]) < 1e-9


def _ledger_report(mod):
    ledger = mod.IterationLedger()
    t = 0.0
    for i in range(12):
        host = {phase: 0.001 * (j + 1) for j, phase in enumerate(mod.IterationLedger.HOST_PHASES)}
        ledger.record(
            start_s=t, end_s=t + 0.05, idle_s=0.002 * (i % 3), dispatch_s=0.004,
            block_s=0.02, host=host, tokens=8 * (i % 4), cohort=i % 4,
            queue_depth=i % 5, pages_in_use=3 * i,
        )
        t += 0.06
    return ledger.mfu_attribution()


def test_iteration_ledger_report_matches_jax():
    port, ref = _ledger_report(port_trace), _ledger_report(jax_trace)
    port.pop("note"), ref.pop("note")
    assert port == ref


def test_rolling_window_curve_matches_jax():
    curves = []
    for mod in (port_trace, jax_trace):
        window = mod.RollingWindow(bucket_s=0.5)
        for i in range(40):
            window.observe(i * 0.07, ok=i % 7 != 0, latency_s=0.01 * (i % 9))
        curves.append(window.curve())
    assert curves[0] == curves[1]
