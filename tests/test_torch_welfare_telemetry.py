"""The port's welfare telemetry plane (``obs/welfare.py``: ServeTelemetry,
WelfareDriftDetector, the score-matrix sink) against the JAX package's.

The same responses, made from a seed with numpy, go to both packages'
``ServeTelemetry``.  Tolerance: exact.  The registry snapshots (sketch
stores, gap gauges, drift counters) are equal after every request, and the
drift condition is raised at the same request index.  The port's
``record_matrix`` feeds an installed sink exactly as the JAX one does.  End
to end over the fake backends: a server with telemetry and SLOs on answers
the same bodies as one with them off and as the JAX server, its
``/healthz`` gains the same ``welfare`` block, and a three-replica fleet's
federated latency sketch is exactly the merge of the replicas'."""

import json
import urllib.request

import numpy as np
import pytest

from consensus_tpu.backends.score_matrix import ScoreMatrixResult as JaxMatrixResult
from consensus_tpu.backends.score_matrix import record_matrix as jax_record_matrix
from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.obs.welfare import ServeTelemetry as JaxTelemetry
from consensus_tpu.obs.welfare import WelfareDriftDetector as JaxDrift
from consensus_tpu.obs.welfare import set_welfare_sink as jax_set_sink
from consensus_tpu.serve import create_server as jax_create_server
from consensus_tpu_torch.backends.score_matrix import ScoreMatrixResult, record_matrix
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.obs.sketch import merge_sketch_series, quantile_from_series
from consensus_tpu_torch.obs.welfare import (
    ServeTelemetry,
    WelfareDriftDetector,
    get_welfare_sink,
    set_welfare_sink,
)
from consensus_tpu_torch.serve import create_server

ISSUE = "Should we invest in public transport?"
OPINIONS = {
    "Agent 1": "Yes, buses and trains are vital public goods.",
    "Agent 2": "Only alongside congestion pricing for cars.",
    "Agent 3": "Prefer cycling infrastructure over big rail projects.",
}


@pytest.fixture(autouse=True)
def _clear_sinks():
    yield
    set_welfare_sink(None)
    jax_set_sink(None)


def _value(rng, shift=0.0, degraded=False):
    egal = float(rng.uniform(0.1, 0.4) - shift)
    util = egal + float(rng.uniform(0.05, 0.3))
    value = {
        "welfare": {
            "egalitarian_welfare_cosine": egal,
            "utilitarian_welfare_cosine": util,
            "log_nash_welfare_cosine": float(np.log(max(util, 1e-3))),
        },
        "utilities": {f"a{i}": {"cosine_similarity": float(rng.uniform(egal, 1.0))}
                      for i in range(3)},
    }
    if degraded:
        value.update(degraded=True, degraded_reason="brownout")
    return value


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_detector_raises_at_the_same_index(seed):
    rng = np.random.RandomState(seed)
    # A stationary reference, then a collapse of the worst-off tail.
    values = np.concatenate([rng.normal(0.5, 0.05, 80), rng.normal(0.5, 0.05, 60) - 0.3])
    port, ref = WelfareDriftDetector(window=48, min_samples=32), JaxDrift(window=48, min_samples=32)
    raised = []
    for i, v in enumerate(values):
        port.observe(float(v))
        ref.observe(float(v))
        assert port.status() == ref.status()
        if port.drifted and not raised:
            raised.append(i)
    assert raised and raised[0] >= 80
    assert port.baseline_snapshot() == ref.baseline_snapshot()


@pytest.mark.parametrize("seed", [3, 4])
def test_same_responses_same_sketches_gauges_and_drift_index(seed):
    rng = np.random.RandomState(seed)
    regs = (Registry(), JaxRegistry())
    port = ServeTelemetry(registry=regs[0], drift_options={"window": 32, "min_samples": 16})
    ref = JaxTelemetry(registry=regs[1], drift_options={"window": 32, "min_samples": 16})
    first_drift = [None, None]
    for i in range(120):
        shift = 0.25 if i >= 70 else 0.0
        kwargs = dict(
            method="best_of_n" if i % 3 else "zero_shot",
            outcome="degraded" if i % 5 == 0 else "ok",
            latency_s=float(rng.exponential(0.2)),
            value=_value(rng, shift, degraded=i % 5 == 0) if i % 7 else None,
            replica=f"r{i % 2}",
            tier="small" if i % 10 == 0 else "",
            trace_id=f"req-{i}" if i % 4 == 0 else None,
        )
        port.record_request(**kwargs)
        ref.record_request(**kwargs)
        for j, telemetry in enumerate((port, ref)):
            if first_drift[j] is None and telemetry.drift_status()["drifted"]:
                first_drift[j] = i
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert first_drift[0] == first_drift[1] is not None


@pytest.mark.parametrize("rule", ["egalitarian", "utilitarian", "log_nash", None])
def test_record_matrix_feeds_the_installed_sink(rule):
    rng = np.random.RandomState(5)
    regs = (Registry(), JaxRegistry())
    set_welfare_sink(ServeTelemetry(registry=regs[0]))
    jax_set_sink(JaxTelemetry(registry=regs[1]))
    assert get_welfare_sink() is not None
    for _ in range(6):
        utilities = rng.uniform(0.0, 1.0, size=(4, 3)).astype(np.float32)
        welfare = utilities.min(axis=1)
        best = int(np.argmax(welfare))
        kwargs = dict(utilities=utilities, welfare=welfare, best=best, cells=12, d2h_bytes=48)
        record_matrix(ScoreMatrixResult(**kwargs), 3, registry=Registry(), welfare_rule=rule)
        jax_record_matrix(JaxMatrixResult(**kwargs), 3, registry=JaxRegistry(), welfare_rule=rule)
    got, want = regs[0].snapshot()["families"], regs[1].snapshot()["families"]
    for family in ("score_path_welfare", "score_path_min_agent_utility"):
        assert got[family] == want[family]
        assert sum(s["count"] for s in got[family]["series"]) == 6


def test_record_matrix_without_a_sink_records_nothing_more():
    set_welfare_sink(None)
    registry = Registry()
    utilities = np.ones((2, 2), np.float32)
    record_matrix(ScoreMatrixResult(utilities=utilities, welfare=utilities.min(1), best=0,
                                    cells=4, d2h_bytes=16), 2, registry=registry)
    assert set(registry.snapshot()["families"]) == {
        "score_matrix_cells_total", "score_matrix_d2h_bytes_total", "score_agents_per_call"}


def _post(base_url, payload, timeout=30.0):
    request = urllib.request.Request(
        base_url + "/v1/consensus", data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(request, timeout=timeout) as response:
        return response.status, json.loads(response.read().decode())


def _get(base_url, path):
    with urllib.request.urlopen(base_url + path, timeout=10.0) as response:
        return json.loads(response.read().decode())


def _payload(seed, issue=ISSUE):
    return {"issue": issue, "agent_opinions": dict(OPINIONS), "method": "best_of_n",
            "params": {"n": 4, "max_tokens": 24}, "seed": seed, "evaluate": True,
            "request_id": f"req-{seed}"}


def _serve(factory, registry, telemetry, seeds=(7, 8, 9), **kwargs):
    server = factory(backend="fake", port=0, registry=registry, max_inflight=4,
                     telemetry=telemetry, slo=telemetry, **kwargs).start()
    try:
        bodies = []
        for seed in seeds:
            status, body = _post(server.base_url, _payload(seed))
            assert status == 200
            body.pop("generation_time_s")
            bodies.append(json.dumps(body, sort_keys=True))
        health = _get(server.base_url, "/healthz")
        return bodies, health
    finally:
        server.stop(drain=False, timeout=5.0)
        set_welfare_sink(None)
        jax_set_sink(None)


def test_telemetry_on_equals_off_and_the_jax_server():
    regs = (Registry(), JaxRegistry())
    on, health = _serve(create_server, regs[0], True)
    off, off_health = _serve(create_server, Registry(), False)
    ref, ref_health = _serve(jax_create_server, regs[1], True)
    assert on == off == ref
    assert health["welfare"] == ref_health["welfare"]
    assert set(health["slo"]) == set(ref_health["slo"])
    assert "welfare" not in off_health and "slo" not in off_health
    port_f, ref_f = regs[0].snapshot()["families"], regs[1].snapshot()["families"]
    for family in ("welfare_egalitarian", "welfare_utilitarian", "welfare_log_nash",
                   "min_agent_utility", "welfare_by_tier", "welfare_gap_util_egal"):
        assert port_f[family] == ref_f[family], family


def test_fleet_federated_latency_sketch_is_the_exact_merge():
    registry = Registry()
    server = create_server(backend="fake", port=0, registry=registry, fleet_size=3,
                           max_inflight=2, max_queue_depth=16, telemetry=True, slo=True).start()
    try:
        for i in range(12):
            status, _ = _post(server.base_url, _payload(100 + i, f"{ISSUE} (variant {i})"))
            assert status == 200
        fed = server.scheduler.federated_metrics_snapshot()
        family = fed["families"]["serve_latency_sketch_seconds"]
        fleet, replicas = None, []
        for series in family["series"]:
            if series["labels"].get("outcome") != "ok":
                continue
            body = {k: v for k, v in series.items() if k != "labels"}
            if series["labels"]["replica"] == "fleet":
                fleet = body
            else:
                replicas.append(body)
        assert fleet is not None and len(replicas) >= 2
        pooled = dict(replicas[0])
        for extra in replicas[1:]:
            merge_sketch_series(pooled, extra)
        assert pooled["pos"] == fleet["pos"] and pooled["count"] == fleet["count"] == 12
        for q in (0.5, 0.9, 0.99):
            assert quantile_from_series(fleet, q) == quantile_from_series(pooled, q)
        text = urllib.request.urlopen(server.base_url + "/metrics", timeout=5).read().decode()
        assert 'serve_latency_sketch_seconds_count{replica="fleet",outcome="ok"} 12' in text
        slo = _get(server.base_url, "/v1/slo")
        assert {s["name"] for s in slo["specs"]} >= {"availability", "latency_p95", "welfare_drift"}
    finally:
        server.stop(drain=False, timeout=10.0)
