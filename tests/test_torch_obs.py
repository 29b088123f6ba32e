"""The port's obs registry, spans, backend instruments and device trace
against the JAX package's ``consensus_tpu.obs``.

The same sequence of counter, gauge and histogram operations must
give equal ``snapshot()``, ``diff_snapshots``, ``merge_snapshots`` and
Prometheus text in both packages (exact: the arithmetic is the same Python).
Spans are wall-clock, so their trees are compared by names and counts.
"""

import json
import sys
import threading

import pytest
import torch

from consensus_tpu import obs as jax_obs
from consensus_tpu.obs import spans as jax_spans
from consensus_tpu_torch import obs
from consensus_tpu_torch.obs import spans
from consensus_tpu_torch.utils import tracing

torch.set_num_threads(1)


def _drive(module, registry, phase):
    """One phase of metric operations, identical whichever package's
    ``Registry`` records it."""
    requests = registry.counter("requests_total", "Requests served.", labels=("kind",))
    rows = registry.gauge("rows_live", "Rows live.")
    wait = registry.histogram("wait_seconds", "Queue wait.", labels=("kind",))
    fill = registry.histogram(
        "fill_sessions", "Batch fill.", buckets=module.DEFAULT_COUNT_BUCKETS
    )
    for i in range(5 + phase):
        requests.labels("generate" if i % 2 else "score").inc(1 + i)
        wait.labels("generate").observe(1e-4 * (3 ** i))
        fill.observe(i + 1)
    rows.set(10 * phase + 3)
    rows.inc(0.5)
    requests.labels('quote"back\\slash\nnew').inc()
    if phase:
        wait.labels("next_token").observe(2.5)


def _snapshots(module):
    registry = module.Registry()
    _drive(module, registry, 0)
    first = registry.snapshot()
    _drive(module, registry, 1)
    second = registry.snapshot()
    return first, second, registry


def test_registry_snapshot_diff_merge_and_prometheus_match_jax():
    jax_first, jax_second, jax_registry = _snapshots(jax_obs)
    first, second, registry = _snapshots(obs)
    assert first == jax_first and second == jax_second
    delta = obs.diff_snapshots(first, second)
    jax_delta = jax_obs.diff_snapshots(jax_first, jax_second)
    assert delta == jax_delta
    merged = obs.merge_snapshots([first, delta])
    assert merged == jax_obs.merge_snapshots([jax_first, jax_delta])
    assert registry.to_prometheus() == jax_registry.to_prometheus()
    assert obs.prometheus_text(delta) == jax_obs.prometheus_text(delta)
    # A JSON round trip (what metrics.json holds) renders the same text.
    assert obs.prometheus_text(json.loads(json.dumps(merged))) == jax_obs.prometheus_text(merged)
    assert obs.exponential_buckets(0.5, 3.0, 7) == jax_obs.exponential_buckets(0.5, 3.0, 7)
    assert obs.DEFAULT_TIME_BUCKETS == jax_obs.DEFAULT_TIME_BUCKETS


def test_backend_instruments_and_derived_readings_match_jax():
    def record(module):
        registry = module.Registry()
        instruments = module.BackendInstruments("tpu", registry=registry)
        firsts = [
            instruments.record_launch("score", (8, 128)),
            instruments.record_launch("score", (8, 128)),
            instruments.record_launch("generate", (8, 128, 64, 0, 0)),
        ]
        instruments.record_padding("score", 8, 128, 300)
        instruments.record_padding("generate_trunk", 1, 1024, 200, allocated_tokens=512)
        snap = registry.snapshot()
        return firsts, snap, module.padding_efficiency(snap), module.bucket_recompiles(snap)

    assert record(obs) == record(jax_obs)
    firsts, snap, efficiency, recompiles = record(obs)
    assert firsts == [True, False, True] and recompiles == 2
    assert efficiency == pytest.approx(500 / (8 * 128 + 512))
    assert obs.padding_efficiency({"families": {}}) is None


def _span_shape(nodes):
    return [(n["name"], n["count"], _span_shape(n["children"])) for n in nodes]


def test_span_tree_and_adopted_worker_threads_match_jax():
    def run(module):
        tracer = module.SpanTracer()
        with tracer.span("experiment"):
            parent = tracer.current_path()

            def worker(method):
                with tracer.adopt(parent), tracer.span(f"generate/{method}"):
                    with tracer.span("score"):
                        pass

            threads = [threading.Thread(target=worker, args=(m,)) for m in ("a", "b", "a")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
        before = {("experiment",): (0.0, 0)}
        window = module.diff_span_paths(before, tracer.snapshot_paths())
        return tracer, window

    ours, window = run(spans)
    theirs, jax_window = run(jax_spans)
    assert _span_shape(ours.tree()) == _span_shape(theirs.tree())
    assert _span_shape(ours.tree(window)) == _span_shape(theirs.tree(jax_window))
    assert _span_shape(ours.tree()) == [
        ("experiment", 1, [("generate/a", 2, [("score", 2, [])]),
                           ("generate/b", 1, [("score", 1, [])])])
    ]
    summary, jax_summary = ours.summary(), theirs.summary()
    assert {k: v["count"] for k, v in summary.items()} == {
        k: v["count"] for k, v in jax_summary.items()
    }
    assert tracing.get_tracer() is obs.get_span_tracer()


def test_registry_counts_every_update_under_thread_contention():
    """Many threads, a short switch interval: no increment or observation
    is lost."""
    registry = obs.Registry()
    counter = registry.counter("hits_total", labels=("worker",))
    hist = registry.histogram("lat_seconds")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                counter.labels(i % 3).inc()
                hist.observe(1e-3)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    families = registry.snapshot()["families"]
    assert sum(s["value"] for s in families["hits_total"]["series"]) == 12 * 2000
    assert families["lat_seconds"]["series"][0]["count"] == 12 * 2000


def test_device_trace_records_worker_threads(tmp_path):
    with tracing.device_trace(None):
        pass  # falsy log_dir: nothing written, nothing raised
    assert not list(tmp_path.iterdir())

    def work():
        x = torch.ones(16, 16)
        for _ in range(3):
            x = x @ x / 16

    with tracing.device_trace(str(tmp_path / "trace")):
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
        work()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    threads = {e.get("tid") for e in events if e.get("name") == "aten::mm"}
    assert len(threads) == 2, threads
