"""The port's mergeable quantile sketches (``obs/sketch.py``) and the sketch
family of its metrics registry against the JAX package's.

Every case feeds the same value stream, made from a seed with numpy, to
both packages.  Tolerance: exact.  The stores, counts, sums, min/max and
exemplars are equal, the quantiles bit-equal; merges are associative and
commutative in the port and equal the JAX merges; ``federate_snapshot``,
``diff_snapshots``, ``merge_snapshots`` and the Prometheus text of a
sketch family give the same results in both packages."""

import numpy as np
import pytest

from consensus_tpu.obs import metrics as jax_metrics
from consensus_tpu.obs import sketch as jax_sketch
from consensus_tpu_torch.obs import metrics, sketch

QS = (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)


def _stream(seed, n=600, kind="latency"):
    rng = np.random.RandomState(seed)
    if kind == "latency":
        values = np.exp(rng.normal(-3.0, 1.5, size=n))
    else:  # signed welfare-like values with a zero cluster and a NaN
        values = np.concatenate([
            rng.uniform(-1.0, 1.0, size=n // 2),
            -np.exp(rng.normal(1.0, 1.0, size=n // 2 - 3)),
            [0.0, 1e-12, np.nan],
        ])
    return [float(v) for v in values]


def _both(values, trace_every=7, **kwargs):
    port, ref = sketch.QuantileSketch(**kwargs), jax_sketch.QuantileSketch(**kwargs)
    for i, v in enumerate(values):
        trace = f"t{i}" if i % trace_every == 0 else None
        port.observe(v, trace)
        ref.observe(v, trace)
    return port, ref


@pytest.mark.parametrize("kind, extreme, alpha", [
    ("latency", "high", 0.01), ("latency", "high", 0.05), ("welfare", "low", 0.01),
])
def test_same_stream_same_stores_and_quantiles(kind, extreme, alpha):
    port, ref = _both(_stream(3, kind=kind), relative_accuracy=alpha, extreme=extreme)
    assert port.to_dict() == ref.to_dict()
    assert port.quantiles(QS) == ref.quantiles(QS)
    for q in QS:
        assert port.quantile(q) == ref.quantile(q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_is_associative_commutative_and_equals_jax(seed):
    streams = [_stream(10 * seed + i, n=200 + 50 * i) for i in range(3)]
    pairs = [_both(s) for s in streams]
    port = [p for p, _ in pairs]

    def fresh(i):
        return sketch.QuantileSketch.from_dict(port[i].to_dict())

    left = fresh(0).merge(fresh(1)).merge(fresh(2))
    right = fresh(0).merge(fresh(1).merge(fresh(2)))
    swapped = fresh(2).merge(fresh(0)).merge(fresh(1))
    ref = jax_sketch.QuantileSketch.from_dict(pairs[0][1].to_dict())
    ref.merge(pairs[1][1]).merge(pairs[2][1])
    pooled, _ = _both([v for s in streams for v in s], trace_every=10**9)
    assert left.series_view()["pos"] == right.series_view()["pos"] == swapped.series_view()["pos"]
    assert left.series_view()["pos"] == pooled.series_view()["pos"]
    assert left.to_dict() == ref.to_dict()
    assert left.quantiles(QS) == ref.quantiles(QS) == right.quantiles(QS)
    assert left.count == right.count == swapped.count == sum(len(s) for s in streams)


def _registries(seed):
    """The same three-replica sketch / counter / gauge families in a
    registry of each package."""
    regs = (metrics.Registry(), jax_metrics.Registry())
    rng = np.random.RandomState(seed)
    streams = {f"r{i}": np.exp(rng.normal(-2.0, 1.0, size=80 + 20 * i)) for i in range(3)}
    for reg in regs:
        lat = reg.sketch("lat", "latency", ("replica", "method"))
        welfare = reg.sketch("welfare", "welfare", ("replica",), extreme="low")
        reqs = reg.counter("reqs_total", "requests", ("replica",))
        occ = reg.gauge("occ", "occupancy", ("replica",))
        for name, values in streams.items():
            for i, v in enumerate(values):
                lat.labels(name, "best_of_n" if i % 3 else "zero_shot").observe(
                    float(v), f"{name}-{i}" if i % 11 == 0 else None)
                welfare.labels(name).observe(float(-v))
                reqs.labels(name).inc()
            occ.labels(name).set(len(values))
    return regs


@pytest.mark.parametrize("seed", [4, 5])
def test_federate_snapshot_equals_jax(seed):
    port, ref = _registries(seed)
    assert port.snapshot() == ref.snapshot()
    fed = sketch.federate_snapshot(port.snapshot())
    assert fed == jax_sketch.federate_snapshot(ref.snapshot())
    assert sketch.federate_snapshot(fed) == fed  # idempotent
    assert metrics.prometheus_text(fed) == jax_metrics.prometheus_text(fed)
    assert port.to_prometheus() == ref.to_prometheus()
    fleet = [s for s in fed["families"]["lat"]["series"] if s["labels"]["replica"] == "fleet"]
    assert sum(s["count"] for s in fleet) == sum(
        s["count"] for s in fed["families"]["lat"]["series"] if s["labels"]["replica"] != "fleet")
    assert "fleet" not in {s["labels"]["replica"] for s in fed["families"]["occ"]["series"]}


def test_snapshot_diff_and_merge_of_sketches_equal_jax():
    port, ref = _registries(6)
    before = (port.snapshot(), ref.snapshot())
    for reg in (port, ref):
        reg.sketch("lat", "latency", ("replica", "method")).labels("r1", "zero_shot").observe(0.5)
    after = (port.snapshot(), ref.snapshot())
    delta = metrics.diff_snapshots(before[0], after[0])
    assert delta == jax_metrics.diff_snapshots(before[1], after[1])
    assert [s["count"] for s in delta["families"]["lat"]["series"]] == [1]
    merged = metrics.merge_snapshots([before[0], after[0]])
    assert merged == jax_metrics.merge_snapshots([before[1], after[1]])


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_quantile_from_series_equals_sketch(q):
    port, ref = _both(_stream(8))
    view = port.series_view()
    assert sketch.quantile_from_series(view, q) == port.quantile(q)
    assert sketch.quantile_from_series(view, q) == jax_sketch.quantile_from_series(ref.series_view(), q)
    assert sketch.diff_sketch_series(view, view) is None
