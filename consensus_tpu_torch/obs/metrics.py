"""Thread-safe labeled metrics: counters, gauges, log-bucketed histograms
and mergeable quantile sketches (PyTorch port of
``consensus_tpu/obs/metrics.py``: the same families, snapshot schema and
Prometheus text, so the ``metrics.json`` of either package reads the same).

Design constraints, in order:

1. **Hot-path cheap.**  A ``child = family.labels(...)`` handle is a dict
   lookup + one small lock; updates are a locked float add.  Backends cache
   handles where a call site's labels are fixed.
2. **Two export surfaces.**  ``Registry.snapshot()`` → a JSON-able dict
   (the ``metrics.json`` artifact), ``Registry.to_prometheus()`` → the
   Prometheus text exposition format, so a scrape endpoint or a file sink
   needs no extra translation layer.
3. **Deltas compose.**  Run directories record per-cell *deltas* of the
   process-global registry (``diff_snapshots``), and the sweep CLI sums
   cells back together (``merge_snapshots``) — counter and histogram
   series are monotonic, so subtraction/addition by (name, labels) is
   exact; gauges take the latest value.

Histograms are log-bucketed by default (``exponential_buckets``): device
timings span 100 µs dispatches to multi-second generate calls, so linear buckets
would waste resolution at one end or the other.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from consensus_tpu_torch.obs.sketch import (
    DEFAULT_RELATIVE_ACCURACY,
    QuantileSketch,
    diff_sketch_series,
    merge_sketch_series,
    quantile_from_series,
)

#: Quantiles rendered for sketch families in the Prometheus exposition.
SKETCH_EXPORT_QUANTILES = (0.5, 0.9, 0.95, 0.99)


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` log-spaced upper bounds: start, start*factor, ..."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, value = [], float(start)
    for _ in range(count):
        out.append(value)
        value *= factor
    return tuple(out)


#: 100 µs .. ~52 s in powers of two — covers a fused-step dispatch through
#: a whole-budget generate call.
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-4, 2.0, 20)
#: 1 .. 2048 in powers of two — batch fills, rows, merged request counts.
DEFAULT_COUNT_BUCKETS = exponential_buckets(1.0, 2.0, 12)

_KINDS = ("counter", "gauge", "histogram", "sketch")


class Counter:
    """Monotonic labeled series.  ``inc`` only; negative increments raise."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins labeled series."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Log-bucketed distribution: per-bucket counts + sum/count/min/max.

    ``boundaries`` are inclusive upper bounds (Prometheus ``le``
    semantics); one overflow bucket (+Inf) is implicit at the end of
    ``bucket_counts``.
    """

    __slots__ = ("_lock", "boundaries", "bucket_counts", "count", "sum", "min", "max")

    def __init__(self, boundaries: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self.boundaries = tuple(float(b) for b in boundaries)
        self.bucket_counts = [0] * (len(self.boundaries) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        index = len(self.boundaries)  # overflow bucket
        for i, bound in enumerate(self.boundaries):
            if value <= bound:
                index = i
                break
        with self._lock:
            self.bucket_counts[index] += 1
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value


class MetricFamily:
    """One named metric with a fixed label schema and many labeled series."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        extreme: str = "high",
    ) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.buckets = (
            tuple(buckets) if buckets is not None else DEFAULT_TIME_BUCKETS
        )
        self.relative_accuracy = float(relative_accuracy)
        self.extreme = extreme
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, *values) -> Any:
        """The series handle for one label-value tuple (created on first use)."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label values "
                f"{self.label_names}, got {key}"
            )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "counter":
                        child = Counter()
                    elif self.kind == "gauge":
                        child = Gauge()
                    elif self.kind == "sketch":
                        child = QuantileSketch(
                            relative_accuracy=self.relative_accuracy,
                            extreme=self.extreme,
                        )
                    else:
                        child = Histogram(self.buckets)
                    self._children[key] = child
        return child

    # Unlabeled convenience: family.inc()/set()/observe() hit the () series.
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        if self.kind == "sketch":
            self.labels().observe(value, trace_id)
        else:
            self.labels().observe(value)

    def _series(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    """Process-wide metric namespace.  ``get_registry()`` is the default
    instance every subsystem records into; tests construct their own."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _family(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        extreme: str = "high",
    ) -> MetricFamily:
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = MetricFamily(
                    name,
                    kind,
                    help,
                    labels,
                    buckets,
                    relative_accuracy=relative_accuracy,
                    extreme=extreme,
                )
                self._families[name] = family
            elif family.kind != kind or family.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}{tuple(labels)} "
                    f"but exists as {family.kind}{family.label_names}"
                )
            return family

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._family(name, "gauge", help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        return self._family(name, "histogram", help, labels, buckets)

    def sketch(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        extreme: str = "high",
    ):
        """A mergeable quantile-sketch family (see ``obs/sketch.py``):
        relative-error-bounded percentiles whose per-replica series can be
        federated into an exact fleet-level distribution."""
        return self._family(
            name,
            "sketch",
            help,
            labels,
            relative_accuracy=relative_accuracy,
            extreme=extreme,
        )

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: {"families": {name: {type, help, labels, series}}}."""
        families: Dict[str, Any] = {}
        with self._lock:
            items = sorted(self._families.items())
        for name, family in items:
            entry: Dict[str, Any] = {
                "type": family.kind,
                "help": family.help,
                "labels": list(family.label_names),
                "series": [],
            }
            if family.kind == "histogram":
                entry["bucket_boundaries"] = list(family.buckets)
            elif family.kind == "sketch":
                entry["relative_accuracy"] = family.relative_accuracy
                entry["extreme"] = family.extreme
            for key, child in family._series():
                series: Dict[str, Any] = {
                    "labels": dict(zip(family.label_names, key))
                }
                if family.kind == "histogram":
                    with child._lock:
                        series.update(
                            count=child.count,
                            sum=child.sum,
                            min=child.min,
                            max=child.max,
                            bucket_counts=list(child.bucket_counts),
                        )
                elif family.kind == "sketch":
                    series.update(child.series_view())
                else:
                    series["value"] = child.value
                entry["series"].append(series)
            families[name] = entry
        return {"families": families}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (deterministic ordering)."""
        return prometheus_text(self.snapshot())


def prometheus_text(snapshot: Mapping[str, Any]) -> str:
    """Render any registry snapshot (live, diffed, or federated) as the
    Prometheus text exposition format.  Sketch families render as
    summaries: ``name{quantile="0.99"}`` series (reconstructed from the
    stores, so a federated snapshot exposes honest merged percentiles)
    plus ``name_sum`` / ``name_count``."""
    lines: List[str] = []
    snap = snapshot.get("families", {})
    for name in sorted(snap):
        family = snap[name]
        if family["help"]:
            lines.append(f"# HELP {name} {family['help']}")
        kind = family["type"]
        exposition_type = "summary" if kind == "sketch" else kind
        lines.append(f"# TYPE {name} {exposition_type}")
        for series in family["series"]:
            labels = series["labels"]
            if kind == "histogram":
                cumulative = 0
                for bound, n in zip(
                    family["bucket_boundaries"], series["bucket_counts"]
                ):
                    cumulative += n
                    le = dict(labels, le=_format_value(bound))
                    lines.append(
                        f"{name}_bucket{_format_labels(le)} {cumulative}"
                    )
                cumulative += series["bucket_counts"][-1]
                le = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_format_labels(le)} {cumulative}")
                lines.append(
                    f"{name}_sum{_format_labels(labels)} "
                    f"{_format_value(series['sum'])}"
                )
                lines.append(
                    f"{name}_count{_format_labels(labels)} {series['count']}"
                )
            elif kind == "sketch":
                accuracy = family.get(
                    "relative_accuracy", DEFAULT_RELATIVE_ACCURACY
                )
                for q in SKETCH_EXPORT_QUANTILES:
                    value = quantile_from_series(
                        series, q, relative_accuracy=accuracy
                    )
                    if value is None:
                        continue
                    ql = dict(labels, quantile=f"{q:g}")
                    lines.append(
                        f"{name}{_format_labels(ql)} {_format_value(value)}"
                    )
                lines.append(
                    f"{name}_sum{_format_labels(labels)} "
                    f"{_format_value(series['sum'])}"
                )
                lines.append(
                    f"{name}_count{_format_labels(labels)} {series['count']}"
                )
            else:
                lines.append(
                    f"{name}{_format_labels(labels)} "
                    f"{_format_value(series['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def _format_value(value: float) -> str:
    value = float(value)
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _format_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels.items())
    return "{" + body + "}"


# -- snapshot algebra --------------------------------------------------------
#
# Counters and histogram counts/sums are monotonic, so per-cell deltas
# (diff) and cross-cell aggregation (merge) are exact series-wise
# arithmetic.  Gauges are last-write-wins in both directions.  Histogram
# min/max don't subtract: a diff reports the *cumulative* min/max observed
# by the end of the window (approximate, flagged in the schema name).


def _series_key(series: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(series["labels"].items()))


def diff_snapshots(
    before: Mapping[str, Any], after: Mapping[str, Any]
) -> Dict[str, Any]:
    """``after - before``, dropping all-zero series.  Exact for counters
    and histogram counts/sums; gauges keep their ``after`` value."""
    before_families = before.get("families", {})
    out_families: Dict[str, Any] = {}
    for name, family in after.get("families", {}).items():
        prior = {
            _series_key(s): s
            for s in before_families.get(name, {}).get("series", [])
        }
        series_out = []
        for series in family["series"]:
            old = prior.get(_series_key(series))
            if family["type"] == "histogram":
                old_counts = old["bucket_counts"] if old else None
                counts = [
                    n - (old_counts[i] if old_counts else 0)
                    for i, n in enumerate(series["bucket_counts"])
                ]
                count = series["count"] - (old["count"] if old else 0)
                if count == 0:
                    continue
                series_out.append(
                    {
                        "labels": dict(series["labels"]),
                        "count": count,
                        "sum": series["sum"] - (old["sum"] if old else 0.0),
                        "min": series["min"],
                        "max": series["max"],
                        "bucket_counts": counts,
                    }
                )
            elif family["type"] == "sketch":
                delta = diff_sketch_series(old, series)
                if delta is None:
                    continue
                delta["labels"] = dict(series["labels"])
                series_out.append(delta)
            elif family["type"] == "counter":
                value = series["value"] - (old["value"] if old else 0.0)
                if value == 0:
                    continue
                series_out.append(
                    {"labels": dict(series["labels"]), "value": value}
                )
            else:  # gauge: latest value is the meaningful one
                series_out.append(
                    {"labels": dict(series["labels"]), "value": series["value"]}
                )
        if series_out:
            entry = {
                "type": family["type"],
                "help": family["help"],
                "labels": list(family["labels"]),
                "series": series_out,
            }
            if family["type"] == "histogram":
                entry["bucket_boundaries"] = list(family["bucket_boundaries"])
            elif family["type"] == "sketch":
                entry["relative_accuracy"] = family.get(
                    "relative_accuracy", DEFAULT_RELATIVE_ACCURACY
                )
                entry["extreme"] = family.get("extreme", "high")
            out_families[name] = entry
    return {"families": out_families}


def merge_snapshots(snapshots: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Sum counter/histogram series across snapshots (the sweep-level
    aggregate); gauges last-write-wins.  Bucket boundaries must agree."""
    out_families: Dict[str, Any] = {}
    for snap in snapshots:
        for name, family in snap.get("families", {}).items():
            extra_schema: Dict[str, Any] = {}
            if family["type"] == "histogram":
                extra_schema["bucket_boundaries"] = list(
                    family["bucket_boundaries"]
                )
            elif family["type"] == "sketch":
                extra_schema["relative_accuracy"] = family.get(
                    "relative_accuracy", DEFAULT_RELATIVE_ACCURACY
                )
                extra_schema["extreme"] = family.get("extreme", "high")
            target = out_families.setdefault(
                name,
                {
                    "type": family["type"],
                    "help": family["help"],
                    "labels": list(family["labels"]),
                    "series": [],
                    **extra_schema,
                },
            )
            index = {_series_key(s): s for s in target["series"]}
            for series in family["series"]:
                existing = index.get(_series_key(series))
                if existing is None:
                    target["series"].append(
                        {k: (dict(v) if k == "labels" else v) for k, v in series.items()}
                    )
                    continue
                if family["type"] == "sketch":
                    merge_sketch_series(
                        existing,
                        series,
                        extreme=family.get("extreme", "high"),
                    )
                elif family["type"] == "histogram":
                    existing["count"] += series["count"]
                    existing["sum"] += series["sum"]
                    existing["bucket_counts"] = [
                        a + b
                        for a, b in zip(
                            existing["bucket_counts"], series["bucket_counts"]
                        )
                    ]
                    for field, pick in (("min", min), ("max", max)):
                        values = [
                            v for v in (existing[field], series[field]) if v is not None
                        ]
                        existing[field] = pick(values) if values else None
                elif family["type"] == "counter":
                    existing["value"] += series["value"]
                else:
                    existing["value"] = series["value"]
    for family in out_families.values():
        family["series"].sort(key=_series_key)
    return {"families": out_families}


_GLOBAL_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry every subsystem records into."""
    return _GLOBAL_REGISTRY
