"""Mergeable quantile sketches: honest fleet-level percentiles.

PyTorch port of ``consensus_tpu/obs/sketch.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

Prometheus histograms (``obs/metrics.py``) answer "how is time spent on
THIS replica", but their fixed-boundary buckets cannot answer "what is the
fleet p99" without the classic histogram-quantile interpolation error, and
averaging per-replica percentiles is simply wrong.  This module adds a
DDSketch-style log-bucketed quantile sketch with a *relative-error
guarantee*: every estimate ``q̂`` of a true quantile value ``q`` satisfies
``|q̂ - q| <= alpha * |q|``.

Why the merge is exact (the property the fleet view rests on): a sketch is
nothing but integer bucket counts keyed by ``ceil(log_gamma |v|)``.  Two
sketches with the same ``gamma`` merge by adding counts key-wise, and
integer addition is associative and commutative — so the merge of N
replica sketches is *identical* (same stores, same count, same min/max,
hence bit-equal quantiles) to the sketch of the pooled observation stream.
``tests/test_torch_sketch.py`` pins associativity, commutativity, and the
error bound as property tests; the federated ``/metrics`` view leans on it
for provably-honest fleet p99s.

Value range: welfare values are signed (log-Nash welfare is negative, a
cosine egalitarian welfare lives in [-1, 1]), so the sketch keeps three
stores — negative, zero, positive — and guarantees relative error on
``|v|``.  Values with ``|v| < MIN_TRACKABLE`` collapse into the zero
bucket (absolute error ``MIN_TRACKABLE``, far below any signal here).

Exemplars: an observation may carry a ``trace_id``.  The sketch retains a
bounded set of exemplars from its interesting tail (``extreme="high"`` for
latency — the slow tail; ``extreme="low"`` for welfare — the unfair tail),
so the worst bucket links straight to ``GET /v1/trace/<id>``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

#: |v| below this collapses into the zero bucket.
MIN_TRACKABLE = 1e-12
#: Default relative-error bound alpha.
DEFAULT_RELATIVE_ACCURACY = 0.01
#: Default bound on retained exemplars per sketch.
DEFAULT_MAX_EXEMPLARS = 8

_EXTREMES = ("high", "low")


class QuantileSketch:
    """Log-bucketed quantile sketch with exact, lossless merge.

    Thread-safe.  ``observe`` is O(1): one ``math.log``, a dict increment,
    and a handful of scalar updates under one lock.
    """

    __slots__ = (
        "_lock",
        "relative_accuracy",
        "extreme",
        "max_exemplars",
        "_gamma",
        "_log_gamma",
        "count",
        "sum",
        "min",
        "max",
        "_zero",
        "_pos",
        "_neg",
        "_exemplars",
    )

    def __init__(
        self,
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        extreme: str = "high",
        max_exemplars: int = DEFAULT_MAX_EXEMPLARS,
    ) -> None:
        if not (0.0 < relative_accuracy < 1.0):
            raise ValueError(
                f"relative_accuracy must be in (0, 1), got {relative_accuracy}"
            )
        if extreme not in _EXTREMES:
            raise ValueError(f"extreme must be one of {_EXTREMES}")
        self._lock = threading.Lock()
        self.relative_accuracy = float(relative_accuracy)
        self.extreme = extreme
        self.max_exemplars = int(max_exemplars)
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._zero = 0
        # bucket index -> observation count; index i covers
        # (gamma^(i-1), gamma^i] for positives, mirrored for negatives.
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}
        # value -> exemplar; bounded to max_exemplars from the `extreme` tail.
        self._exemplars: Dict[float, str] = {}

    # -- recording ---------------------------------------------------------

    def _index(self, magnitude: float) -> int:
        return int(math.ceil(math.log(magnitude) / self._log_gamma))

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        value = float(value)
        if math.isnan(value):
            return
        magnitude = abs(value)
        index = 0
        if magnitude >= MIN_TRACKABLE and not math.isinf(magnitude):
            index = self._index(magnitude)
        with self._lock:
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            if magnitude < MIN_TRACKABLE:
                self._zero += 1
            elif value > 0:
                self._pos[index] = self._pos.get(index, 0) + 1
            else:
                self._neg[index] = self._neg.get(index, 0) + 1
            if trace_id:
                self._note_exemplar(value, trace_id)

    def _note_exemplar(self, value: float, trace_id: str) -> None:
        # Keep the max_exemplars most-extreme traced observations: highest
        # values for extreme="high" (slow tail), lowest for extreme="low".
        self._exemplars[value] = trace_id
        if len(self._exemplars) > self.max_exemplars:
            evict = (
                min(self._exemplars)
                if self.extreme == "high"
                else max(self._exemplars)
            )
            del self._exemplars[evict]

    # -- queries -----------------------------------------------------------

    def _bucket_value(self, index: int) -> float:
        # Midpoint of (gamma^(i-1), gamma^i] in the log domain: within
        # relative_accuracy of every value the bucket can hold.
        return 2.0 * self._gamma ** index / (self._gamma + 1.0)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1], within ``relative_accuracy``
        of the exact order statistic ``sorted(values)[floor(q*(n-1))]``."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            if q == 0.0:
                return self.min
            if q == 1.0:
                return self.max
            rank = int(math.floor(q * (self.count - 1)))
            result = self._value_at_rank(rank)
        return result

    def _value_at_rank(self, rank: int) -> float:
        # Ascending value order: negatives from most-negative (largest
        # index) to least, then zeros, then positives ascending.
        cumulative = 0
        for index in sorted(self._neg, reverse=True):
            cumulative += self._neg[index]
            if cumulative > rank:
                return self._clamp(-self._bucket_value(index))
        cumulative += self._zero
        if cumulative > rank:
            return 0.0
        for index in sorted(self._pos):
            cumulative += self._pos[index]
            if cumulative > rank:
                return self._clamp(self._bucket_value(index))
        return self.max if self.max is not None else 0.0

    def _clamp(self, value: float) -> float:
        if self.min is not None and value < self.min:
            return self.min
        if self.max is not None and value > self.max:
            return self.max
        return value

    def quantiles(self, qs: Iterable[float]) -> Dict[str, Optional[float]]:
        return {_format_q(q): self.quantile(q) for q in qs}

    # -- merge (exact) -----------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self.  Lossless: the result's stores equal
        those of a sketch that observed both streams."""
        if abs(other.relative_accuracy - self.relative_accuracy) > 1e-12:
            raise ValueError(
                "cannot merge sketches with different relative accuracy "
                f"({self.relative_accuracy} vs {other.relative_accuracy})"
            )
        with other._lock:
            o_count, o_sum = other.count, other.sum
            o_min, o_max, o_zero = other.min, other.max, other._zero
            o_pos, o_neg = dict(other._pos), dict(other._neg)
            o_ex = dict(other._exemplars)
        with self._lock:
            self.count += o_count
            self.sum += o_sum
            if o_min is not None and (self.min is None or o_min < self.min):
                self.min = o_min
            if o_max is not None and (self.max is None or o_max > self.max):
                self.max = o_max
            self._zero += o_zero
            for index, n in o_pos.items():
                self._pos[index] = self._pos.get(index, 0) + n
            for index, n in o_neg.items():
                self._neg[index] = self._neg.get(index, 0) + n
            for value, trace_id in o_ex.items():
                self._note_exemplar(value, trace_id)
        return self

    # -- serialization -----------------------------------------------------

    def series_view(self) -> Dict[str, Any]:
        """The JSON-able store dump used as a registry snapshot series."""
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "zero": self._zero,
                "pos": {str(k): v for k, v in sorted(self._pos.items())},
                "neg": {str(k): v for k, v in sorted(self._neg.items())},
                "exemplars": [
                    {"value": value, "trace_id": trace_id}
                    for value, trace_id in sorted(self._exemplars.items())
                ],
            }

    def to_dict(self) -> Dict[str, Any]:
        out = self.series_view()
        out["relative_accuracy"] = self.relative_accuracy
        out["extreme"] = self.extreme
        return out

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "QuantileSketch":
        sketch = cls(
            relative_accuracy=data.get(
                "relative_accuracy", DEFAULT_RELATIVE_ACCURACY
            ),
            extreme=data.get("extreme", "high"),
        )
        return sketch._load_series(data)

    @classmethod
    def from_series(
        cls,
        series: Mapping[str, Any],
        relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
        extreme: str = "high",
    ) -> "QuantileSketch":
        """Rehydrate from a registry snapshot series dict."""
        sketch = cls(relative_accuracy=relative_accuracy, extreme=extreme)
        return sketch._load_series(series)

    def _load_series(self, data: Mapping[str, Any]) -> "QuantileSketch":
        self.count = int(data.get("count", 0))
        self.sum = float(data.get("sum", 0.0))
        self.min = data.get("min")
        self.max = data.get("max")
        self._zero = int(data.get("zero", 0))
        self._pos = {int(k): int(v) for k, v in data.get("pos", {}).items()}
        self._neg = {int(k): int(v) for k, v in data.get("neg", {}).items()}
        for exemplar in data.get("exemplars", []):
            self._note_exemplar(
                float(exemplar["value"]), str(exemplar["trace_id"])
            )
        return self


def _format_q(q: float) -> str:
    text = f"{q:g}"
    return text


# -- snapshot-series algebra -------------------------------------------------
#
# Mirrors the counter/histogram conventions in ``obs/metrics.py``: stores
# and counts are monotonic, so diff is exact subtraction and merge is exact
# addition.  min/max are cumulative in a diff (same caveat as histograms);
# exemplars take the ``after`` / union view.


def _store_diff(
    before: Mapping[str, int], after: Mapping[str, int]
) -> Dict[str, int]:
    out = {}
    for key, n in after.items():
        delta = n - before.get(key, 0)
        if delta:
            out[key] = delta
    return out


def _store_merge(
    target: Dict[str, int], extra: Mapping[str, int]
) -> Dict[str, int]:
    for key, n in extra.items():
        target[key] = target.get(key, 0) + n
    return target


def _merge_exemplars(
    target: List[Dict[str, Any]],
    extra: Iterable[Mapping[str, Any]],
    extreme: str = "high",
    max_exemplars: int = DEFAULT_MAX_EXEMPLARS,
) -> List[Dict[str, Any]]:
    seen: Dict[float, str] = {
        float(e["value"]): str(e["trace_id"]) for e in target
    }
    for e in extra:
        seen[float(e["value"])] = str(e["trace_id"])
    reverse = extreme == "high"
    kept = sorted(seen.items(), reverse=reverse)[:max_exemplars]
    return [
        {"value": value, "trace_id": trace_id}
        for value, trace_id in sorted(kept)
    ]


def diff_sketch_series(
    old: Optional[Mapping[str, Any]], new: Mapping[str, Any]
) -> Optional[Dict[str, Any]]:
    """``new - old`` for one sketch series; None when nothing happened."""
    if old is None:
        old = {}
    count = new.get("count", 0) - old.get("count", 0)
    if count == 0:
        return None
    return {
        "count": count,
        "sum": new.get("sum", 0.0) - old.get("sum", 0.0),
        "min": new.get("min"),
        "max": new.get("max"),
        "zero": new.get("zero", 0) - old.get("zero", 0),
        "pos": _store_diff(old.get("pos", {}), new.get("pos", {})),
        "neg": _store_diff(old.get("neg", {}), new.get("neg", {})),
        "exemplars": [dict(e) for e in new.get("exemplars", [])],
    }


def merge_sketch_series(
    target: Dict[str, Any],
    extra: Mapping[str, Any],
    extreme: str = "high",
) -> Dict[str, Any]:
    """Fold sketch series ``extra`` into ``target`` in place (exact)."""
    target["count"] = target.get("count", 0) + extra.get("count", 0)
    target["sum"] = target.get("sum", 0.0) + extra.get("sum", 0.0)
    for field, pick in (("min", min), ("max", max)):
        values = [
            v for v in (target.get(field), extra.get(field)) if v is not None
        ]
        target[field] = pick(values) if values else None
    target["zero"] = target.get("zero", 0) + extra.get("zero", 0)
    target["pos"] = _store_merge(dict(target.get("pos", {})), extra.get("pos", {}))
    target["neg"] = _store_merge(dict(target.get("neg", {})), extra.get("neg", {}))
    target["exemplars"] = _merge_exemplars(
        list(target.get("exemplars", [])),
        extra.get("exemplars", []),
        extreme=extreme,
    )
    return target


def quantile_from_series(
    series: Mapping[str, Any],
    q: float,
    relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
) -> Optional[float]:
    """Quantile straight from a snapshot series dict."""
    return QuantileSketch.from_series(
        series, relative_accuracy=relative_accuracy
    ).quantile(q)


# -- fleet federation --------------------------------------------------------


def federate_snapshot(
    snapshot: Mapping[str, Any],
    label: str = "replica",
    merged_value: str = "fleet",
) -> Dict[str, Any]:
    """Add fleet-merged series to a registry snapshot.

    For every family carrying ``label``, series that agree on all OTHER
    labels are merged into one extra series with ``label=merged_value``
    (per-replica series are preserved alongside).  Counters and histograms
    sum; sketches merge losslessly, so the federated p99 is *exactly* the
    sketch of the pooled per-replica observations.  Gauges are skipped:
    summing a tier gauge or last-writing an occupancy gauge across
    replicas would both lie.
    """
    import copy

    out = {"families": copy.deepcopy(dict(snapshot.get("families", {})))}
    for name, family in out["families"].items():
        if label not in family.get("labels", []):
            continue
        kind = family["type"]
        if kind == "gauge":
            continue
        groups: Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]] = {}
        for series in family["series"]:
            labels = dict(series["labels"])
            if labels.get(label) == merged_value:
                continue  # already a federated series; don't double-count
            labels[label] = merged_value
            key = tuple(sorted(labels.items()))
            merged = groups.get(key)
            if merged is None:
                merged = {
                    k: (dict(labels) if k == "labels" else copy.deepcopy(v))
                    for k, v in series.items()
                }
                groups[key] = merged
                continue
            if kind == "sketch":
                merge_sketch_series(
                    merged, series, extreme=family.get("extreme", "high")
                )
            elif kind == "histogram":
                merged["count"] += series["count"]
                merged["sum"] += series["sum"]
                merged["bucket_counts"] = [
                    a + b
                    for a, b in zip(
                        merged["bucket_counts"], series["bucket_counts"]
                    )
                ]
                for field, pick in (("min", min), ("max", max)):
                    values = [
                        v
                        for v in (merged[field], series[field])
                        if v is not None
                    ]
                    merged[field] = pick(values) if values else None
            else:  # counter
                merged["value"] += series["value"]
        existing = {
            tuple(sorted(s["labels"].items())) for s in family["series"]
        }
        family["series"].extend(
            groups[key] for key in sorted(groups) if key not in existing
        )
    return out
