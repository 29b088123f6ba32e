"""Observability: labeled metrics + hierarchical spans (PyTorch port of the
experiment-side part of ``consensus_tpu/obs``; the serving modules --
traces, SLOs, welfare telemetry and quantile sketches -- wait for the
serving port).

* :mod:`consensus_tpu_torch.obs.metrics` -- a thread-safe registry of
  labeled counters, gauges and log-bucketed histograms with a JSON ``snapshot()`` and Prometheus text exposition;
* :mod:`consensus_tpu_torch.obs.spans` -- hierarchical (parent/child) spans
  behind ``utils.tracing.get_tracer()`` / ``timing.json``;
* :mod:`consensus_tpu_torch.obs.backends` -- the shared instrument set
  backends record into: padding efficiency, first sightings of padded
  shapes, host<->device transfer timings.

Artifacts: ``experiment.py`` snapshots the registry delta + span tree into
``run_dir/metrics.json`` (schema ``consensus_tpu.metrics.v1``, the JAX
package's, so readers of either package's files need no branch) and the
cumulative process registry into ``run_dir/metrics.prom``;
``cli/run_sweep.py --metrics-out`` merges cells into one sweep snapshot.
"""

from consensus_tpu_torch.obs.backends import (
    BackendInstruments,
    bucket_recompiles,
    padding_efficiency,
)
from consensus_tpu_torch.obs.metrics import (
    DEFAULT_COUNT_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Registry,
    diff_snapshots,
    exponential_buckets,
    get_registry,
    merge_snapshots,
    prometheus_text,
)
from consensus_tpu_torch.obs.spans import SpanTracer, diff_span_paths, get_span_tracer

__all__ = [
    "BackendInstruments",
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "Registry",
    "SpanTracer",
    "bucket_recompiles",
    "diff_snapshots",
    "diff_span_paths",
    "exponential_buckets",
    "get_registry",
    "get_span_tracer",
    "merge_snapshots",
    "padding_efficiency",
    "prometheus_text",
]
