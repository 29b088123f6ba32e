"""Observability: labeled metrics, hierarchical spans and request traces
(PyTorch port of ``consensus_tpu/obs``).

* :mod:`consensus_tpu_torch.obs.metrics` -- a thread-safe registry of
  labeled counters, gauges and log-bucketed histograms with a JSON ``snapshot()`` and Prometheus text exposition;
* :mod:`consensus_tpu_torch.obs.spans` -- hierarchical (parent/child) spans
  behind ``utils.tracing.get_tracer()`` / ``timing.json``;
* :mod:`consensus_tpu_torch.obs.trace` -- request-scoped span trees and
  their critical path, the engine's iteration ledger, the flight recorder
  (``--blackbox``) and rolling windows;
* :mod:`consensus_tpu_torch.obs.backends` -- the shared instrument set
  backends record into: padding efficiency, first sightings of padded
  shapes, host<->device transfer timings;
* :mod:`consensus_tpu_torch.obs.sketch` -- mergeable quantile sketches
  (exact fleet federation of per-replica series);
* :mod:`consensus_tpu_torch.obs.welfare` / :mod:`consensus_tpu_torch.obs.slo`
  -- the serving plane's welfare telemetry and burn-rate SLO engine.

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
from consensus_tpu_torch.obs.sketch import (
    QuantileSketch,
    federate_snapshot,
    quantile_from_series,
)
from consensus_tpu_torch.obs.slo import SLOEngine, SLOSpec
from consensus_tpu_torch.obs.welfare import (
    ServeTelemetry,
    WelfareDriftDetector,
    get_welfare_sink,
    set_welfare_sink,
)
from consensus_tpu_torch.obs.spans import SpanTracer, diff_span_paths, get_span_tracer
from consensus_tpu_torch.obs.trace import (
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

__all__ = [
    "BackendInstruments",
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "FlightRecorder",
    "IterationLedger",
    "QuantileSketch",
    "Registry",
    "RollingWindow",
    "SLOEngine",
    "SLOSpec",
    "ServeTelemetry",
    "SpanTracer",
    "TraceContext",
    "TraceStore",
    "WelfareDriftDetector",
    "bucket_recompiles",
    "diff_snapshots",
    "diff_span_paths",
    "exponential_buckets",
    "federate_snapshot",
    "get_flight_recorder",
    "get_registry",
    "get_span_tracer",
    "get_trace_store",
    "get_welfare_sink",
    "merge_snapshots",
    "padding_efficiency",
    "prometheus_text",
    "quantile_from_series",
    "set_welfare_sink",
    "trace_current",
    "use_trace",
]
