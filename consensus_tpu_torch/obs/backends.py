"""The instrument set backends record into, and its derived readings
(PyTorch port of ``consensus_tpu/obs/backends.py``: the same metric names
and labels, so the ``metrics.json`` of either package reads the same).

Every backend that pads work onto a device grid answers three questions
through one :class:`BackendInstruments` handle:

* **Padding efficiency** -- of the tokens a padded ``rows x width`` program
  processed, how many were real?  Recorded per (kind, rows, width) bucket
  so a lopsided bucket ladder shows up as one bad cell, not a blended
  average.
* **Bucket shapes** -- was this padded program shape seen before?  First
  sightings count under ``backend_bucket_compiles_total``, repeats under
  ``backend_bucket_cache_hits_total``.  In eager PyTorch a first sighting
  compiles nothing: the family counts the DISTINCT padded shapes a window
  launched (what would be a compile under a tracing runtime, and what
  warms the caching allocator and a kernel's first launch here), so
  ``bucket_recompiles`` reads as the size of the shape ladder the window
  touched, not as compile time spent.
* **Host<->device transfer** -- time spent placing batches (H2D) and
  fetching results (D2H).  CUDA launches are asynchronous, so the D2H fetch
  blocks on device execution still in flight: ``backend_d2h_seconds`` is an
  upper bound that includes device time.

``padding_efficiency`` / ``bucket_recompiles`` reduce a registry snapshot
to the two headline numbers ``metrics.json`` reports.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Mapping, Optional, Set, Tuple

from consensus_tpu_torch.obs.metrics import (
    DEFAULT_TIME_BUCKETS,
    Registry,
    get_registry,
)


class BackendInstruments:
    """Per-backend handles on the shared metric families.

    ``backend`` labels every series so two backends in one process stay
    separable in one registry: ``TorchBackend`` records as ``"tpu"`` (the
    JAX package's resident backend's label, so the families match run for
    run), ``FakeBackend`` as ``"fake"``.
    """

    def __init__(self, backend: str, registry: Optional[Registry] = None) -> None:
        reg = registry if registry is not None else get_registry()
        self.backend = backend
        self.registry = reg
        self._useful = reg.counter(
            "backend_padding_useful_tokens_total",
            "Real (non-padding) tokens processed by padded device programs.",
            labels=("backend", "kind", "rows", "width"),
        )
        self._allocated = reg.counter(
            "backend_padding_allocated_tokens_total",
            "Total token slots (rows x width) allocated by padded device programs.",
            labels=("backend", "kind", "rows", "width"),
        )
        self._compiles = reg.counter(
            "backend_bucket_compiles_total",
            "First sighting of a padded program shape (a compile, or a "
            "compile-cache load).",
            labels=("backend", "kind"),
        )
        self._cache_hits = reg.counter(
            "backend_bucket_cache_hits_total",
            "Launches whose padded program shape was already compiled.",
            labels=("backend", "kind"),
        )
        self._h2d = reg.histogram(
            "backend_h2d_seconds",
            "Host-to-device batch placement time.",
            labels=("backend",),
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self._d2h = reg.histogram(
            "backend_d2h_seconds",
            "Device-to-host result fetch time (includes in-flight device "
            "execution under async dispatch).",
            labels=("backend",),
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self._seen_lock = threading.Lock()
        self._seen_shapes: Set[Tuple[str, Tuple[int, ...]]] = set()

    # -- padding -------------------------------------------------------------

    def record_padding(
        self,
        kind: str,
        rows: int,
        width: int,
        useful_tokens: int,
        allocated_tokens: Optional[int] = None,
    ) -> None:
        """One padded program call: ``useful_tokens`` real tokens inside an
        ``rows × width`` grid (override ``allocated_tokens`` for programs
        whose footprint isn't the plain product, e.g. trunk+segment)."""
        allocated = rows * width if allocated_tokens is None else allocated_tokens
        self._useful.labels(self.backend, kind, rows, width).inc(useful_tokens)
        self._allocated.labels(self.backend, kind, rows, width).inc(allocated)

    # -- compile cache -------------------------------------------------------

    def record_launch(self, kind: str, shape: Tuple[int, ...]) -> bool:
        """Count a program launch; returns True on the shape's first
        sighting (a compile), False on a cache hit."""
        key = (kind, tuple(int(d) for d in shape))
        with self._seen_lock:
            first = key not in self._seen_shapes
            if first:
                self._seen_shapes.add(key)
        if first:
            self._compiles.labels(self.backend, kind).inc()
        else:
            self._cache_hits.labels(self.backend, kind).inc()
        return first

    # -- transfers -----------------------------------------------------------

    @contextlib.contextmanager
    def time_h2d(self) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._h2d.labels(self.backend).observe(time.perf_counter() - start)

    @contextlib.contextmanager
    def time_d2h(self) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._d2h.labels(self.backend).observe(time.perf_counter() - start)


# -- derived readings --------------------------------------------------------


def _sum_series(
    snapshot: Mapping[str, Any], name: str, backend: Optional[str] = None
) -> float:
    total = 0.0
    family = snapshot.get("families", {}).get(name)
    for series in (family or {}).get("series", ()):
        if backend is not None and series["labels"].get("backend") != backend:
            continue
        total += series["value"]
    return total


def padding_efficiency(
    snapshot: Mapping[str, Any], backend: Optional[str] = None
) -> Optional[float]:
    """useful / allocated tokens across all padded programs in ``snapshot``
    (optionally one backend); None when nothing was recorded."""
    allocated = _sum_series(
        snapshot, "backend_padding_allocated_tokens_total", backend
    )
    if allocated <= 0:
        return None
    useful = _sum_series(snapshot, "backend_padding_useful_tokens_total", backend)
    return useful / allocated


def bucket_recompiles(
    snapshot: Mapping[str, Any], backend: Optional[str] = None
) -> int:
    """Distinct padded program shapes compiled in ``snapshot``'s window."""
    return int(_sum_series(snapshot, "backend_bucket_compiles_total", backend))
