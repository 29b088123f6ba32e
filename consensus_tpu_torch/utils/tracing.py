"""Tracing / profiling: phase spans and a device-trace window (PyTorch port
of ``consensus_tpu/utils/tracing.py``).

Spans live in :mod:`consensus_tpu_torch.obs.spans`: ``get_tracer()``
returns the process-global hierarchical tracer, whose flat
``summary()``/``write()`` views aggregate by leaf name (``timing.json``).
``device_trace`` wraps ``torch.profiler`` where the JAX package wraps
``jax.profiler.trace``: CPU and CUDA activity of every thread of the
process, written under ``log_dir`` as a Chrome trace that Perfetto and
TensorBoard's trace viewer load.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import time
from typing import Iterator, Optional

from consensus_tpu_torch.obs.spans import SpanTracer, get_span_tracer

Tracer = SpanTracer


def get_tracer() -> SpanTracer:
    return get_span_tracer()


def _all_threads() -> dict:
    """``profile`` keyword arguments that record the CPU ops of every thread:
    by default the profiler records only the thread that opened it, and the
    experiment's worker threads issue the calls.  Older PyTorch has no such
    option (its CUDA activity still covers every thread's kernels)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` window over the block; no-op when ``log_dir`` is
    falsy.  CUDA activity is recorded when a card is present.  The trace
    lands at ``log_dir/<host>.<pid>.<ms>.pt.trace.json`` (the file name
    TensorBoard's profiler plugin lists)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, **_all_threads()) as prof:
        yield
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    prof.export_chrome_trace(str(out / name))
