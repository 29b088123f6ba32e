"""The device trace of a ``--trace 1`` run.

``torch.profiler`` records the card's kernels over the window (device
activity only: recording every host operator would slow the host loop that
the idle share measures).  The busy time is the union of the kernel
intervals, as in ``consensus_tpu_torch/cli/profile_search.py`` (copied
here so that the yardstick stays put).  A marker kernel launched at the
window's start, with the device idle, ties the trace's clock to the host's,
so each idle gap can be named by the host-side call it fell in.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Tuple

import torch

_MARKER_CYCLES = 1000


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


@dataclasses.dataclass
class Trace:
    """Kernels as (name, start, end) in host perf_counter seconds."""

    kernels: List[Tuple[str, float, float]]
    start: float
    end: float
    aligned: bool

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return union_seconds([(lo, hi) for _, lo, hi in self.kernels])

    def seconds_by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, lo, hi in self.kernels:
            out[name] = out.get(name, 0.0) + (hi - lo)
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, at = [], self.start
        for lo, hi in sorted((lo, hi) for _, lo, hi in self.kernels):
            if lo > at:
                gaps.append((at, lo))
            at = max(at, hi)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps


def _kernel_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of each device kernel or copy, read from the
    profiler's raw results (building its per-event Python objects would
    take minutes for a window's million kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        return [
            (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda
        ]
    except AttributeError:  # a profiler without the raw results' accessors
        return [
            (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events()
            if e.device_type == cuda
        ]


class Tracer:
    """Profiles the card between ``start()`` and ``stop()``."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self._t1 = 0.0

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        torch.cuda._sleep(_MARKER_CYCLES)

    def stop(self) -> Trace:
        torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = _kernel_events(self._prof)
        self._prof = None
        marker = next((e for e in events if "spin" in e[0].lower() or "sleep" in e[0].lower()), None)
        events = [e for e in events if e is not marker]
        if marker is not None:
            offset, aligned = self._t0 - marker[1], True
        else:
            offset, aligned = self._t0 - min((e[1] for e in events), default=0.0), False
        kernels = [(name, lo + offset, hi + offset) for name, lo, hi in events]
        return Trace(kernels=kernels, start=self._t0, end=self._t1, aligned=aligned)


def breakdown(trace: Trace, spans: List[Tuple[str, float, float]], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what
    the host was doing: inside a call of the model backend (by kind), or
    between calls (the methods, the batching layer, the clients)."""
    ops = sorted(trace.seconds_by_kernel().items(), key=lambda kv: -kv[1])[:top]
    covered: Dict[str, List[Tuple[float, float]]] = {}
    for kind, lo, hi in sorted(spans, key=lambda s: s[1]):
        runs = covered.setdefault(kind, [])
        if runs and lo <= runs[-1][1]:
            runs[-1] = (runs[-1][0], max(runs[-1][1], hi))
        else:
            runs.append((lo, hi))
    starts = {kind: [lo for lo, _ in runs] for kind, runs in covered.items()}

    def inside(kind: str, t: float) -> bool:
        i = bisect.bisect_right(starts[kind], t) - 1
        return i >= 0 and covered[kind][i][1] >= t

    idle: Dict[str, float] = {}
    for lo, hi in trace.idle_gaps():
        mid = 0.5 * (lo + hi)
        kinds = [k for k in covered if inside(k, mid)]
        key = ("in " + "+".join(sorted(set(kinds)))) if kinds else "between backend calls"
        if not trace.aligned:
            key = "unaligned clock: " + key
        idle[key] = idle.get(key, 0.0) + (hi - lo)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[_short(n), s] for n, s in ops],
        "idle_gaps": [[n, s] for n, s in gaps],
    }


def _short(name: str, head: int = 70, tail: int = 60) -> str:
    """A kernel's name cut to its head and tail (template arguments differ
    at the end)."""
    return name if len(name) <= head + tail + 3 else name[:head] + "..." + name[-tail:]


def kernel_ms_per_launch(window, kernel: str, label: str):
    """Device ms of the traced kernels named ``kernel`` over the launches the
    program counted in the window (``kernel_launches_total{kernel=label}``)."""
    if window.trace is None:
        return None
    launches = sum(
        v for (family, labels), v in window.registry.items()
        if family == "kernel_launches_total" and dict(labels).get("kernel") == label
    )
    seconds = sum(hi - lo for name, lo, hi in window.trace.kernels if kernel in name)
    return 1e3 * seconds / launches if launches and seconds else None
