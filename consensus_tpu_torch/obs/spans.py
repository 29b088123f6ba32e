"""Hierarchical wall-clock spans (PyTorch port of
``consensus_tpu/obs/spans.py``).

A span records under the *path* of enclosing spans on its thread, so
``timing.json``'s flat name→total view (``summary()`` — backward
compatible, aggregated by leaf name) and a nested parent/child tree
(``tree()`` — the ``metrics.json`` view) come from one accumulator.

Worker threads start with an empty span stack, which would orphan their
spans at the root.  ``adopt(path)`` grafts a thread under a parent path
recorded elsewhere — the experiment engine wraps its thread-pool workers
in ``adopt`` so concurrent ``generate/<method>`` spans nest under the
``experiment`` span that spawned them.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

SpanPaths = Dict[Tuple[str, ...], Tuple[float, int]]


class SpanTracer:
    """Thread-safe accumulator of named wall-clock spans, keyed by path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        #: path -> [total_s, count]
        self._nodes: Dict[Tuple[str, ...], List] = {}

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        stack = self._stack()
        stack.append(str(name))
        path = tuple(stack)
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            stack.pop()
            with self._lock:
                node = self._nodes.setdefault(path, [0.0, 0])
                node[0] += elapsed
                node[1] += 1

    def current_path(self) -> Tuple[str, ...]:
        return tuple(self._stack())

    @contextlib.contextmanager
    def adopt(self, path: Tuple[str, ...]) -> Iterator[None]:
        """Run this thread's spans as children of ``path`` (cross-thread
        nesting for pool workers)."""
        stack = self._stack()
        saved = list(stack)
        stack[:] = list(path)
        try:
            yield
        finally:
            stack[:] = saved

    # -- views --------------------------------------------------------------

    def snapshot_paths(self) -> SpanPaths:
        with self._lock:
            return {path: (node[0], node[1]) for path, node in self._nodes.items()}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Flat leaf-name → totals view (the ``timing.json`` contract)."""
        flat: Dict[str, List] = {}
        for path, (total, count) in self.snapshot_paths().items():
            node = flat.setdefault(path[-1], [0.0, 0])
            node[0] += total
            node[1] += count
        return {
            name: {
                "total_s": round(total, 4),
                "count": count,
                "mean_s": round(total / count, 4),
            }
            for name, (total, count) in sorted(flat.items())
        }

    def tree(self, paths: Optional[SpanPaths] = None) -> List[Dict]:
        """Nested parent/child view: a list of root span nodes, each
        ``{name, total_s, count, mean_s, children}``.  Pass ``paths`` (e.g.
        a ``diff_span_paths`` result) to render a window instead of the
        whole process history."""
        if paths is None:
            paths = self.snapshot_paths()
        roots: List[Dict] = []
        index: Dict[Tuple[str, ...], Dict] = {}
        for path in sorted(paths):
            total, count = paths[path]
            node = {
                "name": path[-1],
                "total_s": round(total, 4),
                "count": count,
                "mean_s": round(total / count, 4) if count else 0.0,
                "children": [],
            }
            index[path] = node
            parent = index.get(path[:-1])
            # An adopted child can outlive its parent's recording window;
            # missing parents fall back to root rather than being dropped.
            (parent["children"] if parent else roots).append(node)
        return roots

    def write(self, path) -> None:
        from consensus_tpu_torch.utils.io_atomic import atomic_write_json

        atomic_write_json(path, self.summary())

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()


def diff_span_paths(before: SpanPaths, after: SpanPaths) -> SpanPaths:
    """``after - before`` per path, dropping paths with no new samples."""
    out: SpanPaths = {}
    for path, (total, count) in after.items():
        old_total, old_count = before.get(path, (0.0, 0))
        if count - old_count > 0:
            out[path] = (total - old_total, count - old_count)
    return out


_GLOBAL = SpanTracer()


def get_span_tracer() -> SpanTracer:
    """The process-wide tracer (``utils.tracing.get_tracer`` returns it)."""
    return _GLOBAL
