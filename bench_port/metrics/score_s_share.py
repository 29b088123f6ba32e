"""score_s_share: share of the window's wall inside scoring calls, in %.

Layer: Backend, session (``backends/torch_backend.py``, ``score_matrix.py``,
``session.py``).  Reads the benchmark's ``CallTimer`` spans around the
model backend's ``score`` and ``score_matrix`` calls (below the batching
layer; each call returns host values, so its end is its device work's
end): the union of their intervals over the window's wall.  The rest is
generation, search and host.  Moves ``statements_per_s``.
"""

from bench_port.harness.trace import union_seconds

KINDS = ("score", "score_matrix")


def read(window):
    spans = [
        (max(lo, window.start), min(hi, window.end))
        for kind, lo, hi in window.spans
        if kind in KINDS and hi > window.start and lo < window.end
    ]
    if not spans or window.seconds <= 0:
        return None
    return 100.0 * union_seconds(spans) / window.seconds
