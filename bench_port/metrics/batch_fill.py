"""batch_fill: mean sessions merged into one device batch over the window.

Layer: Batching (``backends/batching.py``).  Reads the program's
``batching_batch_fill_sessions`` histogram (every kind), as the registry's
count and sum diffed over the window.  Moves ``statements_per_s``: fuller
batches share each device call among more statements.
"""

FAMILY = "batching_batch_fill_sessions"


def read(window):
    count = total = 0.0
    for (family, _), value in window.registry.items():
        if family == FAMILY:
            count += value["count"]
            total += value["sum"]
    return total / count if count else None
