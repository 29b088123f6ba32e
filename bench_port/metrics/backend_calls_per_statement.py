"""backend_calls_per_statement: the model backend's calls per statement.

Layer: Method (``methods/best_of_n.py``, ``beam_search.py``,
``brushup.py``).  Reads ``TorchBackend.call_counts`` (every key: request
rows of generate / score / score_matrix / next_token / embed, score
batches, search advances) diffed over the window, over the statements
completed in it.  Moves ``statements_per_s``: fewer calls a statement, less
host work and fewer dispatches.
"""


def read(window):
    done = sum(1 for s in window.statements if s.ok)
    return sum(window.call_counts.values()) / done if done else None
