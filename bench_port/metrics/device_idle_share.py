"""device_idle_share: share of the traced window with no kernel on the card, in %.

Layer: Device (H100).  Reads the device trace: 1 - (union of the kernel
intervals) / (the traced window), the arithmetic of
``consensus_tpu_torch/cli/profile_search.py``, copied into
``bench_port/harness/trace.py``.  The traced window is the whole measured
window.  Moves ``statements_per_s``: the idle share is the host's hold on
the card.
"""


def read(window):
    if window.trace is None or window.trace.window_s <= 0 or not window.trace.kernels:
        return None
    return 100.0 * (1.0 - window.trace.busy_s() / window.trace.window_s)
