"""k2_ms_per_launch: device time of one K2 (decode attention) launch, in ms.

Layer: Kernel K2 (``ops/decode_attention.py``, ``csrc/decode_attention.cu``).
Reads the device trace's kernels named ``decode_attention_kernel`` over the
traced window, over the launches the program counted there
(``kernel_launches_total{kernel="decode_attention"}``).  Moves
``statements_per_s``: K2 is the attention of every decode step and search
advance.
"""

from bench_port.harness.trace import kernel_ms_per_launch


def read(window):
    return kernel_ms_per_launch(window, "decode_attention_kernel", "decode_attention")
