"""The work of the port's two hand-written kernels, counted from their shapes.

A copy of the arithmetic behind ``chip_smoke.py``'s "Bound ms" column
(``flash_bound``, ``decode_bound``): each input byte read once and each
output byte written once, over the HBM rate, against 4 * hd FLOPs (Q.K and
P.V) per (query, key, head) the masks keep, over the bf16 tensor-core rate.
A kernel's share of its roofline is its bound over its measured time.  No
metric reads these yet: a launch's shapes and spans are not recorded by the
program; a per-launch record would let a ``<kernel>_roofline`` metric read
them through these functions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

#: H100 SXM data-sheet peaks (dense): bf16 tensor-core rate and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def attention_pairs(lengths: Sequence[int], causal: bool = True, window: Optional[int] = None) -> int:
    """(query, key) pairs the masks keep."""
    total = 0
    for length in lengths:
        for i in range(length):
            keys = (i + 1) if causal else length
            total += keys if window is None else min(keys, window)
    return total


def flash_work(
    batch: int, seq: int, heads: int, kv_heads: int, hd: int, lengths: Sequence[int],
    causal: bool = True, window: Optional[int] = None, itemsize: int = 2,
) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K1 launch: o written in full; q, k and v read
    over each row's span; lengths and starts."""
    span_tokens = sum(lengths)
    nbytes = (
        batch * seq * heads * hd * itemsize
        + span_tokens * (heads + 2 * kv_heads) * hd * itemsize
        + 8 * batch
    )
    return 4 * hd * heads * attention_pairs(lengths, causal, window), nbytes


def decode_keys(w0: int, starts: Sequence[int], qpos: Sequence[int], write_col: int,
                window: Optional[int] = None) -> Tuple[list, int]:
    """(trunk keys per role, tail keys per row) the masks keep."""
    trunk = []
    for start, pos in zip(starts, qpos):
        lo = start if window is None else max(start, pos + start - window + 1)
        trunk.append(max(0, w0 - lo))
    tail_lo = 0 if window is None else max(0, write_col - window + 1)
    return trunk, write_col + 1 - tail_lo


def decode_work(
    n_slots: int, heads: int, kv: int, hd: int, w0: int, starts: Sequence[int],
    qpos: Sequence[int], write_col: int, window: Optional[int] = None,
) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K2 launch: q and out once, each role's trunk
    K/V over its kept span once (shared by the slots), each row's tail K/V
    over its kept columns, starts and qpos (bf16 tensors, int32 spans)."""
    trunk, tail = decode_keys(w0, starts, qpos, write_col, window)
    n_roles = len(starts)
    rows = n_slots * n_roles
    nbytes = 2 * (
        2 * rows * heads * hd + 2 * sum(trunk) * kv * hd + 2 * rows * tail * kv * hd
    ) + 8 * n_roles
    return 4 * hd * heads * n_slots * (sum(trunk) + n_roles * tail), nbytes


def bound_ms(flops: int, nbytes: int) -> Tuple[float, str]:
    """(the least time the card could take, in ms, and what bounds it)."""
    mem_ms = nbytes / PEAK_HBM_BYTES * 1e3
    op_ms = flops / PEAK_BF16_FLOPS * 1e3
    return (op_ms, "operations") if op_ms >= mem_ms else (mem_ms, "bytes")


def roofline_share(flops: int, nbytes: int, seconds: float) -> Optional[float]:
    """A launch's share of its roofline, in %: its bound over its time."""
    if seconds <= 0:
        return None
    return 100.0 * bound_ms(flops, nbytes)[0] / (seconds * 1e3)
