"""Token-level divergence reports for parity assertions (PyTorch port of
``consensus_tpu/utils/diff.py``).

A bare list-equality assert answers *whether* two runs agree but not
*where*, and the failure worth diagnosing is a reduction-order flip of ONE
greedy argmax at ONE position (the card against the CPU, one row bucket
against another, the port against the JAX package).  These helpers name
the first diverging row/position/token with surrounding context, so a
parity failure reads as "row 3, token 17: 'transport' vs 'transit'"
instead of a 2x32-statement dump.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence


def first_divergence(a: Sequence, b: Sequence) -> Optional[int]:
    """Index of the first position where ``a`` and ``b`` differ (length
    difference counts, at ``min(len)``); None when identical."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    if len(a) != len(b):
        return min(len(a), len(b))
    return None


def _window(tokens: Sequence, index: int, context: int) -> str:
    lo = max(0, index - context)
    parts = [repr(t) for t in tokens[lo : index + context + 1]]
    if lo > 0:
        parts.insert(0, "...")
    if index + context + 1 < len(tokens):
        parts.append("...")
    return "[" + ", ".join(parts) + "]"


def token_diff_message(
    a: Sequence,
    b: Sequence,
    label_a: str = "a",
    label_b: str = "b",
    context: int = 3,
) -> Optional[str]:
    """None when the sequences match; else which position/token diverged,
    with a few tokens of context on each side."""
    index = first_divergence(a, b)
    if index is None:
        return None
    tok_a = repr(a[index]) if index < len(a) else "<end of sequence>"
    tok_b = repr(b[index]) if index < len(b) else "<end of sequence>"
    return (
        f"first divergence at token {index}: "
        f"{label_a}={tok_a} vs {label_b}={tok_b} "
        f"(lengths {len(a)} vs {len(b)}); "
        f"{label_a} context {_window(a, index, context)}, "
        f"{label_b} context {_window(b, index, context)}"
    )


def _pseudo_tokens(text: str) -> List[str]:
    """Whitespace-preserving split (FakeBackend's pseudo-tokenizer rule) —
    the fallback granularity when real token ids aren't available."""
    return re.findall(r"\s*\S+", str(text))


def statement_parity_report(
    statements_a: Sequence[str],
    statements_b: Sequence[str],
    label_a: str = "a",
    label_b: str = "b",
) -> Optional[str]:
    """Row-by-row statement parity with token-granular diagnosis.

    Returns None when every row matches; else a report naming each
    diverging row and, within it, the first diverging token position."""
    lines: List[str] = []
    if len(statements_a) != len(statements_b):
        lines.append(
            f"row count differs: {label_a} has {len(statements_a)}, "
            f"{label_b} has {len(statements_b)}"
        )
    for row, (text_a, text_b) in enumerate(zip(statements_a, statements_b)):
        if text_a == text_b:
            continue
        diff = token_diff_message(
            _pseudo_tokens(text_a), _pseudo_tokens(text_b), label_a, label_b
        )
        lines.append(f"row {row}: {diff}")
    if not lines:
        return None
    return (
        f"statement parity failure ({label_a} vs {label_b}, "
        f"{len(lines)} diverging row(s)):\n  " + "\n  ".join(lines)
    )


def generation_parity_report(
    results_a: Sequence,
    results_b: Sequence,
    label_a: str = "a",
    label_b: str = "b",
) -> Optional[str]:
    """Parity report over two lists of ``GenerationResult``.

    Diffs at true token-id granularity when both sides carry token_ids
    (the resident backend always does); falls back to whitespace pseudo-tokens
    of the text otherwise."""
    lines: List[str] = []
    if len(results_a) != len(results_b):
        lines.append(
            f"result count differs: {label_a} has {len(results_a)}, "
            f"{label_b} has {len(results_b)}"
        )
    for row, (res_a, res_b) in enumerate(zip(results_a, results_b)):
        if res_a.text == res_b.text and tuple(res_a.token_ids) == tuple(
            res_b.token_ids
        ):
            continue
        ids_a, ids_b = tuple(res_a.token_ids), tuple(res_b.token_ids)
        if ids_a or ids_b:
            diff = token_diff_message(ids_a, ids_b, label_a, label_b)
            if diff is None:  # same ids but different text (decode drift)
                diff = token_diff_message(
                    _pseudo_tokens(res_a.text), _pseudo_tokens(res_b.text),
                    label_a, label_b,
                )
        else:
            diff = token_diff_message(
                _pseudo_tokens(res_a.text), _pseudo_tokens(res_b.text),
                label_a, label_b,
            )
        lines.append(f"row {row}: {diff}")
    if not lines:
        return None
    return (
        f"generation parity failure ({label_a} vs {label_b}, "
        f"{len(lines)} diverging row(s)):\n  " + "\n  ".join(lines)
    )
