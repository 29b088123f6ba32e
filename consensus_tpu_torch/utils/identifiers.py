"""Method-identifier strings joining generation and evaluation rows (the
port's copy of ``consensus_tpu/utils/identifiers.py``).

Identifiers look like ``"best_of_n (n=10) [seed=42]"`` with parameters
sorted for stability, and only the allow-listed parameters participate;
``parse_method_identifier`` inverts them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple, Union

# Parameters that distinguish method variants in result keys.
# Reference: src/utils.py:9-16 (duplicated at improved_aggregation.py:20-23).
IMPORTANT_PARAMETERS = [
    "n",
    "num_candidates",
    "num_rounds",
    "branching_factor",
    "max_depth",
    "beam_width",
]

_SEED_RE = re.compile(r"\s*\[seed=(\d+)\]")
_PARAMS_RE = re.compile(r"\((.*?)\)")


def create_method_identifier(
    method_name: str,
    params_dict: Optional[Dict[str, Any]] = None,
    include_seed: bool = False,
    seed_value: Optional[Union[int, str]] = None,
) -> str:
    """Build ``"method (k=v, ...) [seed=s]"`` keys (reference src/utils.py:19-62)."""
    method_id = method_name

    if params_dict:
        parts = []
        for key, value in params_dict.items():
            name = key[len("param_"):] if key.startswith("param_") else key
            if name in IMPORTANT_PARAMETERS and value is not None:
                # CSV round-trips turn ints into floats; keep keys stable.
                if isinstance(value, float) and value.is_integer():
                    value = int(value)
                parts.append(f"{name}={value}")
        if parts:
            method_id = f"{method_id} ({', '.join(sorted(parts))})"

    if include_seed and seed_value is not None:
        method_id = f"{method_id} [seed={seed_value}]"

    return method_id


def _coerce_scalar(value: str) -> Any:
    """Parse a parameter value back to int/float where possible."""
    try:
        as_float = float(value)
    except ValueError:
        return value
    if as_float.is_integer():
        return int(as_float)
    return as_float


def parse_method_identifier(method_key: str) -> Tuple[str, Dict[str, Any], Optional[int]]:
    """Invert :func:`create_method_identifier`.

    Returns ``(base_method, params, seed)`` where ``params`` maps bare
    parameter names to coerced values.  Mirrors the parsing behaviour of
    reference ``src/evaluation.py:929-967``.
    """
    seed: Optional[int] = None
    seed_match = _SEED_RE.search(method_key)
    if seed_match:
        seed = int(seed_match.group(1))
        method_key = _SEED_RE.sub("", method_key)

    params: Dict[str, Any] = {}
    param_match = _PARAMS_RE.search(method_key)
    if param_match:
        for item in param_match.group(1).split(","):
            item = item.strip()
            if "=" in item:
                key, value = item.split("=", 1)
                params[key.strip()] = _coerce_scalar(value.strip())
        base = method_key[: param_match.start()].strip()
    else:
        base = method_key.strip()

    return base, params, seed


def normalize_method_name(method_name: str) -> str:
    """Strip ``[seed=...]`` suffixes (reference improved_aggregation.py:56-76)."""
    if not method_name:
        return "unknown"
    return _SEED_RE.sub("", method_name).strip()
