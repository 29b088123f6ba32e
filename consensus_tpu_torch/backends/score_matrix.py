"""The (candidates x agents) utility-matrix scoring seam (PyTorch port of
``consensus_tpu/backends/score_matrix.py``).

``score_matrix_many`` routes to ``backend.score_matrix`` when the backend
has one, else to :func:`fallback_score_matrix_many`: build the per-call
``ScoreRequest`` rows (candidate-major, agent-minor), dedup them, issue ONE
batched ``backend.score`` call and reduce each cell with the exact host
expressions the per-call consumers used.  ``TorchBackend.score_matrix``
is the fused path and falls back here per matrix; best-of-N and the
evaluator's ``stat="moments"`` utilities both come through this seam.
Every matrix is recorded into the obs registry (``record_matrix``: cells,
D2H bytes, agents per call) and, when a server installed one, into the
welfare telemetry sink (``obs/welfare.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from consensus_tpu_torch.backends.base import PartialBatchError, ScoreRequest, ScoreResult
from consensus_tpu_torch.obs.welfare import get_welfare_sink
from consensus_tpu_torch.ops.welfare import (
    DEFAULT_REWARD,
    WELFARE_RULES,
    sanitize_utilities,
)

_STATS = ("mean", "sum", "last", "moments")


@dataclasses.dataclass(frozen=True)
class AgentContext:
    """One agent's scoring context -- a ScoreRequest minus the continuation."""

    context: str
    system_prompt: Optional[str] = None
    chat: bool = True
    role: str = "assistant"

    def to_score_request(self, continuation: str) -> ScoreRequest:
        return ScoreRequest(
            context=self.context,
            continuation=continuation,
            system_prompt=self.system_prompt,
            chat=self.chat,
            role=self.role,
        )


@dataclasses.dataclass(frozen=True)
class ScoreMatrixRequest:
    """Score every candidate under every agent context in one call."""

    agents: Tuple[AgentContext, ...]
    candidates: Tuple[str, ...]
    stat: str = "mean"
    welfare_rule: str = "egalitarian"
    default: float = DEFAULT_REWARD

    def __post_init__(self) -> None:
        if self.stat not in _STATS:
            raise ValueError(f"unknown stat {self.stat!r}; want one of {_STATS}")
        if self.welfare_rule not in WELFARE_RULES:
            raise ValueError(
                f"unknown welfare rule {self.welfare_rule!r}; "
                f"want one of {tuple(WELFARE_RULES)}"
            )

    def cell_requests(self) -> List[ScoreRequest]:
        """The per-call rows, candidate-major and agent-minor."""
        return [
            agent.to_score_request(candidate)
            for candidate in self.candidates
            for agent in self.agents
        ]


@dataclasses.dataclass(frozen=True, eq=False)
class ScoreMatrixResult:
    """(C, A) utilities + the welfare reduction; ``best`` is numpy's
    first-max argmax of ``welfare``."""

    utilities: np.ndarray
    welfare: np.ndarray
    best: int
    aux: Optional[np.ndarray] = None
    cells: int = 0
    d2h_bytes: int = 0
    path: str = "fallback"


def _cell_stat(result: ScoreResult, stat: str, default: float):
    if stat == "mean":
        return result.mean(default=default)
    if stat == "sum":
        return float(sum(result.logprobs)) if result.ok else default
    if stat == "last":
        return float(result.logprobs[-1]) if result.ok else default
    lps = np.asarray(result.logprobs, dtype=np.float64)
    avg_lp = float(lps.mean()) if lps.size else default
    avg_p = float(np.exp(lps).mean()) if lps.size else 0.0
    return avg_lp, avg_p


def reduce_matrix(
    request: ScoreMatrixRequest, results: Sequence[ScoreResult], *, path: str
) -> ScoreMatrixResult:
    """Fold per-cell ScoreResults into a ScoreMatrixResult."""
    n_candidates = len(request.candidates)
    n_agents = len(request.agents)
    values: List[float] = []
    aux_values: List[float] = []
    d2h = 0
    for result in results:
        d2h += len(result.logprobs) * 8
        cell = _cell_stat(result, request.stat, request.default)
        if request.stat == "moments":
            values.append(cell[0])
            aux_values.append(cell[1])
        else:
            values.append(cell)
    utilities = np.asarray(values, dtype=np.float64).reshape(n_candidates, n_agents)
    aux = (
        np.asarray(aux_values, dtype=np.float64).reshape(n_candidates, n_agents)
        if request.stat == "moments"
        else None
    )
    welfare_vals, best = welfare_argmax(utilities, request.welfare_rule)
    return ScoreMatrixResult(
        utilities=utilities,
        welfare=welfare_vals,
        best=best,
        aux=aux,
        cells=n_candidates * n_agents,
        d2h_bytes=d2h,
        path=path,
    )


def welfare_argmax(utilities: np.ndarray, rule: str) -> Tuple[np.ndarray, int]:
    """sanitize -> welfare over the agent axis -> first-max argmax."""
    if utilities.size == 0:
        return np.zeros((utilities.shape[0],), dtype=np.float32), 0
    welfare_vals = np.asarray(WELFARE_RULES[rule](sanitize_utilities(utilities), axis=1))
    return welfare_vals, int(np.argmax(welfare_vals))


def _score_key(request: ScoreRequest):
    return (
        request.context,
        request.continuation,
        request.system_prompt,
        request.chat,
        request.role,
    )


def dedup_score_requests(
    requests: Sequence[ScoreRequest],
) -> Tuple[List[ScoreRequest], List[int]]:
    """-> (unique, mapping) with ``requests[i] == unique[mapping[i]]``."""
    seen: Dict[tuple, int] = {}
    unique: List[ScoreRequest] = []
    mapping: List[int] = []
    for request in requests:
        key = _score_key(request)
        index = seen.get(key)
        if index is None:
            index = len(unique)
            seen[key] = index
            unique.append(request)
        mapping.append(index)
    return unique, mapping


def expand_deduped(values: Sequence, mapping: Sequence[int]) -> List:
    return [values[j] for j in mapping]


def expand_partial_error(
    error: PartialBatchError, mapping: Sequence[int]
) -> PartialBatchError:
    """Re-shape a PartialBatchError over unique rows back to caller rows:
    every caller row sharing a failed unique row fails the same way."""
    results = (
        expand_deduped(error.results, mapping)
        if error.results is not None
        else None
    )
    row_errors = {
        i: error.row_errors[j]
        for i, j in enumerate(mapping)
        if j in error.row_errors
    }
    return PartialBatchError(
        str(error) or "partial batch failure", results, row_errors
    )


# ---------------------------------------------------------------------------
# Observability (families are idempotent by name across backends).


def matrix_metrics(registry=None):
    from consensus_tpu_torch.obs.metrics import DEFAULT_COUNT_BUCKETS, get_registry

    reg = registry if registry is not None else get_registry()
    cells = reg.counter(
        "score_matrix_cells_total",
        "(candidate, agent) utility cells evaluated via the matrix seam",
    )
    d2h = reg.counter(
        "score_matrix_d2h_bytes_total",
        "bytes fetched device-to-host for matrix scoring results",
    )
    agents_hist = reg.histogram(
        "score_agents_per_call",
        "agent-axis width of score_matrix calls",
        buckets=DEFAULT_COUNT_BUCKETS,
    )
    return cells, d2h, agents_hist


def record_matrix(
    result: ScoreMatrixResult,
    n_agents: int,
    registry=None,
    welfare_rule: Optional[str] = None,
) -> None:
    cells, d2h, agents_hist = matrix_metrics(registry)
    cells.inc(result.cells)
    d2h.inc(result.d2h_bytes)
    agents_hist.observe(n_agents)
    # Welfare telemetry plane: when a server installed a sink, the chosen
    # candidate's welfare and worst-agent utility feed the score-path
    # sketches.  Off (the default) this is one global read.
    sink = get_welfare_sink()
    if sink is not None:
        sink.record_matrix(result, welfare_rule)


def fallback_score_matrix_many(
    backend, requests: Sequence[ScoreMatrixRequest]
) -> List[ScoreMatrixResult]:
    """Evaluate matrices through ONE batched ``backend.score`` call over the
    deduped rows of all of them."""
    all_rows: List[ScoreRequest] = []
    spans: List[Tuple[int, int]] = []
    for request in requests:
        rows = request.cell_requests()
        spans.append((len(all_rows), len(all_rows) + len(rows)))
        all_rows.extend(rows)
    if not all_rows:
        return [reduce_matrix(request, [], path="fallback") for request in requests]
    unique, mapping = dedup_score_requests(all_rows)
    results = expand_deduped(backend.score(unique), mapping)
    out = []
    for request, (lo, hi) in zip(requests, spans):
        matrix = reduce_matrix(request, results[lo:hi], path="fallback")
        record_matrix(matrix, len(request.agents), welfare_rule=request.welfare_rule)
        out.append(matrix)
    return out


def score_matrix_many(
    backend, requests: Sequence[ScoreMatrixRequest]
) -> List[ScoreMatrixResult]:
    """``backend.score_matrix`` when the backend has one, else the fallback."""
    fn = getattr(backend, "score_matrix", None)
    if callable(fn):
        return list(fn(list(requests)))
    return fallback_score_matrix_many(backend, requests)
