"""Schulze-method preference aggregation (vectorized numpy).

The PyTorch port's own copy of ``consensus_tpu/social_choice/schulze.py`` (pure
numpy; the port imports nothing of the JAX package).

Behaviour parity with the reference implementation in
``src/methods/habermas_machine.py:985-1260`` (itself adapted from Google's
Habermas Machine code), but written as vectorized array programs rather than
quadruple Python loops: pairwise defeats are one broadcast comparison, the
Floyd–Warshall widest-path sweep is vectorized per intermediate candidate.
Semantics (including tie handling, dominance-count ranking, and seeded
random-ballot tie-breaking) are identical and pinned by the electowiki golden
tests in ``tests/test_social_choice.py``.

Rank convention throughout: lower is better, 0 is best, ties allowed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np


def validate_rankings(rankings: np.ndarray) -> None:
    """Shape/dtype/range checks (reference habermas_machine.py:1030-1045)."""
    if rankings.ndim != 2:
        raise ValueError(
            f"Rankings should be 2D [num_voters, num_candidates], got shape {rankings.shape}"
        )
    if not np.issubdtype(rankings.dtype, np.integer):
        raise ValueError(f"Rankings should be integers, got {rankings.dtype}")
    num_candidates = rankings.shape[1]
    bad = (rankings < 0) | (rankings >= num_candidates)
    if np.any(bad):
        raise ValueError(
            f"Ranks must be between 0 and {num_candidates - 1}. "
            f"Found invalid rank: {rankings[bad][0]}"
        )


def compute_pairwise_defeats(rankings: np.ndarray) -> np.ndarray:
    """d[i, j] = #voters preferring candidate i to candidate j.

    Reference habermas_machine.py:1048-1069, vectorized: a single broadcast
    ``rank_i < rank_j`` comparison summed over the voter axis.
    """
    rankings = np.asarray(rankings)
    # (voters, cand, 1) < (voters, 1, cand) -> (voters, cand, cand)
    prefers = rankings[:, :, None] < rankings[:, None, :]
    return prefers.sum(axis=0).astype(np.int32)


def _check_square_zero_diag(matrix: np.ndarray, name: str) -> None:
    if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"{name} should be a square array, got shape {matrix.shape}")
    if np.any(np.diag(matrix) != 0):
        raise ValueError(f"{name} should have an all zero diagonal.")


def compute_strongest_paths(pairwise_defeats: np.ndarray) -> np.ndarray:
    """Widest-path strengths p[i, j] via Floyd–Warshall.

    Reference habermas_machine.py:1072-1120.  Initial strength is d[i, j]
    where i beats j head-to-head, else 0; the relaxation
    ``p[j,k] = max(p[j,k], min(p[j,i], p[i,k]))`` runs vectorized over (j, k)
    for each intermediate i (p[i,i] = 0 makes self-loops inert).
    """
    _check_square_zero_diag(pairwise_defeats, "pairwise_defeats")
    d = np.asarray(pairwise_defeats)
    p = np.where(d > d.T, d, 0).astype(d.dtype)
    np.fill_diagonal(p, 0)

    n = p.shape[0]
    for via in range(n):
        np.maximum(p, np.minimum(p[:, via : via + 1], p[via : via + 1, :]), out=p)
    np.fill_diagonal(p, 0)
    return p


def rank_from_path_strengths(path_strengths: np.ndarray) -> np.ndarray:
    """Dominance-count social ranking with ties (reference :1123-1160).

    Candidate i is at least as good as j iff p[i, j] >= p[j, i]; candidates
    are ranked by how many others they weakly dominate (more is better).
    """
    _check_square_zero_diag(path_strengths, "path_strengths")
    p = np.asarray(path_strengths)
    dominance_count = (p >= p.T).sum(axis=1)
    _, social_ranking = np.unique(-dominance_count, return_inverse=True)
    return social_ranking


def schulze_social_ranking(rankings: np.ndarray) -> np.ndarray:
    """End-to-end Schulze aggregation, ties allowed (reference :1163-1178)."""
    rankings = np.asarray(rankings)
    validate_rankings(rankings)
    return rank_from_path_strengths(
        compute_strongest_paths(compute_pairwise_defeats(rankings))
    )


# --- Tie handling helpers (reference habermas_machine.py:992-1024) ---


def normalize_ranking(ranking: np.ndarray) -> np.ndarray:
    """Compress ranks to consecutive integers: [0, 2, 5, 5] -> [0, 1, 2, 2]."""
    ranking = np.asarray(ranking)
    if ranking.ndim != 1:
        raise ValueError("The input array should be a single ranking so `ndim=1`")
    _, normalized = np.unique(ranking, return_inverse=True)
    return normalized


def is_untied(ranking: np.ndarray) -> bool:
    ranking = np.asarray(ranking)
    if ranking.ndim != 1:
        raise ValueError("The input array should be a single ranking so `ndim=1`")
    return np.unique(ranking).size == ranking.size


def untie_with_ballot(ranking: np.ndarray, ballot: np.ndarray) -> np.ndarray:
    """Break ties with an auxiliary ballot, preserving the existing order.

    Scaling the normalized ranking by the candidate count guarantees the
    ballot only reorders within tie groups (reference :1007-1024).
    """
    ranking = np.asarray(ranking)
    ballot = np.asarray(ballot)
    if ranking.ndim != 1:
        raise ValueError("The input array should be a single ranking so `ndim=1`")
    if ranking.shape != ballot.shape:
        raise ValueError("The ranking and ballot should have the same shape.")
    combined = normalize_ranking(ranking) * len(ranking) + normalize_ranking(ballot)
    return normalize_ranking(combined)


def aggregate_schulze(
    agent_rankings: Mapping[str, Optional[np.ndarray]],
    num_candidates: int,
    seed: Optional[int] = None,
    tie_breaking_method: str = "random",
) -> Optional[np.ndarray]:
    """Aggregate per-agent rank arrays; optionally break ties with a seeded
    random ballot (reference habermas_machine.py:1181-1260).

    Agents whose ranking failed (``None``) are dropped; returns ``None`` when
    no valid ranking remains or shapes are inconsistent.
    """
    valid = [np.asarray(r) for r in agent_rankings.values() if r is not None]
    if not valid:
        return None

    try:
        stacked = np.stack(valid, axis=0)
    except ValueError:
        return None
    if stacked.shape[1] != num_candidates:
        return None

    try:
        tied = schulze_social_ranking(stacked)
    except ValueError:
        return None

    if tie_breaking_method == "ties_allowed" or is_untied(tied):
        return tied
    if tie_breaking_method == "random":
        rng = np.random.default_rng(seed)
        ballot = rng.permutation(num_candidates).astype(np.int32)
        return untie_with_ballot(tied, ballot)
    # Unknown tie-breaking method: return the tied ranking unchanged.
    return tied
