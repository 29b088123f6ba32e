"""Welfare-gap tables: the social-choice analogue of a numerics golden (the
port of ``consensus_tpu/data/scenarios/fairness.py``).

For one scenario and a fixed candidate slate, score the full
(candidates × agents) utility matrix through the port's score-matrix seam
(``backends/score_matrix.py``, ``stat="moments"``, so one dispatch yields
BOTH channels: on ``TorchBackend`` the fused matrix) and reduce it under
every welfare rule:

* ``mean_logprob`` channel — the matrix's primary utilities, the exact
  quantity best-of-N/beam select on.  Log-Nash is degenerate here (all
  utilities are negative, so ``log(max(u, eps))`` is constant) — the
  table records it but the separation assertions use the prob channel.
* ``mean_prob`` channel — the moments aux (mean per-token probability,
  strictly positive), the evaluator's ``*_avg_prob`` convention where
  log-Nash is the geometric-mean rule it was designed to be.

The table pins, per rule: the winning candidate, the welfare vector, the
winner's worst-off-agent utility, and the egalitarian **price** of each
rule (egalitarian welfare lost by following that rule's winner instead
of the egalitarian one — ≥ 0 by construction, 0 iff the rules agree).
The JAX package pins these tables as regression goldens
(``tests/golden/fairness/``); the port's tests hold its tables against
the JAX package's live output on the same weights."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.score_matrix import (
    AgentContext,
    ScoreMatrixRequest,
    score_matrix_many,
    welfare_argmax,
)
from consensus_tpu_torch.methods.prompts import (
    agent_prompt,
    clean_statement,
    reference_prompt,
)
from consensus_tpu_torch.ops.welfare import WELFARE_RULES

RULES = tuple(sorted(WELFARE_RULES))

#: Fixed candidate slate for the big (500-agent) scenarios.  Generating a
#: slate there would push the full 500-opinion reference prompt through
#: the backend; the welfare-gap table only needs a diverse set of
#: positions to rank, so a pinned slate keeps the golden independent of
#: the generation path and its context limits.
BIG_SLATE = (
    "We will pilot the proposal for one year with an independent audit "
    "and a guaranteed sunset clause.",
    "We should adopt the proposal immediately and at full scale.",
    "We should reject the proposal outright.",
    "We need more evidence before deciding, so we commit only to a "
    "small trial.",
)


def candidate_statements(
    backend,
    scenario: Dict[str, Any],
    n: int = 6,
    max_tokens: int = 24,
    seed: int = 0,
    temperature: float = 1.0,
) -> List[str]:
    """A deterministic candidate slate for ``scenario``: ``n`` sampled
    consensus statements from the reference (all-opinions) policy, the
    same prompt best-of-N generates from."""
    system, user = reference_prompt(
        scenario["issue"], scenario["agent_opinions"])
    requests = [
        GenerationRequest(
            user_prompt=user,
            system_prompt=system,
            max_tokens=max_tokens,
            temperature=temperature,
            seed=seed + i,
            chat=True,
        )
        for i in range(n)
    ]
    candidates = []
    for result in backend.generate(requests):
        text = clean_statement(result.text) if result.ok else ""
        candidates.append(text or f"(empty candidate {len(candidates)})")
    return candidates


def agent_contexts(scenario: Dict[str, Any]) -> List[AgentContext]:
    contexts = []
    for _, opinion in sorted(scenario["agent_opinions"].items()):
        system, user = agent_prompt(scenario["issue"], opinion)
        contexts.append(
            AgentContext(context=user, system_prompt=system, chat=True))
    return contexts


def _channel_table(utilities: np.ndarray, ndigits: int) -> Dict[str, Any]:
    winners: Dict[str, int] = {}
    welfare: Dict[str, List[float]] = {}
    min_agent: Dict[str, float] = {}
    for rule in RULES:
        values, best = welfare_argmax(utilities, rule)
        winners[rule] = best
        welfare[rule] = [round(float(v), ndigits) for v in values]
        min_agent[rule] = round(float(np.min(utilities[best])), ndigits)
    egal = np.asarray(welfare["egalitarian"], dtype=np.float64)
    gaps = {
        # Egalitarian welfare forfeited by following each rule's winner —
        # the min-agent price of utilitarian/log-Nash selection.
        f"egalitarian_price_of_{rule}": round(
            float(egal[winners["egalitarian"]] - egal[winners[rule]]),
            ndigits,
        )
        for rule in RULES
    }
    return {
        "winners": winners,
        "welfare": welfare,
        "min_agent_utility": min_agent,
        "gaps": gaps,
        "rules_separated": len(set(winners.values())) > 1,
    }


def welfare_gap_table(
    backend,
    scenario: Dict[str, Any],
    candidates: Optional[Sequence[str]] = None,
    n_candidates: int = 6,
    max_tokens: int = 24,
    seed: int = 0,
    ndigits: int = 6,
) -> Dict[str, Any]:
    """Score ``scenario`` on ``backend`` through the score-matrix path and
    reduce both utility channels under every welfare rule."""
    if candidates is None:
        candidates = candidate_statements(
            backend, scenario, n=n_candidates, max_tokens=max_tokens,
            seed=seed,
        )
    request = ScoreMatrixRequest(
        agents=tuple(agent_contexts(scenario)),
        candidates=tuple(candidates),
        stat="moments",
        welfare_rule="egalitarian",
    )
    result = score_matrix_many(backend, [request])[0]
    logprob = np.asarray(result.utilities, dtype=np.float64)
    prob = np.asarray(result.aux, dtype=np.float64)
    return {
        "scenario_id": scenario.get("id", ""),
        "family": scenario.get("family", ""),
        "n_agents": len(request.agents),
        "n_candidates": len(candidates),
        "matrix_path": result.path,
        "channels": {
            "mean_logprob": _channel_table(logprob, ndigits),
            "mean_prob": _channel_table(prob, ndigits),
        },
    }


def separated_families(tables: Sequence[Dict[str, Any]],
                       channel: str = "mean_prob") -> List[str]:
    """Families on which the welfare rules disagree about the winner."""
    out = []
    for table in tables:
        if table["channels"][channel]["rules_separated"]:
            out.append(table["family"])
    return sorted(set(out))
