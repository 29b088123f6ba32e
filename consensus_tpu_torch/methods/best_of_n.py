"""Best-of-N: sequence-level egalitarian search, fully batched.

Reference: ``src/methods/best_of_n.py`` (SURVEY §2.3).  Same semantics —
generate N full candidates from the reference prompt with seeds
``seed + i``, score every (candidate × agent) pair as the mean logprob of
the candidate under the agent-conditioned policy, sanitize, take the
max-min (egalitarian) candidate — but the reference's ~N + N×A sequential
API calls become exactly TWO backend calls: one batched ``generate`` and
one batched ``score`` whose (N × A) requests a device backend executes as
a single padded forward.

Scoring layout parity (reference best_of_n.py:282-293): the agent context
(system + opinion prompt) conditions, the candidate text is the scored
continuation; utility = mean over candidate-token logprobs, default −10.0
on failure (:22,314).  Welfare: min across agents with NaN→−10 / ±inf→±20
sanitization (:23-24,380-389).  ``beta`` is accepted-but-unused, as in the
reference (SURVEY §7.4).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.prompts import agent_prompt, clean_statement, reference_prompt
from consensus_tpu_torch.ops.welfare import (
    DEFAULT_REWARD,
    egalitarian_welfare,
    sanitize_utilities,
)


class BestOfNGenerator(BaseGenerator):
    method_name = "best_of_n"

    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        cfg = self.config
        # Config key ``num_best_of_n`` preferred over ``n`` (reference :60-62).
        n_full = int(cfg.get("num_best_of_n", cfg.get("n", 3)))
        clock = self.budget_clock
        # Brownout shrinks N; seeds stay ``seed + i`` so the scaled run is
        # a strict prefix of the full candidate set.
        n = clock.scale_int(n_full)
        max_tokens = int(cfg.get("max_tokens", 50))
        temperature = float(cfg.get("temperature", 1.0))
        seed = self.seed

        if clock.expired():
            return self._degrade()
        candidates = self._generate_candidates(
            issue, agent_opinions, n, max_tokens, temperature, seed
        )
        if not candidates:
            return "[ERROR: Failed to generate any candidates]"
        # First anytime checkpoint: an unscored candidate beats a 504.
        self._checkpoint(
            candidates[0],
            checkpoint="generated",
            candidates_generated=len(candidates),
            candidates_scored=0,
            n_planned=n_full,
        )
        if clock.expired():
            return self._degrade()

        utilities = self.score_candidates(issue, agent_opinions, candidates)
        welfare = egalitarian_welfare(sanitize_utilities(utilities), axis=1)
        best = int(np.argmax(np.asarray(welfare)))
        self._checkpoint(
            candidates[best],
            welfare=float(np.asarray(welfare)[best]),
            checkpoint="scored",
            candidates_generated=len(candidates),
            candidates_scored=len(candidates),
            n_planned=n_full,
        )
        if n < n_full:
            self._mark_scaled(n_used=n, n_planned=n_full)
        return candidates[best]

    # -- steps ---------------------------------------------------------------

    def _generate_candidates(
        self,
        issue: str,
        agent_opinions: Dict[str, str],
        n: int,
        max_tokens: int,
        temperature: float,
        seed,
    ) -> List[str]:
        system, user = reference_prompt(issue, agent_opinions)
        requests = [
            GenerationRequest(
                user_prompt=user,
                system_prompt=system,
                max_tokens=max_tokens,
                temperature=temperature,
                seed=(seed + i) if seed is not None else None,
                chat=True,
            )
            for i in range(n)
        ]
        results = self.backend.generate(requests)
        candidates = []
        for result in results:
            if not result.ok:
                continue
            cleaned = clean_statement(result.text)
            if cleaned:
                candidates.append(cleaned)
        return candidates

    def score_candidates(
        self, issue: str, agent_opinions: Dict[str, str], candidates: List[str]
    ) -> np.ndarray:
        """(num_candidates, num_agents) mean-logprob utility matrix.

        Default path (``matrix_scoring``, on unless configured off): ONE
        utility-matrix call through the score_matrix seam — a fused
        on-device program on backends that have one, or the byte-identical
        batched per-call fallback otherwise.  ``matrix_scoring: false``
        keeps the original flattened per-call score batch."""
        agents = list(agent_opinions.items())
        if bool(self.config.get("matrix_scoring", True)):
            from consensus_tpu_torch.backends.score_matrix import (
                AgentContext,
                ScoreMatrixRequest,
                score_matrix_many,
            )

            contexts = []
            for _, opinion in agents:
                system, user = agent_prompt(issue, opinion)
                contexts.append(
                    AgentContext(context=user, system_prompt=system, chat=True)
                )
            result = score_matrix_many(
                self.backend,
                [
                    ScoreMatrixRequest(
                        agents=tuple(contexts),
                        candidates=tuple(candidates),
                        stat="mean",
                        default=DEFAULT_REWARD,
                    )
                ],
            )[0]
            return np.asarray(result.utilities, dtype=np.float32).reshape(
                len(candidates), len(agents)
            )
        requests = []
        for candidate in candidates:
            for _, opinion in agents:
                system, user = agent_prompt(issue, opinion)
                requests.append(
                    ScoreRequest(
                        context=user,
                        continuation=candidate,
                        system_prompt=system,
                        chat=True,
                    )
                )
        results = self.backend.score(requests)
        means = [r.mean(default=DEFAULT_REWARD) for r in results]
        return np.asarray(means, dtype=np.float32).reshape(
            len(candidates), len(agents)
        )
