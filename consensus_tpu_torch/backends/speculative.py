"""Host-side draft proposal for speculative rollout verification (PyTorch
port of ``consensus_tpu/backends/speculative.py``, pure host code).

Score-only rollouts (``methods/finite_lookahead.py``, ``methods/mcts.py``)
pay one sequential decode step per rollout token, though the statement
under search is repetitive: the prompt restates the issue and opinions, and
MCTS re-rolls near-identical continuations from sibling leaves.  An n-gram
SELF-DRAFT proposer (Leviathan et al., speculative decoding; the draft
model is the request's own token history, so there is no second model)
guesses the next ``draft_len`` tokens from the longest recent n-gram match,
and the target model verifies the whole draft in ONE parallel forward
(``models/stepper.rollout_verify_many``).  Standard rejection -- accept the
matched prefix plus the first corrected token -- keeps accepted token
streams identical to the sequential rollout (totals agree to float
tolerance); a bad draft costs only the width of one parallel verify.

Deterministic by construction: the table is built from the observed token
stream only (insertion order resolves ties toward the MOST RECENT
occurrence), so identical requests draft identically.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class NGramProposer:
    """Longest-suffix n-gram table over an observed token-id stream."""

    def __init__(self, max_order: int = 3):
        self.max_order = max(1, int(max_order))
        #: Per order: suffix tuple -> next token id (latest occurrence wins).
        self._tables: List[Dict[Tuple[int, ...], int]] = [
            {} for _ in range(self.max_order)
        ]
        self._history: List[int] = []

    def observe(self, tokens: Sequence[int]) -> None:
        """Extend the history (prompt, trunk advances, accepted rollouts)."""
        for t in tokens:
            t = int(t)
            h = self._history
            for order in range(1, self.max_order + 1):
                if len(h) >= order:
                    self._tables[order - 1][tuple(h[-order:])] = t
            h.append(t)

    def _next(self, context: Sequence[int]) -> int:
        for order in range(min(self.max_order, len(context)), 0, -1):
            hit = self._tables[order - 1].get(tuple(context[-order:]))
            if hit is not None:
                return hit
        # No match anywhere: repeat the last token — a guess that is free
        # to be wrong (rejection discards it) but right surprisingly often
        # in list-ish consensus statements.
        return int(context[-1]) if context else 0

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        """Propose ``k`` tokens continuing ``context`` (not yet observed
        tokens included by the caller).  Drafted tokens chain: token j is
        looked up against context + draft[:j]."""
        ctx = [int(t) for t in context]
        out: List[int] = []
        for _ in range(max(0, int(k))):
            nxt = self._next(ctx)
            out.append(nxt)
            ctx.append(nxt)
        return out
