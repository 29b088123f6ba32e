"""Finite-lookahead (receding-horizon) token decoder over a trunk session
(PyTorch port of ``consensus_tpu/methods/finite_lookahead.py``).

Reference: ``src/methods/finite_lookahead.py``.  Semantics preserved:

* outer loop emits ONE token per iteration up to ``max_tokens``;
* each iteration grows a ``branching_factor``-ary lookahead tree of depth
  ``max_depth`` from the reference policy continuing the current statement;
  terminator tokens end a path early; duplicate paths are dropped;
* each distinct path is scored per agent as the MEAN logprob of the path's
  tokens under the agent-conditioned policy, and the egalitarian (max-min)
  path wins.  By the chain rule the path mean equals the mean of the
  per-token logprobs collected as the tree grows, which is how the session
  delivers them -- token t's agent score comes out of the same forward that
  proposed it;
* only the best path's FIRST token is appended; emission stops when that
  token is a terminator.

The whole statement runs through ONE trunk session (``backends/session.py``):
the trunk (prompt + statement so far) lives in an (agents+1)-row KV cache,
each tree LEVEL is one call whose path suffixes attend the SHARED trunk
(``transformer.forward_shared_trunk``), and advancing the trunk by the
chosen token is one more step.  Optional leaf rollouts (``rollout_depth >
0``): every surviving leaf continues ``rollout_depth`` reference-policy
tokens in ONE ``rollout_many`` call per emitted token, and ranking takes
the max-min mean logprob over path + rollout; ``speculative_rollouts``
verifies n-gram drafts of those rollouts instead of decoding them step by
step, with the same token streams.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from consensus_tpu_torch.backends.session import (
    ScoredCandidate,
    SearchSpec,
    open_token_search,
)
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.beam_search import BIAS_AGAINST_TOKENS
from consensus_tpu_torch.methods.brushup import brushup_statement_ending
from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt

#: Tokens that terminate a lookahead path / the whole statement
#: (reference finite_lookahead.py:141-144, 350-355).
TERMINATOR_TOKENS = frozenset(
    {"DONE", "\n", "\n\n", ".\n\n", "<|eot_id|>", "<|end_of_text|>",
     "<end_of_turn>", "<eos>"}
)

#: A tree path: its candidates in order + running per-agent logprob sums.
Path = Tuple[List[ScoredCandidate], List[float]]


class FiniteLookaheadGenerator(BaseGenerator):
    method_name = "finite_lookahead"

    def generate_statement(self, issue: str, agent_opinions: dict) -> str:
        cfg = self.config
        clock = self.budget_clock
        branching = int(cfg.get("branching_factor", 2))
        max_depth_full = int(cfg.get("max_depth", 3))
        # Brownout shrinks the lookahead horizon; a shallower tree is still
        # a valid receding-horizon policy, just more myopic.
        max_depth = clock.scale_int(max_depth_full)
        max_tokens = int(cfg.get("max_tokens", 50))
        temperature = float(cfg.get("temperature", 1.0))
        # Leaf value-estimate rollouts (0 = off): each surviving frontier
        # leaf continues ``rollout_depth`` reference-policy tokens in ONE
        # rollout_many call per emitted token.
        rollout_depth = max(0, int(cfg.get("rollout_depth", 0)))
        # pin_budget (the timing mode): no terminator may end the statement
        # or a path early -- the tree runs its full budget.
        terminators = frozenset() if cfg.get("pin_budget") else TERMINATOR_TOKENS
        seed = self.seed

        agents = list(agent_opinions.items())
        if not agents:
            return ""
        if clock.expired():
            return self._degrade()

        system, user = reference_prompt(issue, agent_opinions, variant="finite_lookahead")
        agent_prompts = tuple(
            agent_prompt(issue, opinion, variant="finite_lookahead") for _, opinion in agents
        )
        session = open_token_search(
            self.backend,
            SearchSpec(
                ref_system=system,
                ref_user=user,
                agent_prompts=agent_prompts,
                n_slots=1,  # trunk session: the tree shares the trunk cache
                k=branching,
                temperature=temperature,
                seed=seed,
                sample=True,
                bias_against_tokens=BIAS_AGAINST_TOKENS,
                max_steps=max_tokens,
                speculative=bool(cfg.get("speculative_rollouts", False)),
                spec_draft_len=int(cfg.get("spec_draft_len", rollout_depth or 8)),
                matrix_scoring=bool(cfg.get("matrix_scoring", True)),
            ),
        )

        statement = ""
        degraded_exit = False
        try:
            root_proposals = session.propose()[0]
            for step in range(max_tokens):
                best = self._best_path(
                    session, root_proposals, branching, max_depth, step, terminators,
                    clock=clock, rollout_depth=rollout_depth,
                )
                if best is None:
                    break
                path, sums = best
                first = path[0]
                if first.token in terminators:
                    break
                statement += first.token
                # Anytime checkpoint: each emitted token extends a valid
                # (if shorter) statement.
                self._checkpoint(
                    statement.strip(),
                    welfare=float(min(s / len(path) for s in sums)),
                    checkpoint=f"token {step + 1}/{max_tokens}",
                    tokens_emitted=step + 1,
                    tokens_planned=max_tokens,
                    max_depth=max_depth,
                    max_depth_planned=max_depth_full,
                )
                if step == max_tokens - 1:
                    break
                if clock.expired():
                    degraded_exit = True
                    break
                root_proposals = session.advance_and_propose([0], [first])[0]
        finally:
            session.close()

        if degraded_exit:
            return self._degrade()
        statement = statement.strip()
        self.pre_brushup_statement = statement
        if max_depth < max_depth_full:
            self._mark_scaled(max_depth=max_depth, max_depth_planned=max_depth_full)
        if cfg.get("brushup", False):
            if clock.expired():
                spent = dict(self.anytime.budget_spent) if self.anytime else {}
                spent["brushup_skipped"] = True
                self._checkpoint(statement, checkpoint="pre-brushup", **spent)
                return self._degrade()
            statement = brushup_statement_ending(self.backend, statement, seed=seed)
        return statement

    # -- tree ----------------------------------------------------------------

    @staticmethod
    def _best_path(
        session, root_proposals: List[ScoredCandidate], branching: int,
        max_depth: int, step: int,
        terminators: frozenset = TERMINATOR_TOKENS,
        clock=None,
        rollout_depth: int = 0,
    ):
        """Grow the level-batched tree from the trunk, accumulate per-agent
        logprob sums along every path, and return the max-min mean path.  A
        level is one session call, so the anytime ``clock`` is checked
        between levels: on expiry the tree stops growing and the best path
        over the partial tree is returned.

        With ``rollout_depth > 0`` every surviving (non-terminated, deduped)
        leaf also continues ``rollout_depth`` reference-policy tokens in ONE
        ``rollout_many`` call, and its welfare becomes the max-min MEAN
        logprob over path + rollout (``finite_lookahead.py:183-200`` of the
        JAX package).  Terminated paths keep the plain path mean."""
        frontier: List[Path] = []
        finished: List[Path] = []
        for cand in root_proposals[:branching]:
            node: Path = ([cand], list(cand.agent_logprobs))
            if cand.token in terminators:
                finished.append(node)
            else:
                frontier.append(node)

        for depth in range(1, max_depth):
            if not frontier:
                break
            if clock is not None and clock.expired():
                break
            proposals = session.propose_suffixes(
                [path for path, _ in frontier], salt=step * max_depth + depth
            )
            next_frontier: List[Path] = []
            for (path, sums), candidates in zip(frontier, proposals):
                for cand in candidates:
                    node = (
                        path + [cand],
                        [s + lp for s, lp in zip(sums, cand.agent_logprobs)],
                    )
                    if cand.token in terminators:
                        finished.append(node)
                    else:
                        next_frontier.append(node)
            frontier = next_frontier

        # Dedup by joined token string, drop empties; finished paths first.
        candidates: List[Tuple[Path, bool]] = []
        open_leaves: List[Path] = []
        seen = set()
        for (path, sums), is_open in [(p, False) for p in finished] + [(p, True) for p in frontier]:
            key = "".join(c.token for c in path)
            if not key or key in seen:
                continue
            seen.add(key)
            candidates.append(((path, sums), is_open))
            if is_open:
                open_leaves.append((path, sums))

        # Leaf value estimates: one call for every open leaf.  Salt stride
        # 100003 (a prime far above the leaves per step) keeps the family-2
        # rollout seeds disjoint across emitted tokens.
        rollouts: Dict[int, Tuple[List[float], int]] = {}
        if rollout_depth > 0 and open_leaves and not (clock is not None and clock.expired()):
            salts = [(step + 1) * 100003 + j for j in range(len(open_leaves))]
            results = session.rollout_many([path for path, _ in open_leaves], rollout_depth, salts)
            for j, (ids, _text, totals, ok) in enumerate(results):
                if ok and ids:
                    rollouts[j] = (totals, len(ids))

        best, best_welfare = None, None
        leaf_index = 0
        for (path, sums), is_open in candidates:
            horizon = rollouts.get(leaf_index) if is_open else None
            if is_open:
                leaf_index += 1
            if horizon is not None:
                totals, n = horizon
                welfare = min((s + r) / (len(path) + n) for s, r in zip(sums, totals))
            else:
                welfare = min(s / len(path) for s in sums)
            if best_welfare is None or welfare > best_welfare:
                best_welfare, best = welfare, (path, sums)
        return best
