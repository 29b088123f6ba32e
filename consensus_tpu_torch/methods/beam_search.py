"""Token-level egalitarian beam search over an incremental search session
(PyTorch port of ``consensus_tpu/methods/beam_search.py``).

Reference: ``src/methods/beam_search.py`` (695 LoC; SURVEY §2.4/§3.3).  Same
search semantics:

* beam state = (sequence string, cumulative per-agent reward vector),
  starting ``("", [0]*A)`` (reference :433-435);
* each step proposes ``beam_width`` distinct next tokens per beam from the
  reference policy (issue + all opinions + sequence so far), with a logit
  bias against junk tokens (reference :38-56);
* each proposed token is scored per agent as that token's logprob under the
  agent-conditioned policy, added to the beam's cumulative rewards
  (reference :335-405, last-token logprob);
* candidates rank by ``min`` over agents (egalitarian); EOS-string tokens
  complete a sequence; top ``beam_width`` non-terminal survive
  (reference :557-602);
* final pick: completed + remaining beams, sequences under 5 words filtered
  (with fallback), best min-reward wins; optional brushup with
  ``pre_brushup_statement`` retained (reference :620-693).

Cost redesign: the reference spends ``max_tokens x beam_width x (attempts
+ beam_width x agents)`` sequential API calls per statement.  Here the
whole search runs through ONE token-search session
(``backends/session.py``): on ``TorchBackend`` every step is one forward of
one position over persistent per-(beam x agent) KV tails and a trunk shared
by the beams -- proposal top-k and all (beam x token x agent) scores come
out of the same forward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from consensus_tpu_torch.backends.session import (
    ScoredCandidate,
    SearchSpec,
    open_token_search,
)
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.brushup import brushup_statement_ending
from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt

#: Token strings that complete a sequence (reference beam_search.py:26-35).
EOS_TOKENS = frozenset(
    {
        "<|eot_id|>",
        "<|end_of_text|>",
        ".\n\n",
        ".\n",
        "\n\n",
        '."\n\n',
        "<end_of_turn>",
        "<eos>",
    }
)

#: Junk tokens discouraged during token proposal (reference :38-53).
BIAS_AGAINST_TOKENS = (
    "...",
    '"',
    "***",
    "**",
    "\n\n\n",
    "\n\n\n\n",
    ":",
    " ...",
    " .",
    " •",
    "<end_of_turn>",
    "<eos>",
    "<start_of_turn>",
)

MIN_WORDS = 5  # reference :630-643

#: (sequence string, cumulative per-agent rewards, session slot index)
Beam = Tuple[str, List[float], int]


class BeamSearchGenerator(BaseGenerator):
    method_name = "beam_search"

    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        cfg = self.config
        clock = self.budget_clock
        beam_width_full = int(cfg.get("beam_width", 3))
        # Brownout shrinks the beam; deadline expiry ends the token loop at
        # the last completed step (every step leaves a rankable prefix).
        beam_width = clock.scale_int(beam_width_full)
        max_tokens = int(cfg.get("max_tokens", 50))
        temperature = float(cfg.get("temperature", 1.0))
        use_biasing = bool(cfg.get("use_token_biasing", True))
        bias_tokens = tuple(cfg.get("bias_against_tokens", BIAS_AGAINST_TOKENS))
        bias_tokens += tuple(cfg.get("additional_bias_tokens", ()))
        bias_value = float(cfg.get("bias_value", -1_000_000))
        # pin_budget (the timing mode): no EOS string may complete a beam
        # early -- every beam runs all max_tokens steps.
        eos_tokens = frozenset() if cfg.get("pin_budget") else EOS_TOKENS
        seed = self.seed

        agents = list(agent_opinions.items())
        if not agents:
            return ""
        if clock.expired():
            return self._degrade()

        system, user = reference_prompt(issue, agent_opinions, variant="beam_search")
        agent_prompts = tuple(
            agent_prompt(issue, opinion, variant="beam_search")
            for _, opinion in agents
        )
        session = open_token_search(
            self.backend,
            SearchSpec(
                ref_system=system,
                ref_user=user,
                agent_prompts=agent_prompts,
                n_slots=beam_width,
                k=beam_width,
                temperature=temperature,
                seed=seed,
                sample=True,
                bias_against_tokens=bias_tokens if use_biasing else (),
                bias_value=bias_value,
                max_steps=max_tokens,
                matrix_scoring=bool(cfg.get("matrix_scoring", True)),
            ),
        )

        beams: List[Beam] = [("", [0.0] * len(agents), 0)]
        completed: List[Tuple[str, List[float]]] = []
        try:
            proposals = session.propose()

            for step in range(max_tokens):
                candidates = []  # (new_seq, new_rewards, candidate, parent_slot)
                for sequence, cum_rewards, slot in beams:
                    for cand in proposals[slot]:
                        new_rewards = [
                            c + r
                            for c, r in zip(cum_rewards, cand.agent_logprobs)
                        ]
                        candidates.append(
                            (sequence + cand.token, new_rewards, cand, slot)
                        )
                beams, completed = self._prune(
                    candidates, completed, beam_width, eos_tokens
                )
                # Anytime checkpoint: every step leaves a rankable prefix.
                pool = completed + [(s, r) for s, r, *_ in beams]
                if pool:
                    best_seq, best_welfare = self._best_pair(pool)
                    self._checkpoint(
                        best_seq,
                        welfare=best_welfare,
                        checkpoint=f"step {step + 1}/{max_tokens}",
                        steps_done=step + 1,
                        steps_planned=max_tokens,
                        beam_width=beam_width,
                        beam_width_planned=beam_width_full,
                    )
                if not beams or step == max_tokens - 1:
                    break
                if clock.expired():
                    return self._degrade()
                # Advance every session slot; slots beyond the surviving
                # beams repeat the last survivor, proposals ignored.
                parents: List[int] = []
                chosen: List[ScoredCandidate] = []
                new_beams: List[Beam] = []
                for i in range(beam_width):
                    sequence, rewards, cand, parent = beams[
                        min(i, len(beams) - 1)
                    ]
                    parents.append(parent)
                    chosen.append(cand)
                    if i < len(beams):
                        new_beams.append((sequence, rewards, i))
                proposals = session.advance_and_propose(parents, chosen)
                beams = new_beams
        finally:
            session.close()

        completed.extend((seq, rewards) for seq, rewards, *_ in beams)
        if not completed:
            return ""

        statement = self._select_best(completed)
        self.pre_brushup_statement = statement
        if beam_width < beam_width_full:
            self._mark_scaled(
                beam_width=beam_width, beam_width_planned=beam_width_full
            )
        if cfg.get("brushup", False):
            if clock.expired():
                # Skip the brushup pass under pressure: the unbrushed
                # statement is complete, the extra dispatch is not worth it.
                spent = dict(self.anytime.budget_spent) if self.anytime else {}
                spent["brushup_skipped"] = True
                self._checkpoint(statement, checkpoint="pre-brushup", **spent)
                return self._degrade()
            statement = brushup_statement_ending(
                self.backend, statement, seed=seed
            )
        return statement

    # -- steps ---------------------------------------------------------------

    @staticmethod
    def _prune(
        candidates: List[Tuple[str, List[float], ScoredCandidate, int]],
        completed: List[Tuple[str, List[float]]],
        beam_width: int,
        eos_tokens: frozenset = EOS_TOKENS,
    ):
        """Egalitarian ranking; EOS tokens complete; dedup; keep top beams
        (reference :557-602).  Survivors keep (candidate, parent slot) so the
        session can advance them."""
        new_beams = []
        seen = set()
        for sequence, rewards, cand, parent in sorted(
            candidates, key=lambda c: min(c[1]), reverse=True
        ):
            if sequence in seen:
                continue
            if cand.token in eos_tokens:
                completed.append((sequence, rewards))
            elif len(new_beams) < beam_width:
                new_beams.append((sequence, rewards, cand, parent))
                seen.add(sequence)
        return new_beams, completed

    @staticmethod
    def _best_pair(
        completed: List[Tuple[str, List[float]]]
    ) -> Tuple[str, float]:
        filtered = [
            (seq, rewards)
            for seq, rewards in completed
            if len(seq.strip().split()) >= MIN_WORDS
        ]
        if not filtered:
            filtered = completed
        best_seq, best_rewards = max(filtered, key=lambda c: min(c[1]))
        return best_seq.strip(), float(min(best_rewards))

    @staticmethod
    def _select_best(completed: List[Tuple[str, List[float]]]) -> str:
        return BeamSearchGenerator._best_pair(completed)[0]
