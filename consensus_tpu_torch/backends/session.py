"""Token-search sessions: stateful propose-and-score for token-level decoders
(PyTorch port of ``consensus_tpu/backends/session.py``).

A session fixes the search context once -- the reference-policy prompt and
the per-agent prompts (same model, different prefix) -- and then serves the
decoders' per-step primitive:

    propose k next tokens per active slot from the reference policy, and
    score every proposal under every agent policy.

Two implementations:

* ``TorchTokenSearchSession`` (built by
  ``TorchBackend.open_fused_token_search``) -- persistent per-(slot x role)
  KV tails on the device and one fused step per emitted token
  (``models/stepper.py``).  O(T).
* :class:`PrefixTokenSearchSession` -- the backend-agnostic fallback
  (reference ``session.py:85-425``).  Each step re-submits full prefixes
  through ``Backend.next_token_logprobs`` and scores the proposals through
  the utility-matrix seam (``score_matrix.score_matrix_many``), or flat
  ``Backend.score`` batches with ``matrix_scoring`` off.  O(T^2) model work.
  On ``TorchBackend`` both calls run on the backend's device: with
  ``use_flash_attention`` every next-token forward attends through the
  flash kernel.

:func:`open_token_search` gives the fused session first refusal and falls
back on :class:`FusedSessionUnavailable` (a cache over the session budget)
or on a backend without a fused session, as the reference's factory does.

Semantics note: the fallback re-tokenizes ``prompt + sequence_string`` every
step (the reference's behaviour: its "sequence" is a string of token
strings), while the fused session appends token *ids* to persistent caches.
The two coincide except where a tokenizer would merge a sequence boundary
on re-encoding.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

from consensus_tpu_torch.backends.base import (
    BAN_BIAS,
    GenerationRequest,
    NextTokenRequest,
    ScoreRequest,
)
from consensus_tpu_torch.backends.score_matrix import (
    AgentContext,
    ScoreMatrixRequest,
    score_matrix_many,
)


class FusedSessionUnavailable(Exception):
    """A backend's fused session declined this spec (e.g. the KV caches
    would not fit in the session budget of device memory): the factory
    falls back to :class:`PrefixTokenSearchSession`."""


class ScoredCandidate(NamedTuple):
    token: str
    token_id: int
    ref_logprob: float  # proposal logprob under the reference policy
    agent_logprobs: Tuple[float, ...]  # one per agent, search-order


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Immutable description of one token search."""

    ref_system: Optional[str]
    ref_user: str
    agent_prompts: Tuple[Tuple[Optional[str], str], ...]  # (system, user) per agent
    n_slots: int
    k: int
    temperature: float = 1.0
    seed: Optional[int] = None
    sample: bool = True  # Gumbel-top-k vs deterministic top-k proposals
    bias_against_tokens: Tuple[str, ...] = ()
    bias_value: float = BAN_BIAS
    max_steps: int = 64
    failure_logprob: float = -10.0  # substituted when a backend scores nothing
    #: Speculative rollout verification (Leviathan et al.): an n-gram
    #: self-draft proposer emits ``spec_draft_len`` suffix tokens per leaf
    #: and the target model verifies the whole draft in one parallel forward
    #: (``models/stepper.rollout_verify_many``); rejection keeps the token
    #: streams those of the sequential rollout.  Fused sessions only: the
    #: full-prefix fallback's rollout is already one batched generate call,
    #: so it accepts and ignores the flag, as the reference's does.
    speculative: bool = False
    spec_draft_len: int = 8
    #: Route the fallback session's (prefix x candidate x agent) scoring
    #: through the utility-matrix seam (``backends/score_matrix.py``): fused
    #: on the device on ``TorchBackend``, batched per-call elsewhere.  Off
    #: restores flat per-cell ``Backend.score`` batches.
    matrix_scoring: bool = True


class PrefixTokenSearchSession:
    """Fallback session: full-prefix batched calls per step (any backend)."""

    def __init__(self, backend, spec: SearchSpec):
        self.backend = backend
        self.spec = spec
        self._sequences = [""] * spec.n_slots
        self._step = 0
        #: Backend protocol calls actually submitted (the fallback's unit of
        #: host->device round trips).  Decoders read the delta per statement.
        self.dispatch_count = 0

    # -- protocol ------------------------------------------------------------

    def propose(self) -> List[List[ScoredCandidate]]:
        """Root proposals (every slot starts with the empty sequence)."""
        return self._propose_and_score()

    def close(self) -> None:
        """No device state to release in the full-prefix fallback."""

    def advance_and_propose(
        self, parents: Sequence[int], chosen: Sequence[ScoredCandidate]
    ) -> List[List[ScoredCandidate]]:
        """Advance slot i to ``parents[i]``'s sequence + ``chosen[i]``, then
        propose and score for the new state of every slot."""
        spec = self.spec
        if len(parents) != spec.n_slots or len(chosen) != spec.n_slots:
            raise ValueError(
                f"expected {spec.n_slots} (parent, token) pairs, got "
                f"{len(parents)}/{len(chosen)}"
            )
        self._sequences = [
            self._sequences[parent] + cand.token
            for parent, cand in zip(parents, chosen)
        ]
        self._step += 1
        return self._propose_and_score()

    def propose_suffixes(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], salt: int
    ) -> List[List[ScoredCandidate]]:
        """Propose + score k candidates for each tree path hanging off the
        trunk (slot 0's sequence).  Full-prefix fallback: one batched
        next-token call over all paths plus one batched score call over
        (path x candidate x agent)."""
        spec = self.spec
        if spec.n_slots != 1:
            raise ValueError("propose_suffixes requires an n_slots=1 session")
        if not suffixes:
            return []
        trunk = self._sequences[0]
        prefixes = [
            trunk + "".join(c.token for c in suffix) for suffix in suffixes
        ]
        return self._proposals_for(prefixes, family=1, index=salt)

    def rollout_from(
        self, suffix: Sequence[ScoredCandidate], depth: int, salt: int
    ) -> Tuple[List[int], str, List[float], bool]:
        """Continue ``depth`` reference-policy tokens past trunk+suffix and
        return (rollout token ids, rollout text, per-agent total logprob of
        the rollout tokens, ok).  Delegates to :meth:`rollout_many`: one
        generate call and one score call either way."""
        return self.rollout_many([suffix], depth, [salt])[0]

    def rollout_many(
        self,
        suffixes: Sequence[Sequence[ScoredCandidate]],
        depth: int,
        salts: Sequence[int],
    ) -> List[Tuple[List[int], str, List[float], bool]]:
        """Batched :meth:`rollout_from` (reference ``session.py:163-233``):
        ONE generate call over all paths and ONE score call over (path x
        agent).  Row i's request seed is ``(seed * 3 + 2) * 1e9 + salts[i] *
        1000`` (family 2 of :meth:`_proposals_for`'s seed map), so each
        row's result is that of a ``rollout_from`` call alone."""
        spec = self.spec
        if spec.n_slots != 1:
            raise ValueError("rollout_many requires an n_slots=1 session")
        if len(salts) != len(suffixes):
            raise ValueError(f"expected {len(suffixes)} salts, got {len(salts)}")
        if not suffixes:
            return []
        trunk = self._sequences[0]
        prefixes = [trunk + "".join(c.token for c in suffix) for suffix in suffixes]
        seed = spec.seed
        results = self.backend.generate([
            GenerationRequest(
                user_prompt=spec.ref_user + prefix,
                system_prompt=spec.ref_system,
                max_tokens=depth,
                temperature=spec.temperature,
                seed=((seed * 3 + 2) * 1_000_000_000 + salt * 1000) if seed is not None else None,
                chat=False,
            )
            for prefix, salt in zip(prefixes, salts)
        ])
        self.dispatch_count += 1
        n_agents = len(spec.agent_prompts)
        if spec.matrix_scoring:
            return self._rollout_totals_matrix(prefixes, results, n_agents)
        score_requests: List[ScoreRequest] = []
        starts: List[Optional[int]] = []
        for prefix, result in zip(prefixes, results):
            if result.ok and result.text:
                starts.append(len(score_requests))
                for a_system, a_user in spec.agent_prompts:
                    score_requests.append(
                        ScoreRequest(
                            context=a_user + prefix,
                            continuation=result.text,
                            system_prompt=a_system,
                            chat=False,
                        )
                    )
            else:
                starts.append(None)
        scores = self.backend.score(score_requests) if score_requests else []
        if score_requests:
            self.dispatch_count += 1
        out: List[Tuple[List[int], str, List[float], bool]] = []
        for result, start in zip(results, starts):
            if not result.ok:
                out.append(([], "", [], False))
            elif not result.text:
                out.append(([], "", [0.0] * n_agents, True))
            else:
                totals = [
                    (sum(s.logprobs) if s.ok else spec.failure_logprob)
                    for s in scores[start : start + n_agents]
                ]
                out.append((list(result.token_ids), result.text, totals, True))
        return out

    def _rollout_totals_matrix(
        self, prefixes: Sequence[str], results, n_agents: int
    ) -> List[Tuple[List[int], str, List[float], bool]]:
        """Rollout totals through the utility-matrix seam (reference
        ``session.py:235-280``): one (1 x agents) matrix of stat "sum" per
        successful rollout, all in ONE backend call -- the dispatch count
        of the flat score batch it replaces."""
        spec = self.spec
        matrix_requests: List[ScoreMatrixRequest] = []
        rows: List[Optional[int]] = []
        for prefix, result in zip(prefixes, results):
            if result.ok and result.text:
                rows.append(len(matrix_requests))
                matrix_requests.append(
                    ScoreMatrixRequest(
                        agents=tuple(
                            AgentContext(context=a_user + prefix, system_prompt=a_system, chat=False)
                            for a_system, a_user in spec.agent_prompts
                        ),
                        candidates=(result.text,),
                        stat="sum",
                        default=spec.failure_logprob,
                    )
                )
            else:
                rows.append(None)
        matrices = None
        if matrix_requests and n_agents:
            matrices = score_matrix_many(self.backend, matrix_requests)
            self.dispatch_count += 1
        out: List[Tuple[List[int], str, List[float], bool]] = []
        for result, row in zip(results, rows):
            if not result.ok:
                out.append(([], "", [], False))
            elif not result.text:
                out.append(([], "", [0.0] * n_agents, True))
            else:
                totals = (
                    [float(v) for v in matrices[row].utilities[0]] if matrices is not None else []
                )
                out.append((list(result.token_ids), result.text, totals, True))
        return out

    # -- internals -----------------------------------------------------------

    def _proposals_for(
        self, prefixes: Sequence[str], family: int, index: int
    ) -> List[List[ScoredCandidate]]:
        """One batched next-token call over ``prefixes`` + one batched score
        call over (prefix x candidate x agent).  ``(seed, family, index,
        row)`` tuples map injectively onto request seeds (index < 1e6 —
        generous for salts/steps; row < 1000 — far above any path fan-out),
        so no two seeded requests across a seed sweep ever collide."""
        spec = self.spec
        seed = spec.seed
        if not (0 <= index < 1_000_000 and len(prefixes) <= 1000):
            raise ValueError(
                f"seed-map bounds exceeded: index={index}, rows={len(prefixes)}"
            )
        requests = [
            NextTokenRequest(
                user_prompt=spec.ref_user + prefix,
                system_prompt=spec.ref_system,
                k=spec.k,
                temperature=spec.temperature,
                seed=(
                    (seed * 3 + family) * 1_000_000_000 + index * 1000 + row
                )
                if seed is not None
                else None,
                mode="sample" if spec.sample else "topk",
                bias_against_tokens=spec.bias_against_tokens,
                bias_value=spec.bias_value,
                chat=False,
            )
            for row, prefix in enumerate(prefixes)
        ]
        proposals = self.backend.next_token_logprobs(requests)
        self.dispatch_count += 1
        if spec.matrix_scoring:
            return self._score_proposals_matrix(prefixes, proposals)

        score_requests = []
        for prefix, candidates in zip(prefixes, proposals):
            for candidate in candidates:
                for a_system, a_user in spec.agent_prompts:
                    score_requests.append(
                        ScoreRequest(
                            context=a_user + prefix,
                            continuation=candidate.token,
                            system_prompt=a_system,
                            chat=False,
                        )
                    )
        scores = self.backend.score(score_requests)
        if score_requests:
            self.dispatch_count += 1
        return self._zip_scores(proposals, scores)

    def _score_proposals_matrix(
        self, prefixes: Sequence[str], proposals
    ) -> List[List[ScoredCandidate]]:
        """Proposal scoring via the utility-matrix seam: one
        (candidates x agents) matrix per prefix — same cells, same order,
        ONE backend call for all prefixes (matching the flat batch's
        dispatch count).  Stat "last" is the per-call path's
        ``logprobs[-1]`` exactly, so fallback values are byte-identical."""
        spec = self.spec
        n_agents = len(spec.agent_prompts)
        matrix_requests = [
            ScoreMatrixRequest(
                agents=tuple(
                    AgentContext(
                        context=a_user + prefix,
                        system_prompt=a_system,
                        chat=False,
                    )
                    for a_system, a_user in spec.agent_prompts
                ),
                candidates=tuple(c.token for c in candidates),
                stat="last",
                default=spec.failure_logprob,
            )
            for prefix, candidates in zip(prefixes, proposals)
        ]
        total_cells = sum(len(c) for c in proposals) * n_agents
        matrices = None
        if total_cells:
            matrices = score_matrix_many(self.backend, matrix_requests)
            self.dispatch_count += 1
        out: List[List[ScoredCandidate]] = []
        for i, candidates in enumerate(proposals):
            slot_out = []
            for ci, candidate in enumerate(candidates):
                agent_lps = (
                    tuple(float(v) for v in matrices[i].utilities[ci])
                    if matrices is not None
                    else ()
                )
                slot_out.append(
                    ScoredCandidate(
                        token=candidate.token,
                        token_id=candidate.token_id,
                        ref_logprob=candidate.logprob,
                        agent_logprobs=agent_lps,
                    )
                )
            out.append(slot_out)
        return out

    def _propose_and_score(self) -> List[List[ScoredCandidate]]:
        # Seed family 0: trunk/beam steps (family 1 = suffix trees) — the
        # families must stay disjoint or a suffix level whose salt equals a
        # later trunk step would replay its exact proposal requests.
        return self._proposals_for(
            self._sequences, family=0, index=self._step
        )

    def _zip_scores(self, proposals, scores) -> List[List[ScoredCandidate]]:
        spec = self.spec
        n_agents = len(spec.agent_prompts)
        out: List[List[ScoredCandidate]] = []
        flat = 0
        for candidates in proposals:
            slot_out = []
            for candidate in candidates:
                agent_lps = tuple(
                    (s.logprobs[-1] if s.ok else spec.failure_logprob)
                    for s in scores[flat : flat + n_agents]
                )
                flat += n_agents
                slot_out.append(
                    ScoredCandidate(
                        token=candidate.token,
                        token_id=candidate.token_id,
                        ref_logprob=candidate.logprob,
                        agent_logprobs=agent_lps,
                    )
                )
            out.append(slot_out)
        return out


def open_token_search(backend, spec: SearchSpec):
    """Session factory (reference ``session.py:428-453``): a backend offering
    ``open_fused_token_search`` gets first refusal; on
    :class:`FusedSessionUnavailable`, or with no fused session at all, the
    full-prefix fallback runs over ``backend`` itself."""
    maker = getattr(backend, "open_fused_token_search", None)
    if maker is not None:
        try:
            return maker(spec)
        except FusedSessionUnavailable:
            pass
    return PrefixTokenSearchSession(backend, spec)
