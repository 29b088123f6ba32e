"""Frozen copies of the decisions that pick a statement from the model's
numbers: best-of-N's egalitarian choice and beam search's pruning and final
choice.  The harness replays them on the numbers the program produced and
requires the program's choices to be these, exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_REWARD = -10.0
REWARD_CLIP = 20.0

#: Token strings that complete a beam (unless the budget is pinned).
EOS_TOKENS = frozenset(
    {"<|eot_id|>", "<|end_of_text|>", ".\n\n", ".\n", "\n\n", '."\n\n', "<end_of_turn>", "<eos>"}
)
MIN_WORDS = 5


def egalitarian_choice(utilities: np.ndarray) -> int:
    """Index of the candidate with the highest worst-off agent utility
    (NaN -> -10, +-inf -> +-20 first)."""
    u = np.asarray(utilities, dtype=np.float32)
    u = np.where(np.isnan(u), np.float32(DEFAULT_REWARD), u)
    u = np.where(np.isposinf(u), np.float32(REWARD_CLIP), u)
    u = np.where(np.isneginf(u), np.float32(-REWARD_CLIP), u)
    return int(np.argmax(u.min(axis=1)))


def _prune(candidates, completed, beam_width: int, eos_tokens):
    new_beams, seen = [], set()
    for sequence, rewards, cand, parent in sorted(candidates, key=lambda c: min(c[1]), reverse=True):
        if sequence in seen:
            continue
        if cand.token in eos_tokens:
            completed.append((sequence, rewards))
        elif len(new_beams) < beam_width:
            new_beams.append((sequence, rewards, cand, parent))
            seen.add(sequence)
    return new_beams, completed


def _best(completed: List[Tuple[str, List[float]]]) -> str:
    filtered = [(s, r) for s, r in completed if len(s.strip().split()) >= MIN_WORDS] or completed
    return max(filtered, key=lambda c: min(c[1]))[0].strip()


def replay_beam_search(
    steps: Sequence[Tuple[Sequence[int], Sequence[int], list]],
    n_agents: int,
    beam_width: int,
    max_tokens: int,
    pinned: bool,
) -> Tuple[str, int]:
    """Replay beam search over a session's recorded steps.

    ``steps[0]`` is ``((), (), proposals)`` of the opening ``propose`` and
    ``steps[i]`` is ``(parents, chosen token ids, proposals)`` of the i-th
    advance, each proposal a ``(token, token_id, ref_logprob,
    agent_logprobs)`` tuple per slot.  Returns (the statement the search
    picks before any brushup, the number of advances whose parents or
    tokens differ from what the replay asks for, plus any advance count
    that differs)."""
    eos_tokens = frozenset() if pinned else EOS_TOKENS
    beams = [("", [0.0] * n_agents, 0)]
    completed: List[Tuple[str, List[float]]] = []
    proposals = steps[0][2]
    mismatches, used = 0, 1
    for step in range(max_tokens):
        candidates = [
            (sequence + cand.token, [c + r for c, r in zip(rewards, cand.agent_logprobs)], cand, slot)
            for sequence, rewards, slot in beams
            for cand in proposals[slot]
        ]
        beams, completed = _prune(candidates, completed, beam_width, eos_tokens)
        if not beams or step == max_tokens - 1:
            break
        parents, chosen, new_beams = [], [], []
        for i in range(beam_width):
            sequence, rewards, cand, parent = beams[min(i, len(beams) - 1)]
            parents.append(parent)
            chosen.append(cand.token_id)
            if i < len(beams):
                new_beams.append((sequence, rewards, i))
        if used >= len(steps):
            return "", mismatches + 1
        got_parents, got_chosen, proposals = steps[used]
        used += 1
        if list(got_parents) != parents or list(got_chosen) != chosen:
            mismatches += 1
        beams = new_beams
    completed.extend((s, r) for s, r, *_ in beams)
    mismatches += int(used != len(steps))
    return (_best(completed) if completed else ""), mismatches
