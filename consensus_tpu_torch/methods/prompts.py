"""Shared prompt templates for the consensus decoders.

The reference embeds per-decoder template constants whose exact strings the
welfare numbers are sensitive to (SURVEY §7.3 "chat-template parity"); here
they live once, keyed by VARIANT, with each decoder requesting its own:

* ``best_of_n`` — space form ``"Issue: {issue}"``, agent block
  "Agent's opinion" (reference best_of_n.py:29-35);
* ``beam_search`` — newline form ``"Issue:\\n{issue}"``, agent block
  "Participant's opinion" / "Statement reflecting ONLY this participant's
  opinion" (beam_search.py:58-80);
* ``finite_lookahead`` — newline form with the best_of_n agent wording
  (finite_lookahead.py:20-34);
* ``mcts`` — newline form, no "(less than 50 tokens)" suffix, "Be concise
  and coherent." system prompts (mcts.py:55-77).

All decoders share the reference's opinions block: ``Participant {i+1}:
{opinion}`` joined by blank lines (best_of_n.py:89-94).
"""

from __future__ import annotations

from typing import Dict, Tuple

_SHORT = (
    "Be concise and keep the statement short (less than 50 tokens) and "
    "focused. ONLY WRITE THE STATEMENT AND NOTHING ELSE."
)
_COHERENT = "Be concise and coherent. ONLY WRITE THE CONSENSUS STATEMENT AND NOTHING ELSE."

REFERENCE_SYSTEM_PROMPT = (
    "You are generating a consensus statement that represents the views of "
    "multiple participants.\nYour task is to continue the statement in a way "
    "that addresses the issue and considers all participants' opinions. " + _SHORT
)

AGENT_SYSTEM_PROMPT = (
    "You are generating a statement that represents the views of a single "
    "participant.\nYour task is to continue the statement in a way that "
    "addresses the issue and considers ONLY this participant's opinion. " + _SHORT
)

MCTS_REFERENCE_SYSTEM_PROMPT = REFERENCE_SYSTEM_PROMPT.replace(_SHORT, _COHERENT)
MCTS_AGENT_SYSTEM_PROMPT = AGENT_SYSTEM_PROMPT.replace(_SHORT, _COHERENT)

#: variant -> (reference_system, reference_user, agent_system, agent_user)
TEMPLATE_VARIANTS: Dict[str, Tuple[str, str, str, str]] = {
    "best_of_n": (
        REFERENCE_SYSTEM_PROMPT,
        "Issue: {issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement (less than 50 tokens): ",
        AGENT_SYSTEM_PROMPT,
        "Issue: {issue}\n\nAgent's opinion:\n{opinion}\n\n"
        "Statement reflecting this opinion (less than 50 tokens): ",
    ),
    "beam_search": (
        REFERENCE_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement (less than 50 tokens):\n",
        AGENT_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nParticipant's opinion:\n{opinion}\n\n"
        "Statement reflecting ONLY this participant's opinion "
        "(less than 50 tokens):\n",
    ),
    "finite_lookahead": (
        REFERENCE_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement (less than 50 tokens):\n",
        AGENT_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nAgent's opinion:\n{opinion}\n\n"
        "Statement reflecting this opinion (less than 50 tokens):\n",
    ),
    "mcts": (
        MCTS_REFERENCE_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement:\n",
        MCTS_AGENT_SYSTEM_PROMPT,
        "Issue:\n{issue}\n\nParticipant's opinion:\n{opinion}\n\n"
        "Statement reflecting ONLY this participant's opinion:\n",
    ),
}


def format_opinions(agent_opinions: Dict[str, str]) -> str:
    """Reference opinions block: ``Participant {i+1}: {opinion}`` paragraphs
    (best_of_n.py:89-94; identical in beam/lookahead/mcts)."""
    return "\n\n".join(
        f"Participant {i + 1}: {opinion}"
        for i, opinion in enumerate(agent_opinions.values())
    )


def reference_prompt(
    issue: str, agent_opinions: Dict[str, str], variant: str = "best_of_n"
) -> Tuple[str, str]:
    """(system, user) prompts for the all-opinions reference policy."""
    system, user, _, _ = TEMPLATE_VARIANTS[variant]
    return (
        system,
        user.format(issue=issue, opinions_text=format_opinions(agent_opinions)),
    )


def agent_prompt(issue: str, opinion: str, variant: str = "best_of_n") -> Tuple[str, str]:
    """(system, user) prompts for a single-opinion agent policy."""
    _, _, system, user = TEMPLATE_VARIANTS[variant]
    return (system, user.format(issue=issue, opinion=opinion))


#: Instruction-prefix strings models prepend despite being told not to;
#: stripped from generations (reference best_of_n.py:216-229).
STATEMENT_PREFIXES = (
    "Consensus statement:",
    "Statement:",
    "Here is the consensus statement:",
    "Here is a statement reflecting this opinion:",
    "Okay, here is the statement:",
)

#: EOS marker strings that can leak into decoded text
#: (reference best_of_n.py:26, beam_search.py:26-35).
EOS_MARKERS = (
    "<|eot_id|>",
    "<|end_of_text|>",
    "<end_of_turn>",
    "<eos>",
)


def clean_statement(text: str) -> str:
    """Strip instruction prefixes and trailing EOS markers from a generation
    (behaviour of reference best_of_n.py:209-238)."""
    if not text:
        return ""
    cleaned = text.strip()
    lowered = cleaned.lower()
    for prefix in STATEMENT_PREFIXES:
        if lowered.startswith(prefix.lower()):
            cleaned = cleaned[len(prefix):].strip()
            break
    changed = True
    while changed:
        changed = False
        for eos in EOS_MARKERS:
            if cleaned.endswith(eos):
                cleaned = cleaned[: -len(eos)].strip()
                changed = True
    return cleaned
