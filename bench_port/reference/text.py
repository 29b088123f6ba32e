"""Frozen copies of the text layer the reference needs to rebuild a prompt's
token ids: the byte tokenizer, its chat template, the decoders' prompt
templates, the statement cleaner and the brushup prompt.

They are copies, not imports, so that the yardstick does not move when the
program's text layer does: a program that starts to build another prompt,
tokenize it another way or clean a statement otherwise fails the harness's
exact checks instead of being judged against its own new output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SPECIAL_TOKENS = (
    "<pad>", "<bos>", "<eos>", "<|eot_id|>", "<|end_of_text|>", "<end_of_turn>",
    "<start_of_turn>", "[SYS]", "[/SYS]", "[USER]", "[/USER]", "[ASSISTANT]",
)
N_SPECIAL = len(SPECIAL_TOKENS)
VOCAB_SIZE = N_SPECIAL + 256
BOS_ID = 1
_SPECIAL_TO_ID = {s: i for i, s in enumerate(SPECIAL_TOKENS)}
_MATCH_ORDER = sorted((s for s in SPECIAL_TOKENS if s != "<pad>"), key=len, reverse=True)


def encode(text: str, add_bos: bool = False) -> List[int]:
    """UTF-8 bytes, with each special string as one id."""
    ids: List[int] = [BOS_ID] if add_bos else []
    i = 0
    while i < len(text):
        for special in _MATCH_ORDER:
            if text.startswith(special, i):
                ids.append(_SPECIAL_TO_ID[special])
                i += len(special)
                break
        else:
            ids.extend(N_SPECIAL + b for b in text[i].encode("utf-8"))
            i += 1
    return ids


def token_str(token_id: int) -> str:
    if token_id < N_SPECIAL:
        return SPECIAL_TOKENS[token_id]
    if token_id < VOCAB_SIZE:
        return bytes([token_id - N_SPECIAL]).decode("utf-8", "replace")
    return ""


def token_ids_containing(text: str) -> List[int]:
    """Ids whose string contains ``text`` (the logit-bias token sets)."""
    ids = [i for i, s in enumerate(SPECIAL_TOKENS) if text in s and i != 0]
    ids += [N_SPECIAL + b for b in range(256) if text in bytes([b]).decode("utf-8", "ignore")]
    return ids


def chat_prompt(user: str, system: Optional[str] = None) -> str:
    if system:
        return f"[SYS]{system}[/SYS]\n[USER]{user}[/USER]\n[ASSISTANT]"
    return f"[USER]{user}[/USER]\n[ASSISTANT]"


def raw_prompt(user: str, system: Optional[str] = None) -> str:
    return f"{system}\n\n{user}" if system else user


_SHORT = (
    "Be concise and keep the statement short (less than 50 tokens) and "
    "focused. ONLY WRITE THE STATEMENT AND NOTHING ELSE."
)
_REFERENCE_SYSTEM = (
    "You are generating a consensus statement that represents the views of "
    "multiple participants.\nYour task is to continue the statement in a way "
    "that addresses the issue and considers all participants' opinions. " + _SHORT
)
_AGENT_SYSTEM = (
    "You are generating a statement that represents the views of a single "
    "participant.\nYour task is to continue the statement in a way that "
    "addresses the issue and considers ONLY this participant's opinion. " + _SHORT
)

#: variant -> (reference user template, agent user template); both variants
#: share the two system prompts above.
_TEMPLATES: Dict[str, Tuple[str, str]] = {
    "best_of_n": (
        "Issue: {issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement (less than 50 tokens): ",
        "Issue: {issue}\n\nAgent's opinion:\n{opinion}\n\n"
        "Statement reflecting this opinion (less than 50 tokens): ",
    ),
    "beam_search": (
        "Issue:\n{issue}\n\nParticipants' opinions:\n{opinions_text}\n\n"
        "Consensus statement (less than 50 tokens):\n",
        "Issue:\n{issue}\n\nParticipant's opinion:\n{opinion}\n\n"
        "Statement reflecting ONLY this participant's opinion "
        "(less than 50 tokens):\n",
    ),
}


def reference_prompt(issue: str, opinions: Dict[str, str], variant: str) -> Tuple[str, str]:
    """(system, user) of the all-opinions reference policy."""
    block = "\n\n".join(f"Participant {i + 1}: {o}" for i, o in enumerate(opinions.values()))
    return _REFERENCE_SYSTEM, _TEMPLATES[variant][0].format(issue=issue, opinions_text=block)


def agent_prompt(issue: str, opinion: str, variant: str) -> Tuple[str, str]:
    """(system, user) of one agent's opinion-conditioned policy."""
    return _AGENT_SYSTEM, _TEMPLATES[variant][1].format(issue=issue, opinion=opinion)


_STATEMENT_PREFIXES = (
    "Consensus statement:", "Statement:", "Here is the consensus statement:",
    "Here is a statement reflecting this opinion:", "Okay, here is the statement:",
)
_EOS_MARKERS = ("<|eot_id|>", "<|end_of_text|>", "<end_of_turn>", "<eos>")


def clean_statement(text: str) -> str:
    """Strip an instruction prefix and trailing EOS markers."""
    if not text:
        return ""
    cleaned = text.strip()
    lowered = cleaned.lower()
    for prefix in _STATEMENT_PREFIXES:
        if lowered.startswith(prefix.lower()):
            cleaned = cleaned[len(prefix):].strip()
            break
    changed = True
    while changed:
        changed = False
        for eos in _EOS_MARKERS:
            if cleaned.endswith(eos):
                cleaned = cleaned[: -len(eos)].strip()
                changed = True
    return cleaned


BRUSHUP_SYSTEM = (
    "Fix ONLY the ending of the statement below. If the final sentence is "
    "incomplete, finish or remove it; if the ending repeats itself, remove "
    "the repetition. Do not change anything else, do not add new content, "
    "and if the ending is already well-formed return the statement "
    "unchanged. Reply with the statement only."
)


def brushup_user(statement: str) -> str:
    return f"Statement:\n{statement}"
