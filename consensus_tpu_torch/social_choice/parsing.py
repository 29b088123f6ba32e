"""Parsers for LLM deliberation responses.

The PyTorch port's own copy of ``consensus_tpu/social_choice/parsing.py`` (pure
numpy; the port imports nothing of the JAX package).

Covers the two structured formats the Habermas Machine pipeline relies on:

1. ``<answer> reasoning <sep> payload </answer>`` chain-of-thought envelopes
   (statements, critiques, revisions) — reference
   ``src/methods/habermas_machine.py:480-527``.
2. Arrow-notation preference rankings like ``"B > A = D > C"`` — reference
   ``src/methods/habermas_machine.py:657-918``, with the exact error-code
   strings (``INCORRECT_TEMPLATE`` / ``INCORRECT_ARROW_RANKING`` /
   ``INTERNAL_PARSING_ERROR``) pinned by golden tests.

Rank convention: lower is better, 0 is best; ties share a rank and the next
preference level increments by one (``"B>A=D>C" -> [1, 0, 2, 1]``).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

_ANSWER_RE = re.compile(r"<answer>(.*?)<sep>(.*?)(?:</answer>|\Z)", re.DOTALL | re.IGNORECASE)
_ARROW_RE = re.compile(r"\b[A-Z](?: *[>=] *[A-Z])*\b")
_ARROW_FULL_RE = re.compile(r"^[A-Z](?: *[>=] *[A-Z])*$")
_SEP_RE = re.compile(r"<sep>", re.IGNORECASE)
_ANSWER_OPEN_RE = re.compile(r"<answer>", re.IGNORECASE)
_ANSWER_CLOSE_RE = re.compile(r"</answer>", re.IGNORECASE)
_FINAL_RANKING_RE = re.compile(r"final ranking:", re.IGNORECASE)


def extract_statement(response: str) -> Optional[str]:
    """Pull the payload after ``<sep>`` out of an ``<answer>`` envelope.

    Tolerates a truncated ``</answer>`` (stop sequences may eat it) and
    rejects payloads of 5 characters or fewer, matching reference
    ``_process_llm_response`` (habermas_machine.py:480-527).
    """
    if not response:
        return None
    match = _ANSWER_RE.search(response)
    if not match:
        return None
    statement = match.group(2).strip()
    if statement and len(statement) > 5:
        return statement
    return None


def check_response_format(response: str) -> bool:
    """Strict check that all three envelope tags are present (reference :657-666)."""
    return bool(
        _ANSWER_OPEN_RE.search(response)
        and _SEP_RE.search(response)
        and _ANSWER_CLOSE_RE.search(response)
    )


def check_arrow_format(ranking_str: str, num_statements: int) -> bool:
    """Validate an arrow/equality ranking string (reference :669-713).

    Requires: only ``>``/``=`` separators, the letter set exactly
    {A..} for ``num_statements`` statements, and no duplicate letters.
    """
    if not ranking_str:
        return False
    if not _ARROW_FULL_RE.fullmatch(ranking_str):
        return False
    letters = [c for c in ranking_str if c.isalpha()]
    expected = {chr(ord("A") + i) for i in range(num_statements)}
    if set(letters) != expected:
        return False
    if len(letters) != len(set(letters)):
        return False
    return True


def extract_arrow_ranking(text: str) -> Optional[str]:
    """Find the first arrow-ranking substring and strip internal spaces.

    ``'Explanation\\nA > B < C > D' -> 'A>B'`` (first maximal match only),
    reference :716-749.
    """
    if not text:
        return None
    match = _ARROW_RE.search(text)
    if not match:
        return None
    return re.sub(r" *([>=]) *", r"\1", match.group(0)).strip()


def parse_arrow_ranking(arrow_ranking: str, num_statements: int) -> Optional[np.ndarray]:
    """Parse a validated arrow ranking to a 0-based rank array with ties.

    ``"B>A=D>C", 4 -> [1, 0, 2, 1]``; each ``>`` level increments the rank by
    exactly one regardless of tie-group size (reference :752-832).
    """
    if not arrow_ranking:
        return None

    ranking = np.full(num_statements, -1, dtype=int)
    seen = set()
    for rank, group in enumerate(arrow_ranking.split(">")):
        group = group.strip()
        if not group:
            continue
        for item in group.split("="):
            letter = item.strip()
            if len(letter) != 1 or not ("A" <= letter <= "Z"):
                return None
            if letter in seen:
                return None
            idx = ord(letter) - ord("A")
            if not 0 <= idx < num_statements:
                return None
            ranking[idx] = rank
            seen.add(letter)

    expected = {chr(ord("A") + i) for i in range(num_statements)}
    if seen != expected or -1 in ranking:
        return None
    return ranking


def _ranking_from_text(text: str, num_statements: int) -> Optional[np.ndarray]:
    arrow = extract_arrow_ranking(text)
    if arrow and check_arrow_format(arrow, num_statements):
        return parse_arrow_ranking(arrow, num_statements)
    return None


def process_ranking_response(
    response: str, num_statements: int
) -> Tuple[Optional[np.ndarray], str]:
    """Full response -> (rank array | None, explanation-or-error string).

    Error-string contract (reference :835-918):
      * valid envelope but bad/missing ranking -> ``"INCORRECT_ARROW_RANKING: <response>"``
      * bad envelope with a parsable ``final ranking:`` fallback -> rank array
      * bad envelope otherwise -> ``"INCORRECT_TEMPLATE: <response>"``
      * post-validation parse failure -> ``"INTERNAL_PARSING_ERROR: <response>"``
    On success the explanation is the raw response itself.
    """
    if check_response_format(response):
        sep_match = _SEP_RE.search(response)
        close_match = _ANSWER_CLOSE_RE.search(response)
        start = sep_match.end()
        end = close_match.start() if close_match else len(response)
        candidate_text = response[start:end].strip()

        arrow = extract_arrow_ranking(candidate_text)
        if arrow and check_arrow_format(arrow, num_statements):
            ranking = parse_arrow_ranking(arrow, num_statements)
            if ranking is None:
                return None, f"INTERNAL_PARSING_ERROR: {response}"
            return ranking, response
        return None, f"INCORRECT_ARROW_RANKING: {response}"

    final_match = _FINAL_RANKING_RE.search(response)
    if final_match:
        start = final_match.end()
        newline = response.find("\n", start)
        end = newline if newline != -1 else len(response)
        candidate_text = response[start:end].strip()

        arrow = extract_arrow_ranking(candidate_text)
        if arrow and check_arrow_format(arrow, num_statements):
            ranking = parse_arrow_ranking(arrow, num_statements)
            if ranking is None:
                return None, f"INTERNAL_PARSING_ERROR: {response}"
            return ranking, response
        return None, f"INCORRECT_TEMPLATE: {response}"

    return None, f"INCORRECT_TEMPLATE: {response}"
