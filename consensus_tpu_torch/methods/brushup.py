"""Statement-ending brushup pass (PyTorch port of
``consensus_tpu/methods/brushup.py``).

Reference ``src/utils.py:410-463`` (``brushup_statement_ending``): a low-
temperature LLM post-processor that repairs ONLY a statement's ending —
trailing repetition or an incomplete final sentence — and returns the
original statement on any failure.  Token-level decoders emit text token by
token and often stop mid-sentence at the budget; this pass cleans that up
without rewriting the content.
"""

from __future__ import annotations

from typing import Optional

from consensus_tpu_torch.backends.base import Backend, GenerationRequest
from consensus_tpu_torch.methods.prompts import clean_statement

_BRUSHUP_INSTRUCTIONS = (
    "Fix ONLY the ending of the statement below. If the final sentence is "
    "incomplete, finish or remove it; if the ending repeats itself, remove "
    "the repetition. Do not change anything else, do not add new content, "
    "and if the ending is already well-formed return the statement "
    "unchanged. Reply with the statement only."
)


def brushup_statement_ending(
    backend: Backend,
    statement: str,
    temperature: float = 0.2,
    seed: Optional[int] = None,
    max_tokens: int = 120,
) -> str:
    """Return the statement with a repaired ending, or unchanged on failure."""
    if not statement or not statement.strip():
        return statement
    result = backend.generate(
        [
            GenerationRequest(
                user_prompt=f"Statement:\n{statement}",
                system_prompt=_BRUSHUP_INSTRUCTIONS,
                max_tokens=max_tokens,
                temperature=temperature,
                seed=seed,
                chat=True,
            )
        ]
    )[0]
    if not result.ok:
        return statement
    cleaned = clean_statement(result.text)
    return cleaned if cleaned else statement
