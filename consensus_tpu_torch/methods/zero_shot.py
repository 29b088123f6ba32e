"""Zero-shot baseline: one reference-policy generation, no search.

The reference's ``zero_shot`` is an unimplemented placeholder returning a
hardcoded string (src/methods/zero_shot.py:16, despite readme.md:28
describing it as a real baseline).  This is the real method: a single
chat-completion from the reference prompt — the degenerate point of the
decoder family (best-of-1 without scoring).
"""

from __future__ import annotations

from typing import Dict

from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.prompts import clean_statement, reference_prompt


class ZeroShotGenerator(BaseGenerator):
    # Single indivisible generation: no anytime seam, nothing to scale.
    method_name = "zero_shot"

    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        system, user = reference_prompt(issue, agent_opinions)
        result = self.backend.generate(
            [
                GenerationRequest(
                    user_prompt=user,
                    system_prompt=system,
                    max_tokens=int(self.config.get("max_tokens", 50)),
                    temperature=float(self.config.get("temperature", 1.0)),
                    seed=self.seed,
                    chat=True,
                )
            ]
        )[0]
        if not result.ok:
            return f"[ERROR: zero-shot generation failed: {result.text}]"
        return clean_statement(result.text)
