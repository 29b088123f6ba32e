"""Token-search sessions: stateful propose-and-score for token-level decoders
(the part of ``consensus_tpu/backends/session.py`` the port needs: :39-83,
437-459).

A session fixes the search context once -- the reference-policy prompt and
the per-agent prompts (same model, different prefix) -- and then serves the
decoders' per-step primitive:

    propose k next tokens per active slot from the reference policy, and
    score every proposal under every agent policy.

The port has one implementation, ``TorchTokenSearchSession`` (built by
``TorchBackend.open_fused_token_search``): persistent per-(slot x role) KV
tails on the device and one fused step per emitted token
(``models/stepper.py``).  The JAX package's backend-agnostic fallback,
``PrefixTokenSearchSession``, needs ``next_token_logprobs``, which is not
ported yet (ROADMAP queue A5); :func:`open_token_search` therefore raises
where the JAX factory would fall back, and never takes another path
silently.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

from consensus_tpu_torch.backends.base import BAN_BIAS


class FusedSessionUnavailable(Exception):
    """A backend's fused session declined this spec (e.g. the KV caches
    would not fit in the session budget of device memory)."""


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
    #: Speculative rollout verification: an MCTS-slice feature (ROADMAP
    #: queue A7); the port's session raises when it is set.
    speculative: bool = False


_FALLBACK = (
    "the full-prefix fallback session (PrefixTokenSearchSession) needs "
    "next_token_logprobs, which is not ported yet (ROADMAP.md, queue A: evaluation)"
)


def open_token_search(backend, spec: SearchSpec):
    """Session factory: the backend's fused session.  Where the JAX factory
    falls back to the full-prefix session -- no ``open_fused_token_search``
    on the backend, or :class:`FusedSessionUnavailable` from it -- this one
    raises ``NotImplementedError`` naming the missing piece."""
    maker = getattr(backend, "open_fused_token_search", None)
    if maker is None:
        raise NotImplementedError(
            f"backend {getattr(backend, 'name', backend)!r} has no fused token-search "
            f"session, and {_FALLBACK}"
        )
    try:
        return maker(spec)
    except FusedSessionUnavailable as exc:
        raise NotImplementedError(f"fused session declined ({exc}), and {_FALLBACK}") from exc
