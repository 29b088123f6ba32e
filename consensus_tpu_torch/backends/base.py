"""Backend protocol: the single seam between decoders and model execution.

A copy of the protocol and the request/result dataclasses of
``consensus_tpu/backends/base.py`` (the port imports nothing of the JAX
package), with the typed error taxonomy the supervision layer raises.

The reference funnels every model interaction through a module-global HTTP
client (``src/utils.py:69-74``) with four call shapes: chat/raw text
generation (``generate_text``, src/utils.py:77-198), prompt-span logprob
scoring (``get_prompt_logprobs``, src/utils.py:201-281), repeated 1-token
completions used as a sampler (``beam_search.py:199-333``), and embeddings
(``get_embedding``, src/utils.py:376-407).

Here those four shapes become an explicit, batch-first protocol.  Every call
takes a *sequence* of requests so a backend can execute them as one padded,
sharded device batch — the (candidates x agents) scoring loops of the
reference collapse into a single ``score()`` call.  ``next_token_logprobs``
returns the top-k of the true next-token distribution in one forward pass,
replacing the reference's rejection-sampling-via-repeated-API-calls
(beam_search.py:253-333, mcts.py:188-247) with an exact, cheaper primitive.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

#: Logit bias value used to effectively ban tokens (reference src/utils.py:86,
#: beam_search.py:56 use -1_000_000 through the API's logit_bias map).
BAN_BIAS = -1.0e6


# -- error taxonomy ----------------------------------------------------------
#
# Raw backends raise whatever their transport raises (RuntimeError from the
# device runtime, TimeoutError/OSError from sockets).  The supervision layer
# (backends/supervisor.py) classifies those into this typed hierarchy so
# every caller above the backend seam — batching, the experiment harness,
# the serving scheduler — can decide retry-vs-fail-vs-isolate by type
# instead of by string matching.


class BackendError(Exception):
    """Base of the typed backend failure taxonomy."""


class TransientBackendError(BackendError):
    """A retryable failure (flaky dispatch, timeout, dropped connection):
    the same call MAY succeed if reissued.  Raised by the supervisor after
    its own bounded retry budget is exhausted — seeing this type means
    retrying already happened below you."""


class BackendIntegrityError(BackendError):
    """The backend returned, but the payload is poisoned (NaN/Inf logprobs,
    a deterministically-failing row).  Never retryable: the same input
    produces the same poison."""


class BackendLostError(BackendError):
    """The device/backend is gone for good (or fenced off by an open
    circuit breaker).  Not retryable within this process."""


class RequestCancelled(BackendError):
    """The caller abandoned this request before its batch dispatched
    (serving ticket cancelled / deadline passed), so the batching layer
    dropped it at the flush snapshot instead of spending device time on it.
    Not a backend failure and never retryable: the work was withdrawn, not
    lost.  Deliberately NOT in the scheduler's TRANSIENT_EXCEPTIONS — a
    cancelled request must not be resurrected by the retry loop."""


class PartialBatchError(BackendError):
    """Some rows of a batched call failed and the rest succeeded.

    ``results`` is the full-length result list (or array) with valid
    entries at surviving indices; ``row_errors`` maps failing row index →
    the typed error for that row.  ``BatchingBackend`` unpacks this so one
    poisoned row fails only the session that submitted it; direct callers
    can either treat it as a whole-call failure or pick out ``results``.
    """

    def __init__(self, message: str, results, row_errors):
        super().__init__(message)
        self.results = results
        self.row_errors = dict(row_errors)


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One text-generation work item.

    ``chat=True`` renders the backend's chat template (the reference's
    ``use_chat_completions=True`` path); ``chat=False`` concatenates
    ``"{system}\n\n{user}"`` exactly as the raw-completions call sites do
    (beam_search.py:231-234, mcts.py:184-186, finite_lookahead.py:310-334).
    """

    user_prompt: str
    system_prompt: Optional[str] = None
    max_tokens: int = 128
    temperature: float = 1.0
    seed: Optional[int] = None
    stop: Tuple[str, ...] = ()
    bias_against_tokens: Tuple[str, ...] = ()
    bias_value: float = BAN_BIAS
    chat: bool = True
    #: HF/Together-style repetition penalty (>1 discourages repeats; the
    #: reference forwards the same-named param, src/utils.py:88).  1.0 = off.
    repetition_penalty: float = 1.0


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    text: str
    token_ids: Tuple[int, ...] = ()
    finish_reason: str = "stop"  # "stop" | "length" | "error"

    @property
    def ok(self) -> bool:
        return self.finish_reason != "error"


@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """Teacher-forced scoring of ``continuation`` given ``context``.

    The backend returns per-token logprobs for the continuation tokens only.
    This replaces the reference's echo'd-prompt span extraction
    (``extract_user_prompt_logprobs``, src/utils.py:284-373, including its
    zero-width-space marker hack) — on-device we simply tokenize context and
    continuation and gather the continuation logprobs directly
    (SURVEY §7.3 "logprob-extraction semantics").

    ``role`` selects where the continuation sits in the chat template:
    ``"assistant"`` (default) scores it as a model reply after the user
    turn; ``"user"`` scores it INSIDE the user turn with ``context`` in the
    system slot — the reference's evaluation semantics (its scorer echoes
    the statement as the *user prompt* with the eval template as system,
    src/evaluation.py:182-193).  Only meaningful with ``chat=True``.
    """

    context: str
    continuation: str
    system_prompt: Optional[str] = None
    chat: bool = True
    role: str = "assistant"  # "assistant" | "user"


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    tokens: Tuple[str, ...]
    logprobs: Tuple[float, ...]

    @property
    def ok(self) -> bool:
        return len(self.logprobs) > 0

    def mean(self, default: float = -10.0) -> float:
        """Mean continuation logprob (best_of_n / finite_lookahead utility)."""
        if not self.logprobs:
            return default
        return float(np.mean(self.logprobs))

    def total(self, default: float = -10.0) -> float:
        """Summed continuation logprob (beam_search / MCTS utility)."""
        if not self.logprobs:
            return default
        return float(np.sum(self.logprobs))


@dataclasses.dataclass(frozen=True)
class NextTokenRequest:
    """Ask for k candidate next tokens after a prompt, in one forward pass.

    ``mode="topk"`` returns the exact top-k of the next-token distribution;
    ``mode="sample"`` draws k *distinct* tokens by seeded Gumbel-top-k at the
    given temperature, preserving the stochastic-search character of the
    reference's repeated 1-token sampling while staying single-forward.
    """

    user_prompt: str
    system_prompt: Optional[str] = None
    k: int = 4
    temperature: float = 1.0
    seed: Optional[int] = None
    mode: str = "sample"  # "topk" | "sample"
    bias_against_tokens: Tuple[str, ...] = ()
    bias_value: float = BAN_BIAS
    chat: bool = False


@dataclasses.dataclass(frozen=True)
class TokenCandidate:
    token: str
    token_id: int
    logprob: float


@runtime_checkable
class Backend(Protocol):
    """Batch-first model-execution protocol (see module docstring)."""

    name: str

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        ...

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        ...

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        ...

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Return an (len(texts), dim) float array of unit-normalized embeddings."""
        ...



def generate_one(backend: Backend, request: GenerationRequest) -> GenerationResult:
    return backend.generate([request])[0]


def score_one(backend: Backend, request: ScoreRequest) -> ScoreResult:
    return backend.score([request])[0]
