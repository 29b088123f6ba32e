"""Deterministic fake backend for hardware- and network-free testing
(PyTorch port of ``consensus_tpu/backends/fake.py``: the same outputs for
the same requests, bit for bit).

A fully deterministic pseudo language model whose generations, logprobs,
next-token distributions and embeddings depend only on (text, seed) via a
stable blake2b hash, so every decoder's search logic, the batching layer
and the experiment engine run with no model at all.  It needs no torch:
numpy draws everything.

Two instruction-following behaviours make the Habermas Machine pipeline
testable end-to-end:

* prompts asking for an Arrow-notation ranking get a valid
  ``<answer>...<sep>A > B ...</answer>`` response whose permutation is a
  deterministic function of (prompt, seed);
* prompts asking for the ``<answer>/<sep>`` statement envelope get a
  well-formed envelope wrapping pseudo-text.

The JAX version's ``generate_stream`` (the decode engine's multi-token
seam) waits for the engine's port.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import List, Optional, Sequence

import numpy as np

from consensus_tpu_torch.backends.base import (
    GenerationRequest,
    GenerationResult,
    NextTokenRequest,
    ScoreRequest,
    ScoreResult,
    TokenCandidate,
)
from consensus_tpu_torch.obs.backends import BackendInstruments

_WORDS = (
    "we believe support should public policy community fairness balance "
    "invest transport climate action change democracy voices people shared "
    "common ground improve protect ensure access education health funding "
    "local national future growth rights debate reform open equal trust "
    "together progress safety environment economy citizens representation"
).split()

_PUNCT = [".", ",", " and", " the", " of", " to", " in"]
_EOS_TOKENS = ["<|eot_id|>", "<end_of_turn>", ".\n\n"]

#: Fake vocabulary: words (with leading space), punctuation, EOS markers.
VOCAB: List[str] = [f" {w}" for w in _WORDS] + _PUNCT + _EOS_TOKENS

_RANK_PROMPT_MARKER = "Arrow notation"
_ENVELOPE_MARKER = "<answer>"
_STATEMENT_LINE_RE = re.compile(r"^([A-Z])\. ", re.MULTILINE)
_JUDGE_RANKING_MARKER = "method_ranking"
_JUDGE_SCORE_MARKER = "representation score"
_METHOD_LINE_RE = re.compile(r"^\d+\. \[([^\]]+)\]", re.MULTILINE)


def _digest(*parts) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        h.update(str(part).encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.digest()


def _hash_unit_float(*parts) -> float:
    """Deterministic float in [0, 1)."""
    return int.from_bytes(_digest(*parts)[:8], "big") / 2**64


def _rng(*parts) -> np.random.Generator:
    return np.random.default_rng(int.from_bytes(_digest(*parts)[:8], "big"))


def _pow2_bucket(n: int, minimum: int) -> int:
    """Next power of two >= max(n, minimum): the row and width ladders of the
    JAX package's fake backend, so fake-run padding metrics match it."""
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


class FakeBackend:
    """Deterministic pseudo-LM implementing the :class:`Backend` protocol."""

    name = "fake"
    #: The fake LM keys every response on (prompt, seed) and IGNORES
    #: temperature, so a temperature-0 retry with a new seed genuinely
    #: differs here.  Keep False so the fake pipeline exercises the
    #: reference's full retry choreography.
    deterministic_greedy = False

    def __init__(
        self,
        embed_dim: int = 64,
        instruction_following: bool = True,
        registry=None,
    ):
        self.embed_dim = embed_dim
        self.instruction_following = instruction_following
        self.call_counts = {"generate": 0, "score": 0, "next_token": 0, "embed": 0}
        # Token-honest accounting mirroring the resident backend (pseudo-tokens).
        self.token_counts = {"generated": 0, "scored": 0}
        # obs: the fake backend records padding/launch events AS IF its
        # batches padded onto pow2 device grids, so the full metrics path
        # (registry -> metrics.json -> sweep aggregation) is testable
        # without hardware.  ``registry`` lets tests isolate from the
        # process-global registry.
        self.instruments = BackendInstruments("fake", registry=registry)

    # -- generation ---------------------------------------------------------

    def _full_prompt(self, request: GenerationRequest | NextTokenRequest) -> str:
        if request.system_prompt:
            if getattr(request, "chat", False):
                return f"[SYS]{request.system_prompt}[/SYS]\n{request.user_prompt}"
            return f"{request.system_prompt}\n\n{request.user_prompt}"
        return request.user_prompt

    def _pseudo_sentence(self, key: bytes, max_tokens: int) -> str:
        rng = np.random.default_rng(int.from_bytes(key[:8], "big"))
        length = int(rng.integers(6, max(7, min(max_tokens, 30))))
        words = [str(rng.choice(_WORDS)) for _ in range(length)]
        words[0] = words[0].capitalize()
        return " ".join(words) + "."

    def _ranking_response(self, prompt: str, seed) -> str:
        letters = sorted(set(_STATEMENT_LINE_RE.findall(prompt)))
        if not letters:
            letters = ["A", "B"]
        rng = _rng("rank", prompt, seed)
        order = list(rng.permutation(letters))
        ranking = " > ".join(order)
        return (
            "<answer>\nDeterministic fake reasoning about the participant's "
            f"opinion.\n<sep>\n{ranking}\n</answer>"
        )

    def _envelope_response(self, prompt: str, seed, max_tokens: int) -> str:
        body = self._pseudo_sentence(_digest("env", prompt, seed), max_tokens)
        return f"<answer>\nFake step-by-step reasoning.\n<sep>\n{body}\n</answer>"

    def _judge_ranking_response(self, prompt: str, seed) -> str:
        """Deterministic LLM-judge JSON: a permutation ranking of the
        ``N. [method] statement`` lines found in the prompt."""
        methods = _METHOD_LINE_RE.findall(prompt)
        if not methods:
            methods = ["unknown"]
        rng = _rng("judge-rank", prompt, seed)
        order = list(rng.permutation(len(methods)))
        ranking = {m: int(order[i]) + 1 for i, m in enumerate(methods)}
        import json as _json

        return _json.dumps(
            {
                "reasoning": "Deterministic fake comparative judgement.",
                "method_ranking": ranking,
            }
        )

    def _judge_score_response(self, prompt: str, seed) -> str:
        score = 1 + int(_hash_unit_float("judge-score", prompt, seed) * 5) % 5
        import json as _json

        return _json.dumps(
            {
                "representation score": score,
                "explanation": "Deterministic fake representation judgement.",
            }
        )

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        self.call_counts["generate"] += len(requests)
        if requests:
            rows = _pow2_bucket(len(requests), 8)
            width = _pow2_bucket(max(r.max_tokens for r in requests), 16)
            self.instruments.record_launch("generate", (rows, width))
        results = []
        for req in requests:
            prompt = self._full_prompt(req)
            if self.instruction_following and _JUDGE_RANKING_MARKER in prompt:
                text = self._judge_ranking_response(prompt, req.seed)
            elif self.instruction_following and _JUDGE_SCORE_MARKER in prompt:
                text = self._judge_score_response(prompt, req.seed)
            elif self.instruction_following and _RANK_PROMPT_MARKER in prompt:
                text = self._ranking_response(prompt, req.seed)
            elif self.instruction_following and _ENVELOPE_MARKER in prompt:
                text = self._envelope_response(prompt, req.seed, req.max_tokens)
            else:
                text = self._pseudo_sentence(_digest("gen", prompt, req.seed), req.max_tokens)
            for stop in req.stop:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            self.token_counts["generated"] += len(self._tokenize(text))
            results.append(GenerationResult(text=text, finish_reason="stop"))
        if requests:
            self.instruments.record_padding(
                "generate_decode", rows, width,
                sum(len(self._tokenize(r.text)) for r in results),
            )
        return results

    # -- scoring ------------------------------------------------------------

    def _tokenize(self, text: str) -> List[str]:
        """Whitespace-splitting pseudo-tokenizer that preserves spacing."""
        return re.findall(r"\s*\S+", text) or ([text] if text else [])

    def token_logprob(self, context: str, token: str) -> float:
        """Deterministic per-token logprob in [-6.0, -0.05]."""
        u = _hash_unit_float("lp", context, token)
        return -0.05 - 5.95 * u

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        self.call_counts["score"] += len(requests)
        if requests:
            token_rows = [self._tokenize(r.continuation) for r in requests]
            rows = _pow2_bucket(len(requests), 8)
            width = _pow2_bucket(max(len(t) for t in token_rows), 64)
            self.instruments.record_launch("score", (rows, width))
            self.instruments.record_padding(
                "score", rows, width, sum(len(t) for t in token_rows)
            )
        results = []
        for req in requests:
            context = (
                f"{req.system_prompt}\n\n{req.context}" if req.system_prompt else req.context
            )
            tokens = self._tokenize(req.continuation)
            logprobs = []
            running = context
            for token in tokens:
                logprobs.append(self.token_logprob(running, token))
                running += token
            self.token_counts["scored"] += len(tokens)
            results.append(ScoreResult(tokens=tuple(tokens), logprobs=tuple(logprobs)))
        return results

    # -- next-token distribution -------------------------------------------

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        self.call_counts["next_token"] += len(requests)
        self.token_counts["scored"] += len(requests)
        if requests:
            rows = _pow2_bucket(len(requests), 8)
            self.instruments.record_launch("next_token", (rows, 1))
            self.instruments.record_padding("next_token", rows, 1, len(requests))
        out: List[List[TokenCandidate]] = []
        for req in requests:
            prompt = self._full_prompt(req)
            logits = np.array(
                [4.0 * _hash_unit_float("nt", prompt, tok) for tok in VOCAB]
            )
            for banned in req.bias_against_tokens:
                for idx, tok in enumerate(VOCAB):
                    if banned in tok:
                        logits[idx] += req.bias_value
            logprobs = logits - (
                np.max(logits) + math.log(np.sum(np.exp(logits - np.max(logits))))
            )
            k = min(req.k, len(VOCAB))
            if req.mode == "topk" or req.temperature <= 0:
                top = np.argsort(-logprobs)[:k]
            else:
                gumbel = _rng("gum", prompt, req.seed).gumbel(size=len(VOCAB))
                top = np.argsort(-(logprobs / req.temperature + gumbel))[:k]
                top = top[np.argsort(-logprobs[top])]
            out.append(
                [TokenCandidate(VOCAB[i], int(i), float(logprobs[i])) for i in top]
            )
        return out

    # -- embeddings ---------------------------------------------------------

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        self.call_counts["embed"] += len(texts)
        if texts:
            rows = _pow2_bucket(len(texts), 8)
            self.instruments.record_launch("embed", (rows, 1))
            self.instruments.record_padding("embed", rows, 1, len(texts))
        vectors = np.stack(
            [_rng("emb", text).normal(size=self.embed_dim) for text in texts]
        )
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        return vectors / np.maximum(norms, 1e-12)
