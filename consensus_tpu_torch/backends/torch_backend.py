"""On-device model backend for the GPU: the PyTorch counterpart of
``consensus_tpu/backends/tpu.py`` (``TPUBackend``).

It owns a resident transformer (Gemma-2 / Llama-3 family or a tiny test
config) and runs each protocol call as padded device batches:

* ``generate`` -- the classic path: left-padded batch prefill + KV-cache
  decode with per-request temperature, logit-bias sets, EOS ids, host-side
  stop-string truncation (``tpu.py:815-855``, ``:937-1060``);
* ``score`` -- right-padded teacher-forced forward (``_score_impl``,
  ``tpu.py:1253-1338``) with the same row and width buckets, truncation
  rules and streamed-vocab threshold; its attention is the hand-written
  flash kernel when ``use_flash_attention`` is set;
* ``open_fused_token_search`` -- :class:`TorchTokenSearchSession`, the
  incremental KV-cache search session of beam search and finite lookahead
  (``tpu.py:1731-1739, 2140-2398, 2644-2687``); its step attends through the
  hand-written decode kernel when ``use_decode_attention`` is set.

No ``score_matrix`` method yet: best-of-N's utility matrix goes through the
per-call fallback (``backends/score_matrix.py``).  Options that select a
path not ported yet raise ``NotImplementedError`` naming the ROADMAP item.

Seeds: each request's seed seeds its OWN row ``torch.Generator``, so a
request's output does not depend on which other requests share its batch.
The generators do not reproduce the JAX package's threefry streams
(ROADMAP queue A3), so sampled text differs from the reference; greedy
text and scores agree within float tolerance.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from consensus_tpu_torch.backends.base import (
    GenerationRequest,
    GenerationResult,
    ScoreRequest,
    ScoreResult,
)
from consensus_tpu_torch.backends.session import (
    FusedSessionUnavailable,
    ScoredCandidate,
    SearchSpec,
)
from consensus_tpu_torch.models.config import ModelConfig, get_model_config
from consensus_tpu_torch.models.generate import generate_tokens
from consensus_tpu_torch.models.quant import is_quantized, quantize_params
from consensus_tpu_torch.models.stepper import search_prefill, search_step, suffix_propose
from consensus_tpu_torch.models.tokenizer import get_tokenizer
from consensus_tpu_torch.models.transformer import (
    init_params,
    params_dtype,
    token_logprobs,
    token_logprobs_streamed,
)
from consensus_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: Above this vocab size the streaming scorer replaces full-logit scoring.
_STREAMED_VOCAB_THRESHOLD = 32_768
#: Device memory kept free for activations outside the generate budget.
_ACTIVATION_RESERVE_BYTES = 3 * 1024**3
#: Budget on the CPU, which has no device-memory query: effectively none.
_CPU_BUDGET_BYTES = 1 << 40
#: Live search-session caches: at most this much, at least the floor, else
#: what is free after the weights and the activation reserve.
_SESSION_CACHE_BYTES_CAP = 8 * 1024**3
_SESSION_MIN_BUDGET_BYTES = 1 * 1024**3

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _SessionBudget:
    """Device-memory budget for LIVE session caches (``tpu.py:94-114``).
    Opening a session blocks until its cache fits; closing releases it."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.used = 0
        self._cond = threading.Condition()

    def acquire(self, nbytes: int) -> None:
        with self._cond:
            while self.used + nbytes > self.cap:
                self._cond.wait()
            self.used += nbytes

    def release(self, nbytes: int) -> None:
        with self._cond:
            self.used -= nbytes
            self._cond.notify_all()


def _bucket(n: int, minimum: int = 32) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _width_bucket(n: int, minimum: int = 128) -> int:
    """Sequence-length bucket on the {1, 1.5} x power-of-two ladder
    (128, 192, 256, 384, 512, ...), as ``tpu.py:124-135``."""
    size = minimum
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to the PyTorch backend yet "
        f"(ROADMAP.md, queue A: {item})"
    )


class TorchBackend:
    name = "torch"
    #: Temperature-0 generation is argmax; the seed never enters it.
    deterministic_greedy = True

    def __init__(
        self,
        model: str = "tiny-gemma2",
        checkpoint: Optional[str] = None,
        tokenizer: Optional[str] = None,
        dtype: str = "bfloat16",
        max_context: int = 1024,
        base_seed: int = 0,
        tp: int = 1,
        dp: Optional[int] = None,
        params: Optional[Dict[str, Any]] = None,
        config: Optional[ModelConfig] = None,
        use_flash_attention: bool = False,
        use_decode_attention: bool = False,
        max_batch_rows: int = 64,
        quantization: Optional[str] = None,
        shared_context_scoring: bool = False,
        shared_trunk_generation: bool = False,
        segmented_decode: bool = False,
        kv_quant: bool = False,
        mesh: Optional[Any] = None,
        device: Optional[str] = None,
    ):
        if shared_context_scoring:
            raise _not_ported("shared_context_scoring=True", "shared-context scoring")
        if shared_trunk_generation:
            raise _not_ported(
                "shared_trunk_generation=True", "shared-trunk, segmented and int8-KV generation"
            )
        if segmented_decode:
            raise _not_ported(
                "segmented_decode=True", "shared-trunk, segmented and int8-KV generation"
            )
        if kv_quant:
            raise _not_ported(
                "kv_quant=True", "shared-trunk, segmented and int8-KV generation"
            )
        if tp != 1 or (dp is not None and dp != 1) or mesh is not None:
            raise _not_ported("tp/dp/mesh", "multi-GPU")
        if checkpoint is not None:
            raise _not_ported("checkpoint loading", "multi-GPU (checkpoints, HF safetensors)")
        if quantization not in (None, "none", "int8"):
            raise ValueError(f"unknown quantization mode: {quantization!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; want one of {sorted(_DTYPES)}")

        self.device = resolve_device(device)
        self.config = config if config is not None else get_model_config(model)
        if use_flash_attention and not self.config.use_flash_attention:
            self.config = dataclasses.replace(self.config, use_flash_attention=True)
        if use_decode_attention and not self.config.use_decode_attention:
            self.config = dataclasses.replace(self.config, use_decode_attention=True)
        self.model_name = model
        family = "llama" if "llama" in self.config.name else "gemma"
        self.tokenizer = get_tokenizer(tokenizer, family=family)
        # A tokenizer-sized vocab keeps random-weight runs self-consistent.
        if self.tokenizer.vocab_size != self.config.vocab_size:
            self.config = dataclasses.replace(
                self.config, vocab_size=self.tokenizer.vocab_size
            )
        self.max_context = max_context
        self.base_seed = base_seed
        self.max_batch_rows = max(1, max_batch_rows)
        self.quantization = quantization if quantization != "none" else None

        if params is not None:
            self.params = params
            if self.quantization == "int8" and not is_quantized(params):
                self.params = quantize_params(params)
        else:
            logger.warning(
                "TorchBackend: no checkpoint given -- using RANDOM weights (%s). "
                "Statements will be noise; timings/shapes are real.",
                self.config.name,
            )
            generator = torch.Generator(device=self.device)
            generator.manual_seed(base_seed)
            self.params = init_params(
                self.config, generator, self.device, _DTYPES[dtype],
                int8=self.quantization == "int8",
            )

        self._bias_id_cache: Dict[str, Tuple[int, ...]] = {}
        self.call_counts = {
            "generate": 0, "score": 0, "score_batches": 0, "search_advances": 0,
        }
        self.token_counts = {"generated": 0, "scored": 0}
        self._unseeded_calls = 0
        self._nonce_lock = threading.Lock()
        # Live-session budget (``tpu.py:412-419``), read from what the device
        # has free once the weights are resident instead of a fixed HBM size.
        self._session_budget = _SessionBudget(
            min(
                _SESSION_CACHE_BYTES_CAP,
                max(
                    _SESSION_MIN_BUDGET_BYTES,
                    self._free_device_bytes() - _ACTIVATION_RESERVE_BYTES,
                ),
            )
        )

    # -- helpers -------------------------------------------------------------

    def kv_cache_identity(self) -> tuple:
        """Content-key identity for cross-request prefix KV reuse: model,
        KV mode and tensor-parallel width (always dense KV and tp=1 here)."""
        return (self.model_name, "dense", ("tp", 1))

    def _sliced(self, requests, fn, limit: Optional[int] = None):
        limit = limit or self.max_batch_rows
        if len(requests) <= limit:
            return fn(requests)
        out = []
        for i in range(0, len(requests), limit):
            out.extend(fn(requests[i : i + limit]))
        return out

    def _render_prompt(self, request) -> str:
        if getattr(request, "chat", True):
            return self.tokenizer.chat_prompt(request.user_prompt, request.system_prompt)
        return self.tokenizer.raw_prompt(request.user_prompt, request.system_prompt)

    def _batch_width(self, token_lists: List[List[int]]) -> int:
        longest = min(max(len(t) for t in token_lists), self.max_context)
        return min(_width_bucket(longest), self.max_context)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _left_pad_batch(self, token_lists: List[List[int]]):
        """(tokens, valid) left-padded into a shared length bucket."""
        width = self._batch_width(token_lists)
        tokens = np.full((len(token_lists), width), self.tokenizer.pad_id, np.int32)
        valid = np.zeros((len(token_lists), width), bool)
        for row, ids in enumerate(token_lists):
            ids = ids[-width:]  # keep the most recent context
            tokens[row, width - len(ids):] = ids
            valid[row, width - len(ids):] = True
        return self._to_device(tokens), self._to_device(valid)

    def _bias_table(self, requests: Sequence):
        """Dedup per-request bias sets into a (U, V) table + row index."""
        if not any(r.bias_against_tokens for r in requests):
            return None, None
        unique: Dict[Tuple, int] = {}
        vectors: List[np.ndarray] = []
        index = np.zeros((len(requests),), np.int64)
        for row, request in enumerate(requests):
            key = (tuple(request.bias_against_tokens), request.bias_value)
            if key not in unique:
                vector = self._bias_vector(request.bias_against_tokens, request.bias_value)
                if vector is None:
                    vector = np.zeros((self.config.vocab_size,), np.float32)
                unique[key] = len(vectors)
                vectors.append(vector)
            index[row] = unique[key]
        return self._to_device(np.stack(vectors)), self._to_device(index)

    def _bias_vector(self, bias_tokens: Sequence[str], bias_value: float):
        if not bias_tokens:
            return None
        vector = np.zeros((self.config.vocab_size,), np.float32)
        for text in bias_tokens:
            if text not in self._bias_id_cache:
                self._bias_id_cache[text] = tuple(self.tokenizer.token_ids_containing(text))
            for token_id in self._bias_id_cache[text]:
                vector[token_id] += bias_value
        return vector

    def _fold_seed(self, *parts) -> int:
        # Stable across processes (Python's hash() is salted per process).
        digest = hashlib.blake2b(
            repr((self.base_seed,) + parts).encode(), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big") % (2**63)

    def _row_generators(
        self, kind: str, seeds: Sequence[Optional[int]]
    ) -> List[torch.Generator]:
        """One generator per row.  Seeded rows depend on their own seed only;
        unseeded rows fold their row index plus a per-backend nonce so
        identical unseeded prompts in one batch still draw distinct streams."""
        generators = []
        for row, seed in enumerate(seeds):
            if seed is None:
                with self._nonce_lock:
                    self._unseeded_calls += 1
                    nonce = self._unseeded_calls
                value = self._fold_seed(kind, "unseeded", row, nonce)
            else:
                value = self._fold_seed(kind, seed)
            g = torch.Generator(device=self.device)
            g.manual_seed(value)
            generators.append(g)
        return generators

    def _free_device_bytes(self) -> int:
        if self.device.type != "cuda":
            return _CPU_BUDGET_BYTES
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(
            self.device
        )
        return free + cached

    def _generate_rows_allowed(self, prompt_width: int, max_new: int) -> int:
        """Largest decode batch whose KV cache and prefill attention transient
        fit in free device memory (``tpu.py:717-748``, with the budget read
        from ``torch.cuda.mem_get_info`` instead of a fixed HBM size)."""
        c = self.config
        itemsize = torch.finfo(params_dtype(self.params)).bits // 8
        columns = prompt_width + max_new
        cache_row = 2 * c.n_layers * c.n_kv_heads * c.head_dim * itemsize * columns
        # Prefill materializes per-layer fp32 logits and their softmax.
        prefill_row = 2 * c.n_heads * prompt_width * columns * 4
        budget = self._free_device_bytes() - _ACTIVATION_RESERVE_BYTES
        allowed = max(1, budget // (cache_row + prefill_row))
        bucket = 1
        while bucket * 2 <= allowed:
            bucket *= 2
        if bucket >= 2 and bucket + bucket // 2 <= allowed:
            bucket += bucket // 2
        return bucket

    # -- generate ------------------------------------------------------------

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        if not requests:
            return []
        token_lists = [
            self.tokenizer.encode(self._render_prompt(r), add_bos=True) for r in requests
        ]
        return self._generate_classic(list(requests), token_lists)

    def _prep_generation_rows(self, requests: Sequence[GenerationRequest], allowed: int):
        """Row bucketing + per-row sampling state (``tpu.py:815-855``)."""
        target = min(_bucket(len(requests), minimum=min(8, allowed)), allowed)
        pad_rows = target - len(requests)
        temperatures = torch.tensor(
            [r.temperature for r in requests] + [1.0] * pad_rows,
            dtype=torch.float32, device=self.device,
        )
        penalties = [getattr(r, "repetition_penalty", 1.0) for r in requests]
        rep_penalty = (
            torch.tensor(penalties + [1.0] * pad_rows, dtype=torch.float32, device=self.device)
            if any(abs(p - 1.0) > 1e-9 for p in penalties)
            else None
        )
        bias_table, bias_index = self._bias_table(requests)
        if bias_index is not None and pad_rows:
            bias_index = torch.cat(
                [bias_index, torch.zeros((pad_rows,), dtype=bias_index.dtype, device=self.device)]
            )
        generators = self._row_generators(
            "generate", [r.seed for r in requests] + [0] * pad_rows
        )
        eos_ids = self.tokenizer.eos_ids
        return (target, pad_rows, temperatures, bias_table, bias_index,
                generators, eos_ids, rep_penalty)

    def _generate_classic(
        self, requests: Sequence[GenerationRequest], token_lists: List[List[int]]
    ) -> List[GenerationResult]:
        if len(requests) > self.max_batch_rows:
            out: List[GenerationResult] = []
            for i in range(0, len(requests), self.max_batch_rows):
                out.extend(
                    self._generate_classic(
                        requests[i : i + self.max_batch_rows],
                        token_lists[i : i + self.max_batch_rows],
                    )
                )
            return out
        width = self._batch_width(token_lists)
        max_new = _width_bucket(max(r.max_tokens for r in requests), minimum=16)
        allowed = self._generate_rows_allowed(width, max_new)
        if len(requests) > allowed:
            out = []
            for i in range(0, len(requests), allowed):
                out.extend(
                    self._generate_classic(
                        requests[i : i + allowed], token_lists[i : i + allowed]
                    )
                )
            return out

        self.call_counts["generate"] += len(requests)
        (target, pad_rows, temperatures, bias_table, bias_index, generators,
         eos_ids, rep_penalty) = self._prep_generation_rows(requests, allowed)
        tokens, valid = self._left_pad_batch(list(token_lists) + [[]] * pad_rows)
        with torch.inference_mode():
            out = generate_tokens(
                self.params, self.config, tokens, valid, max_new,
                generators=generators,
                temperature=temperatures,
                eos_ids=torch.tensor(eos_ids, dtype=torch.int32, device=self.device),
                bias_table=bias_table,
                bias_index=bias_index,
                pad_id=self.tokenizer.pad_id,
                rep_penalty=rep_penalty,
            )
        return self._finish_generation(requests, out)

    def _finish_generation(self, requests: Sequence[GenerationRequest], out) -> List[GenerationResult]:
        """Host-side post-processing: decode, EOS/stop semantics, token
        accounting (``tpu.py:1016-1060``)."""
        generated = out.tokens.cpu().numpy()
        counts = out.num_generated.cpu().numpy()
        hit_eos = out.hit_eos.cpu().numpy()
        results = []
        for row, request in enumerate(requests):
            emitted = int(counts[row])
            ids = [int(t) for t in generated[row, :emitted]][: request.max_tokens]
            text = self.tokenizer.decode(ids)
            # "stop" only if EOS arrived within the request's own cap.
            finish = "stop" if (hit_eos[row] and emitted <= request.max_tokens) else "length"
            truncated = False
            for stop in request.stop:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
                    finish = "stop"
                    truncated = True
            if truncated:
                ids = self.tokenizer.encode(text)
            self.token_counts["generated"] += len(ids)
            results.append(GenerationResult(text=text, token_ids=tuple(ids), finish_reason=finish))
        return results

    # -- score ---------------------------------------------------------------

    def _score_prefix(self, request: ScoreRequest) -> str:
        prefix = (
            f"{request.system_prompt}\n\n{request.context}"
            if request.system_prompt
            else request.context
        )
        if request.chat and request.role == "user":
            parts = [p for p in (request.system_prompt, request.context) if p]
            prefix = self.tokenizer.user_turn_prefix("\n\n".join(parts) or None)
        elif request.chat:
            prefix = self.tokenizer.chat_prompt(request.context, request.system_prompt)
        return prefix

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        """Teacher-forced scoring in ``max_batch_rows`` slices."""
        if not requests:
            return []
        return self._sliced(list(requests), self._score_impl)

    def _score_impl(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        """Full-sequence batch scorer (``tpu.py:1253-1338``)."""
        self.call_counts["score"] += len(requests)
        self.call_counts["score_batches"] += 1
        rows = []
        spans = []  # (context_len, continuation_len) per row
        for request in requests:
            context_ids = self.tokenizer.encode(self._score_prefix(request), add_bos=True)
            continuation_ids = self.tokenizer.encode(request.continuation)
            rows.append(context_ids + continuation_ids)
            spans.append((len(context_ids), len(continuation_ids)))

        rows += [[]] * (_bucket(len(rows), minimum=8) - len(rows))
        longest = min(max(len(r) for r in rows), self.max_context)
        width = min(_width_bucket(longest), self.max_context)
        tokens = np.full((len(rows), width), self.tokenizer.pad_id, np.int32)
        valid = np.zeros((len(rows), width), bool)
        for i, ids in enumerate(rows):
            if len(ids) > width:
                # Drop the OLDEST context so the scored continuation survives;
                # if the cut eats into the continuation, shrink its span.
                cut = len(ids) - width
                ids = ids[cut:]
                ctx_len, cont_len = spans[i]
                new_ctx = max(ctx_len - cut, 0)
                new_cont = cont_len - max(cut - ctx_len, 0)
                if new_ctx == 0:
                    # Position 0 has no conditioning (its slot is 0.0): drop it.
                    new_ctx, new_cont = 1, new_cont - 1
                spans[i] = (new_ctx, new_cont)
                if cut >= ctx_len:
                    logger.warning(
                        "score(): continuation truncated to %d tokens "
                        "(context window %d)", new_cont, width,
                    )
            tokens[i, : len(ids)] = ids  # RIGHT-padded for scoring
            valid[i, : len(ids)] = True

        scorer = (
            token_logprobs_streamed
            if self.config.vocab_size > _STREAMED_VOCAB_THRESHOLD
            else token_logprobs
        )
        with torch.inference_mode():
            logprobs = scorer(
                self.params, self.config, self._to_device(tokens), self._to_device(valid)
            ).cpu().numpy()

        results = []
        for i, (ctx_len, cont_len) in enumerate(spans):
            end = min(ctx_len + cont_len, width)
            span_lp = logprobs[i, ctx_len:end]
            span_ids = tokens[i, ctx_len:end]
            self.token_counts["scored"] += len(span_lp)
            results.append(
                ScoreResult(
                    tokens=tuple(self.tokenizer.token_str(t) for t in span_ids),
                    logprobs=tuple(float(v) for v in span_lp),
                )
            )
        return results

    # -- token-search sessions -----------------------------------------------

    def open_fused_token_search(self, spec: SearchSpec) -> "TorchTokenSearchSession":
        """Incremental KV-cache search session (``models/stepper.py``): one
        fused step per emitted token.  Raises :class:`FusedSessionUnavailable`
        when its caches would not fit the session budget."""
        return TorchTokenSearchSession(self, spec)

    # -- not ported yet ------------------------------------------------------

    def next_token_logprobs(self, requests):
        raise _not_ported("next_token_logprobs", "evaluation")

    def embed(self, texts):
        raise _not_ported("embed", "evaluation")


class TorchTokenSearchSession:
    """Incremental token search over persistent per-(slot x role) KV tails
    (``TPUTokenSearchSession``, ``tpu.py:2140-2398, 2644-2687``).

    Rows are slot-major: slot b occupies rows [b*(1+A), (b+1)*(1+A)) with
    role 0 = reference policy and roles 1..A = agent policies.  The prefix
    trunk is prefilled once per role; each ``advance_and_propose`` is one
    step of ``models/stepper.py``: gather surviving parents' tails, append
    the chosen token id, forward one position, Gumbel-top-k the reference
    rows and gather the proposal ids from the agents' log-softmax.  Each
    call makes one packed device-to-host fetch.

    State is token *ids*; the decoded strings in returned candidates are for
    host-side semantics (EOS sets, dedup, display).  Gumbel noise for family
    f (0 = trunk steps, 1 = suffix trees), step or salt i and slot s comes
    from a ``torch.Generator`` seeded with a fold of (session seed, f, i, s).
    """

    def __init__(self, backend: TorchBackend, spec: SearchSpec):
        if spec.speculative:
            raise _not_ported("SearchSpec.speculative", "the other methods (MCTS and its rollouts)")
        self.backend = backend
        self.spec = spec
        tok = backend.tokenizer
        prefixes = [tok.raw_prompt(spec.ref_user, spec.ref_system)] + [
            tok.raw_prompt(a_user, a_system) for a_system, a_user in spec.agent_prompts
        ]
        token_lists = [tok.encode(p, add_bos=True) for p in prefixes]
        max_prefix = backend.max_context - spec.max_steps
        if max_prefix < 16:
            raise ValueError(
                f"max_steps={spec.max_steps} leaves no prefix room inside "
                f"max_context={backend.max_context}"
            )
        token_lists = [ids[-max_prefix:] for ids in token_lists]
        self._tokens, self._valid = backend._left_pad_batch(token_lists)
        self._w0 = int(self._tokens.shape[1])
        self.n_roles = len(prefixes)
        c = backend.config
        n_rows = spec.n_slots * self.n_roles
        itemsize = torch.finfo(params_dtype(backend.params)).bits // 8
        # Trunk once per role + per-(slot x role) tails.  Trunk sessions
        # (n_slots=1) reserve 2x: every tree level materializes one
        # trunk+tail scratch copy (stepper._scratch_cache).
        cache_bytes = (
            2 * c.n_layers * (self.n_roles * self._w0 + n_rows * spec.max_steps)
            * c.n_kv_heads * c.head_dim * itemsize
        )
        if spec.n_slots == 1:
            cache_bytes *= 2
        if cache_bytes > backend._session_budget.cap:
            raise FusedSessionUnavailable(
                f"{n_rows}-row x {self._w0 + spec.max_steps}-wide session cache "
                f"(~{cache_bytes / 1e9:.1f} GB) over the "
                f"{backend._session_budget.cap / 1e9:.1f} GB session budget"
            )
        # Recorded only after acquire succeeds, so close() never releases
        # bytes that were not granted.
        backend._session_budget.acquire(cache_bytes)
        self._budget_bytes = cache_bytes
        self._step = 0
        self._state = None
        #: Device steps launched by this session (prefill, advances, levels).
        self.dispatch_count = 0
        bias = backend._bias_vector(spec.bias_against_tokens, spec.bias_value)
        self._ref_bias = backend._to_device(bias) if bias is not None else None
        if spec.seed is None:
            with backend._nonce_lock:
                backend._unseeded_calls += 1
                self._seed_parts = ("search", "unseeded", backend._unseeded_calls)
        else:
            self._seed_parts = ("search", spec.seed)

    # -- protocol ------------------------------------------------------------

    def propose(self) -> List[List[ScoredCandidate]]:
        """Root proposals (every slot starts with the empty sequence)."""
        self._check_open()
        spec = self.spec
        # k candidates x (n_roles - 1) agent evaluations per slot.
        self.backend.token_counts["scored"] += spec.n_slots * spec.k * (self.n_roles - 1)
        self.dispatch_count += 1
        out = search_prefill(
            self.backend.params, self.backend.config, self._tokens, self._valid,
            spec.n_slots, self.n_roles, spec.temperature, spec.k, spec.sample,
            spec.max_steps, ref_bias=self._ref_bias,
            generators=self._generators(0, 0, spec.n_slots),
        )
        return self._finish(out)

    def advance_and_propose(
        self, parents: Sequence[int], chosen: Sequence[ScoredCandidate]
    ) -> List[List[ScoredCandidate]]:
        """Advance slot i to ``parents[i]``'s sequence + ``chosen[i]``, then
        propose and score for the new state of every slot."""
        self._check_open()
        spec = self.spec
        if len(parents) != spec.n_slots or len(chosen) != spec.n_slots:
            raise ValueError(
                f"expected {spec.n_slots} (parent, token) pairs, got "
                f"{len(parents)}/{len(chosen)}"
            )
        if self._state is None:
            raise ValueError("call propose() before advance_and_propose()")
        if self._step >= spec.max_steps:
            raise ValueError(f"session exhausted its {spec.max_steps} steps")
        self._step += 1
        self.backend.token_counts["generated"] += spec.n_slots
        self.backend.token_counts["scored"] += spec.n_slots * spec.k * (self.n_roles - 1)
        self.backend.call_counts["search_advances"] += 1
        self.dispatch_count += 1
        out = search_step(
            self.backend.params, self.backend.config, self._state,
            [int(p) for p in parents], [c.token_id for c in chosen], self._step - 1,
            spec.n_slots, self.n_roles, spec.temperature, spec.k, spec.sample,
            ref_bias=self._ref_bias,
            generators=self._generators(0, self._step, spec.n_slots),
        )
        return self._finish(out)

    def propose_suffixes(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], salt: int
    ) -> List[List[ScoredCandidate]]:
        """Propose + score k candidates for each tree path (a suffix of
        candidates hanging off the trunk), sharing the trunk cache across
        all paths (``stepper.suffix_propose``).  Trunk sessions only
        (n_slots == 1); the trunk itself advances via advance_and_propose."""
        self._check_open()
        if self.spec.n_slots != 1:
            raise ValueError("propose_suffixes requires an n_slots=1 session")
        if self._state is None:
            raise ValueError("call propose() before propose_suffixes()")
        if not suffixes:
            return []
        if any(len(s) == 0 for s in suffixes):
            raise ValueError("suffixes must be non-empty")
        # One uniform suffix length per step: mixed lengths are grouped by
        # span, one call per span, results re-ordered.  A single span keeps
        # the caller's salt; with several, each group folds its span in.
        groups: Dict[int, List[int]] = {}
        for i, suffix in enumerate(suffixes):
            groups.setdefault(len(suffix), []).append(i)
        multi = len(groups) > 1
        results: List[Optional[List[ScoredCandidate]]] = [None] * len(suffixes)
        for span, idxs in groups.items():
            group_salt = (salt ^ (span << 20)) if multi else salt
            rows = self._propose_suffix_group([suffixes[i] for i in idxs], span, group_salt)
            for i, row in zip(idxs, rows):
                results[i] = row
        return results

    def _propose_suffix_group(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], span: int, salt: int
    ) -> List[List[ScoredCandidate]]:
        """One ``suffix_propose`` call over equal-length suffixes, the path
        count padded to a bucket by repeating row 0."""
        spec = self.spec
        # Each path re-evaluates its span under every agent and proposes k
        # scored candidates.
        self.backend.token_counts["scored"] += len(suffixes) * (span + spec.k) * (self.n_roles - 1)
        n_paths = _bucket(len(suffixes), minimum=4)
        tokens = np.zeros((n_paths, span), np.int32)
        for i, suffix in enumerate(suffixes):
            tokens[i] = [c.token_id for c in suffix]
        tokens[len(suffixes):] = tokens[0]
        self.dispatch_count += 1
        packed = suffix_propose(
            self.backend.params, self.backend.config, self._state, self._step,
            self.backend._to_device(tokens), self.n_roles, spec.temperature, spec.k,
            spec.sample, ref_bias=self._ref_bias,
            generators=self._generators(1, salt, n_paths),
        )
        return self._unpack(packed.cpu().numpy()[: len(suffixes)])

    def rollout_from(self, suffix, depth: int, salt: int):
        raise _not_ported("rollout_from", "the other methods (MCTS and its rollouts)")

    def rollout_many(self, suffixes, depth: int, salts):
        raise _not_ported("rollout_many", "the other methods (MCTS and its rollouts)")

    def close(self) -> None:
        """Drop the device caches and release the session's budget.
        Idempotent; also runs at garbage collection as a safety net."""
        # getattr: the constructor may raise before the reservation exists.
        if getattr(self, "_budget_bytes", 0):
            self._state = None
            self.backend._session_budget.release(self._budget_bytes)
            self._budget_bytes = 0

    def __del__(self):
        self.close()

    # -- internals -----------------------------------------------------------

    def _check_open(self) -> None:
        if not getattr(self, "_budget_bytes", 0):
            raise ValueError("session is closed")

    def _generators(self, family: int, index: int, n: int) -> Optional[List[torch.Generator]]:
        """One Gumbel generator per slot (or path) for one step; None when
        the proposals are deterministic top-k."""
        if not self.spec.sample:
            return None
        generators = []
        for slot in range(n):
            g = torch.Generator(device=self.backend.device)
            g.manual_seed(self.backend._fold_seed(*self._seed_parts, family, index, slot))
            generators.append(g)
        return generators

    def _finish(self, out) -> List[List[ScoredCandidate]]:
        self._state = out.state
        return self._unpack(out.packed.cpu().numpy())

    def _unpack(self, packed: np.ndarray) -> List[List[ScoredCandidate]]:
        tok = self.backend.tokenizer
        results = []
        for row in range(packed.shape[0]):
            row_out = []
            for j in range(self.spec.k):
                token_id = int(packed[row, j, 0])
                row_out.append(
                    ScoredCandidate(
                        token=tok.token_str(token_id),
                        token_id=token_id,
                        ref_logprob=float(packed[row, j, 1]),
                        agent_logprobs=tuple(float(v) for v in packed[row, j, 2:]),
                    )
                )
            results.append(row_out)
        return results
