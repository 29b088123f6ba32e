"""On-device model backend for the GPU: the PyTorch counterpart of
``consensus_tpu/backends/tpu.py`` (``TPUBackend``), with its defaults.

It owns a resident transformer (Gemma-2 / Llama-3 family or a tiny test
config) and runs each protocol call as padded device batches:

* ``generate`` -- routes as ``tpu.py:608-1014`` does.  A group of at least
  four identical prompts that is the whole batch (or at least 16 rows)
  decodes from ONE shared prompt trunk (``shared_trunk_generation``);
  everything else takes the classic per-row path.  Budgets of at least two
  segments decode in ``decode_segment_len``-step segments
  (``segmented_decode``) with int8 generated KV (``kv_quant``), unless
  ``use_decode_attention`` asks for the decode kernel, which only the
  monolithic loops reach.  Per-request temperature, logit-bias sets, EOS
  ids, host-side stop-string truncation (``tpu.py:815-855, 1016-1060``).
* ``score`` -- right-padded teacher-forced forward (``_score_impl``,
  ``tpu.py:1253-1338``) with the same row and width buckets, truncation
  rules and streamed-vocab threshold; its attention is the hand-written
  flash kernel when ``use_flash_attention`` is set.  With
  ``shared_context_scoring`` requests sharing a context prefill it once and
  score their continuations against it (``tpu.py:1080-1251``).
* ``score_matrix`` -- the fused (candidates x agents) utility matrix over a
  KV page pool, reduced on the device (``tpu.py:1340-1638``); rows that
  need the per-call truncation fall back to ``score``.
* ``embed`` -- the masked mean-pool of the final hidden states, unit norm
  (``tpu.py:1743-1778``), through the flash kernel with
  ``use_flash_attention``: the evaluator's cosine utilities.
* ``next_token_logprobs`` -- k candidate next tokens per request from one
  cacheless forward (``models/generate.py::next_token_topk``, rows bucketed
  to at least 8, ``tpu.py:1642-1730``), through the flash kernel with
  ``use_flash_attention``: the full-prefix fallback session's primitive.
* ``open_fused_token_search`` -- :class:`TorchTokenSearchSession`, the
  incremental KV-cache search session of beam search, finite lookahead and
  MCTS (``tpu.py:1731-1739, 2140-2687``), with scored rollouts, batched and
  speculative; its step attends through the hand-written decode kernel when
  ``use_decode_attention`` is set (the rollouts take the einsum route, as
  the reference's do).
* ``generate_stream`` -- the decode engine's multi-token seam
  (``tpu.py:619-643, 1797-2138``): a cohort prefilled into a private page
  pool and decoded in K-step windows of ``stepper.paged_decode_steps``, or
  with ``speculative`` in draft-and-verify windows of
  ``stepper.paged_verify_steps`` (plain ``paged_attention``, as in the
  reference); ``suggest_kv_page_pool``
  sizes the engine's page pool from the session budget.

Data parallelism (``dp=N``, ``mesh="dp=N,tp=1"`` or a ``MeshPlan``,
``tpu.py:155-183, 359-372``): the params replicate to each dp shard's card
(``mesh_devices``, default the visible cards; dp CPU shards with
``device="cpu"``), and the rows of every padded batch split into dp
contiguous blocks, each run on its shard's card with that card's replica,
every shard launched before any is waited on and the outputs gathered in
row order; a batch whose rows do not divide dp runs on shard 0.  The row
arithmetic is the JAX package's (row buckets times dp, targets divisible
by dp).  Search sessions split their slots over the shards; the decode
engine's streams run each row on the card of its engine shard.

Tensor parallelism (``tp=M``, ``mesh="dp=N,tp=M"`` or a ``MeshPlan`` with
tp > 1): each dp shard's model runs over its row of tp cards
(``parallel/tensor.py``): the params are quantized first, then sliced
(``tpu.py:349``), every rank runs its heads and FFN columns on its card
with two sums a layer, and every cache holds each rank's kv heads on its
card.  Host reads happen on the lead (rank 0's) card, so nothing above the
model layer changes; per-card KV budgets divide by tp.

Weights: ``checkpoint`` names a raw HF safetensors directory
(``models/loader.py``) or one written by ``cli/ingest_checkpoint.py`` in
the port's own format (``utils/checkpoint.py``), as ``tpu.py:264-331``;
``params`` passes a parameter dict; with neither the weights are random,
drawn from ``base_seed``.

``pin_generation_budget`` is the reference's timing mode (every generation
to its full budget: no EOS stop, no stop strings).  Every call records into
``self.instruments`` (``obs/backends.py``) at the counterparts of
``tpu.py``'s sites, under its label ``tpu``.  The shared counters
(``call_counts``, ``token_counts``, ``matrix_stats``) are safe under
concurrent callers: fused search sessions run on the experiment's worker
threads beside the batching layer's flushes.  A tp that does not divide
the model's heads, kv heads, FFN width or vocab raises ``ValueError``
naming the count.

Seeds: each request's seed folds into its OWN row threefry key exactly as
``tpu.py:579-603`` does (``utils/threefry.py`` is bit for bit
``jax.random``), so a request's output does not depend on which other
requests share its batch, and a seed draws the JAX package's tokens
wherever both models give the same logits.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import logging
import pathlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from consensus_tpu_torch.backends.base import (
    GenerationRequest,
    GenerationResult,
    NextTokenRequest,
    ScoreRequest,
    ScoreResult,
    TokenCandidate,
)
from consensus_tpu_torch.backends.session import (
    FusedSessionUnavailable,
    ScoredCandidate,
    SearchSpec,
)
from consensus_tpu_torch.backends.speculative import NGramProposer
from consensus_tpu_torch.backends.score_matrix import (
    ScoreMatrixResult,
    fallback_score_matrix_many,
    record_matrix,
    reduce_matrix,
)
from consensus_tpu_torch.models import generate as gen
from consensus_tpu_torch.models import stepper
from consensus_tpu_torch.models.config import ModelConfig, get_model_config
from consensus_tpu_torch.models.loader import load_params
from consensus_tpu_torch.models.quant import is_quantized, quantize_params
from consensus_tpu_torch.models.stepper import (
    rollout_scored,
    rollout_scored_many,
    rollout_verify_many,
    search_prefill,
    search_step,
    suffix_propose,
)
from consensus_tpu_torch.models.tokenizer import get_tokenizer
from consensus_tpu_torch.models.transformer import (
    forward,
    init_params,
    params_dtype,
    project_logits,
    shared_context_cont_logprobs,
    shared_context_prefill,
    token_logprobs,
    token_logprobs_streamed,
)
from consensus_tpu_torch.obs.backends import BackendInstruments
from consensus_tpu_torch.parallel.mesh import (
    MeshPlan,
    make_mesh,
    param_shardings,
    parse_mesh_spec,
    shard_params,
)
from consensus_tpu_torch.parallel.tensor import check_tp, local_config, to_devices, tp_group
from consensus_tpu_torch.utils import threefry
from consensus_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: Above this vocab size the streaming scorer replaces full-logit scoring.
_STREAMED_VOCAB_THRESHOLD = 32_768
#: Cap on the shared-scoring suffix attention's per-layer fp32 logits
#: (rows x heads x span x (ctx + span) x 4 B): it has no flash kernel, so
#: row chunks halve until it fits and larger groups score per call.
_SHARED_SCORE_ATTN_BYTES_CAP = 1 << 31  # 2 GB
#: Below this many identical-prompt rows the shared-trunk path is not taken.
_SHARED_TRUNK_MIN_ROWS = 4
#: A smaller identical-prompt group inside a larger batch decodes with the
#: classic rows: one classic batch shares each step's weight read among all
#: of its rows.
_SHARED_TRUNK_SOLO_ROWS = 16
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


def _card_shares(devices: Sequence[torch.device]) -> List[int]:
    """For each dp shard's device, how many shards of the plan sit on that
    card (a plan may repeat a card): they split its memory budget.  CPU
    shards stand for separate devices, as the JAX package's virtual CPU
    devices do, and keep the whole (nominal) CPU budget each."""
    names = [str(d) for d in devices]
    return [names.count(n) if d.type == "cuda" else 1 for n, d in zip(names, devices)]


def _most_ranks_on_a_card(group: Sequence[torch.device]) -> int:
    """The most ranks of a tp group that any one card holds (CPU entries
    stand for separate devices, as in :func:`_card_shares`)."""
    names = [str(d) for d in group if d.type == "cuda"]
    return max([names.count(n) for n in names] or [1])


def _kv_heads_per_card(config: ModelConfig, group: Sequence[torch.device]) -> int:
    """The kv heads whose KV state one card of a tp group holds: each
    rank's kv heads (``local_config``; copies of a shared head count once
    for every rank that holds one) times the most ranks any one card
    holds."""
    return local_config(config, len(group)).n_kv_heads * _most_ranks_on_a_card(group)


def _q_heads_per_card(config: ModelConfig, group: Sequence[torch.device]) -> int:
    """The query heads whose prefill logits one card of a tp group holds:
    each rank's query heads (``local_config``; a head that tp splits is
    copied whole to every rank that owns part of it) times the most ranks
    any one card holds."""
    return local_config(config, len(group)).n_heads * _most_ranks_on_a_card(group)


def _session_budget_for(device_budget: int) -> _SessionBudget:
    """The live-session budget of a card with ``device_budget`` bytes beside
    its weights: what is left after the activation reserve, between the
    floor and the cap."""
    return _SessionBudget(min(
        _SESSION_CACHE_BYTES_CAP,
        max(_SESSION_MIN_BUDGET_BYTES, device_budget - _ACTIVATION_RESERVE_BYTES),
    ))


def _bucket(n: int, minimum: int = 32) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _group_by_span(suffixes: Sequence[Sequence]) -> Dict[int, List[int]]:
    """Indices of ``suffixes`` grouped by length, in first-seen order: a
    session call runs one suffix length at a time."""
    groups: Dict[int, List[int]] = {}
    for i, suffix in enumerate(suffixes):
        groups.setdefault(len(suffix), []).append(i)
    return groups


def _width_bucket(n: int, minimum: int = 128) -> int:
    """Sequence-length bucket on the {1, 1.5} x power-of-two ladder
    (128, 192, 256, 384, 512, ...), as ``tpu.py:124-135``."""
    size = minimum
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size


@dataclasses.dataclass
class _Shard:
    """One dp shard's part of a batch: its index, replica, card and row
    block (``rows`` rows from ``lo``; every row when ``split`` is off)."""

    index: int
    params: Any
    device: torch.device
    rows: Optional[int]
    lo: int
    split: bool

    def put(self, tensor: Optional[torch.Tensor], rows: bool = True) -> Optional[torch.Tensor]:
        if tensor is None:
            return None
        if rows and self.split:
            tensor = tensor[self.lo : self.lo + self.rows]
        return tensor.to(self.device)

    def put_kwargs(self, kwargs: Dict[str, Any], whole: Sequence[str] = ("eos_ids", "bias_table")):
        """``put`` over a kwargs dict: row tensors split, ``whole`` ones not."""
        return {
            key: self.put(value, rows=key not in whole) if isinstance(value, torch.Tensor) else value
            for key, value in kwargs.items()
        }


def _device_guard(device: torch.device):
    """Make ``device`` the current card of this thread while its work is
    issued (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class TorchBackend:
    name = "torch"

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
        shared_trunk_generation: bool = True,
        pin_generation_budget: bool = False,
        segmented_decode: bool = True,
        decode_segment_len: int = 128,
        kv_quant: bool = True,
        quantize_frozen_kv: Optional[bool] = None,
        mesh: Optional[Any] = None,
        device: Optional[str] = None,
        mesh_devices: Optional[Sequence[str]] = None,
    ):
        # ``mesh`` is the serving-path spelling of the tp/dp pair
        # (``tpu.py:172-183``): a {'dp': N, 'tp': M} dict, a "dp=4,tp=2"
        # string, or a MeshPlan, which also names the devices.  Explicit
        # tp=/dp= win when both are given.
        plan = mesh if isinstance(mesh, MeshPlan) else None
        if plan is not None:
            if mesh_devices is not None:
                raise ValueError("mesh_devices conflicts with a MeshPlan, which names its devices")
            tp, dp = plan.tp, plan.dp
        elif mesh is not None:
            parsed = parse_mesh_spec(mesh)
            if tp == 1:
                tp = parsed["tp"]
            if dp is None:
                dp = parsed["dp"]
        tp = int(tp)
        # The older name of ``kv_quant``, kept as an alias (``tpu.py:232-233``).
        if quantize_frozen_kv is not None:
            kv_quant = bool(quantize_frozen_kv)
        if quantization not in (None, "none", "int8"):
            raise ValueError(f"unknown quantization mode: {quantization!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; want one of {sorted(_DTYPES)}")

        self.shared_context_scoring = bool(shared_context_scoring)
        self.shared_trunk_generation = bool(shared_trunk_generation)
        self.segmented_decode = bool(segmented_decode)
        self.decode_segment_len = max(16, int(decode_segment_len))
        self._seg_len_fallbacks: set = set()  # budgets already logged
        self.kv_quant = bool(kv_quant)
        #: Timing mode (``tpu.py:235-239``): every generation runs to its
        #: full ``max_tokens`` budget -- no EOS early exit, no stop-string
        #: truncation -- so random-weight timing runs measure the workload
        #: real weights would run.  Never use for quality runs.
        self.pin_generation_budget = bool(pin_generation_budget)
        dp = int(dp or 1)
        if mesh_devices is not None and dp * tp == 1:
            raise ValueError("mesh_devices names the cards of a dp > 1 mesh; dp is 1")
        if plan is None and dp * tp > 1:
            # dp shards of tp cards each (``tpu.py:359-372``): the first
            # dp * tp of ``mesh_devices`` (which may repeat a card) or of the
            # visible cards, or CPU entries when the caller asks for the CPU.
            if mesh_devices is None and resolve_device(device).type == "cpu":
                mesh_devices = [resolve_device(device)] * (dp * tp)
            plan = make_mesh(mesh_devices, tp=tp, dp=dp)
        #: The (dp, tp) device grid this backend serves over; None on one
        #: device.  Params replicate over ``data`` and every batch's rows
        #: split into dp contiguous blocks, one per shard; each shard's
        #: model runs tensor-parallel over its row of tp cards.
        self.mesh = plan if plan is not None and plan.n_devices > 1 else None
        #: The dp part of the mesh (None without dp shards): the row blocks,
        #: shard views and shard threads follow it.
        self.mesh_plan = plan if plan is not None and plan.dp > 1 else None
        self._dp = plan.dp if plan is not None else 1
        self._tp = plan.tp if plan is not None else 1
        self.device = plan.data_devices[0] if plan is not None else resolve_device(device)
        #: The tp group of this backend's (first) shard: the lead first.
        self._tp_devices = plan.devices[0] if plan is not None else (self.device,)
        #: Whether a greedy request decodes the same tokens whatever batch it
        #: shares (the Habermas Machine then elides its no-op ranking
        #: retries, as with ``TPUBackend``).  Not on the card: chip_smoke's
        #: greedy_batch_invariance saw one 200-token request of llama3-8b
        #: (int8) change at step 8 in a 9-request batch and at step 105 in
        #: a 32-request batch against alone (NVIDIA H100 80GB HBM3): the
        #: GEMMs of other row buckets round differently.
        self.deterministic_greedy = self.device.type != "cuda"
        self.config = config if config is not None else get_model_config(model)
        if use_flash_attention and not self.config.use_flash_attention:
            self.config = dataclasses.replace(self.config, use_flash_attention=True)
        if use_decode_attention and not self.config.use_decode_attention:
            self.config = dataclasses.replace(self.config, use_decode_attention=True)
        self.model_name = model
        family = "llama" if "llama" in self.config.name else "gemma"
        self.tokenizer = get_tokenizer(tokenizer, family=family)
        # A tokenizer-sized vocab keeps random-weight runs self-consistent;
        # a checkpoint keeps the model's vocab (the byte tokenizer then uses
        # its first ids only).
        if self.tokenizer.vocab_size != self.config.vocab_size and checkpoint is None:
            self.config = dataclasses.replace(
                self.config, vocab_size=self.tokenizer.vocab_size
            )
        self.max_context = max_context
        self.base_seed = base_seed
        self.max_batch_rows = max(1, max_batch_rows)
        self.quantization = quantization if quantization != "none" else None
        check_tp(self.config, self._tp)

        if params is not None:
            self.params = params
            if self.quantization == "int8" and not is_quantized(params):
                self.params = quantize_params(params)
        elif checkpoint and (pathlib.Path(checkpoint) / "ingest.json").exists():
            self.params = self._restore_ingested(checkpoint, dtype, plan if self._tp > 1 else None)
        elif checkpoint:
            # A raw HF safetensors directory: each tensor lands on the device
            # in the backend's dtype and, with int8, is quantized there.
            self.params = load_params(
                checkpoint, self.config, _DTYPES[dtype], self.device,
                int8=self.quantization == "int8",
            )
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

        #: Each dp shard's replica of the params, on its card (shard 0's is
        #: ``self.params``; shards on one card share one copy).  At tp > 1
        #: each is a TPParams, quantized first, then sliced over the shard's
        #: row of cards (``tpu.py:349``); the whole tree is then dropped.
        if isinstance(self.params, list):  # restored straight into each row's ranks
            self._shard_params = self.params
            self.params = self._shard_params[0]
        elif self.mesh is None:
            self._shard_params = [self.params]
        elif self._tp == 1:
            self._shard_params = [row[0] for row in shard_params(self.params, plan)]
        else:
            self._shard_params = [
                tp_group(trees, plan.devices[d], self.config)
                for d, trees in enumerate(shard_params(self.params, plan, self.config))
            ]
            self.params = self._shard_params[0]
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

        self._bias_id_cache: Dict[str, Tuple[int, ...]] = {}
        self.call_counts = {
            "generate": 0, "score": 0, "score_batches": 0, "search_advances": 0,
            "score_matrix": 0, "embed": 0, "next_token": 0,
        }
        self.token_counts = {"generated": 0, "scored": 0}
        #: Fused utility matrices: calls, device chunks, per-call fallbacks.
        self.matrix_stats = {"calls": 0, "chunks": 0, "fallbacks": 0}
        #: Guards the three tables above: fused search sessions bypass the
        #: batching layer's single-file flush, so the experiment's worker
        #: threads update them at once.
        self._stats_lock = threading.Lock()
        #: obs: padding, padded-shape first sightings and transfer times,
        #: recorded at the counterparts of ``tpu.py``'s sites under its label
        #: ``tpu``, so the metric families match the JAX backend's.
        self.instruments = BackendInstruments("tpu")
        self._unseeded_calls = 0
        self._nonce_lock = threading.Lock()
        #: The backend whose nonce a shard view draws (itself here).
        self._nonce_owner = self
        #: The device memory left beside the resident weights, read ONCE,
        #: now: the counterpart of the reference's fixed ``_HBM_BYTES -
        #: params`` (``tpu.py:412-419``, ``:728-731``).  Row buckets and the
        #: session budget derive from it, so a request's shapes do not follow
        #: what other tenants of the card (another fleet replica, the CUDA
        #: cache) hold at call time.
        self._device_budget = self._free_device_bytes()
        self._session_budget = _session_budget_for(self._device_budget)
        #: One single-device view of this backend per dp shard (its
        #: replica, its card, that card's budgets): the engine's streams and
        #: the search sessions run on them.  None on one device.
        self._shards: Optional[List["TorchBackend"]] = None
        self._shard_pool = None
        self._session_turn = 0
        #: How many dp shards share this backend's card (a shard view's
        #: row buckets take that share of the card's budget).
        self._card_share = 1
        #: The kv heads whose KV state one card holds: tp splits the kv
        #: heads over the group's cards (``tpu.py:401-411``) where it divides
        #: them, else each rank holds copies of the heads its query heads
        #: read; a card that repeats in the group holds every rank on it.
        self._kv_heads_per_card = _kv_heads_per_card(self.config, self._tp_devices)
        #: The query heads whose fp32 prefill logits one card holds, copies
        #: of a split head included: the row buckets' logit bytes count them.
        self._q_heads_per_card = _q_heads_per_card(self.config, self._tp_devices)
        if self.mesh_plan is not None:
            budgets = {str(self.device): (self._device_budget, self._session_budget)}
            shares = _card_shares(self.mesh_plan.data_devices)
            self._shards = [self._shard_view(i, budgets, shares[i]) for i in range(self._dp)]

    def _restore_ingested(self, checkpoint: str, dtype: str, plan: Optional[MeshPlan] = None):
        """Parameters of a directory written by ``cli/ingest_checkpoint.py``,
        restored to the device in their stored form (int8 leaves stay as
        stored: no quantize pass), after the manifest is checked against this
        backend's model, dtype and quantization (``tpu.py:264-322``).  With
        a tensor-parallel ``plan`` each rank reads only its own slices,
        straight onto its card: one TPParams per dp row."""
        from consensus_tpu_torch.cli.ingest_checkpoint import read_manifest
        from consensus_tpu_torch.utils.checkpoint import checkpoint_template, restore_params

        meta = read_manifest(checkpoint)
        mismatches = []
        if meta.get("model") and meta["model"] != self.config.name:
            mismatches.append(
                f"model: ingested {meta['model']!r} vs backend {self.config.name!r}"
            )
        if meta.get("dtype") and meta["dtype"] != dtype:
            mismatches.append(f"dtype: ingested {meta['dtype']!r} vs backend {dtype!r}")
        ingested_quant = meta.get("quantization") or None
        if ingested_quant != self.quantization:
            mismatches.append(
                f"quantization: ingested {ingested_quant!r} vs backend "
                f"{self.quantization!r} — re-run cli/ingest_checkpoint with "
                "the matching --quantization"
            )
        if mismatches:
            raise ValueError(
                f"ingested checkpoint {checkpoint} does not match this "
                "backend: " + "; ".join(mismatches)
            )
        params_dir = str(pathlib.Path(checkpoint) / "params")
        if plan is None:
            return restore_params(params_dir, self.device)
        shardings = param_shardings(checkpoint_template(params_dir), plan, self.config)
        return [tp_group(row, plan.devices[d], self.config)
                for d, row in enumerate(restore_params(params_dir, shardings=shardings))]

    # -- data-parallel shards ------------------------------------------------

    def _shard_view(self, index: int, budgets: Dict[str, tuple], share: int) -> "TorchBackend":
        """A single-device view of this backend on dp shard ``index``: the
        same tokenizer, counters, instruments and nonce; its own replica,
        card and (per card) memory budgets, of which its row buckets take
        one ``share``-th."""
        view = copy.copy(self)
        view.params = self._shard_params[index]
        view.device = self.mesh_plan.data_devices[index]
        view._tp_devices = self.mesh_plan.devices[index]
        view.mesh = None
        view.mesh_plan = None
        view._dp = 1
        view._shards = None
        view._shard_params = [view.params]
        key = str(view.device)
        if key not in budgets:
            free = view._free_device_bytes()
            budgets[key] = (free, _session_budget_for(free))
        view._device_budget, view._session_budget = budgets[key]
        view._card_share = share
        return view

    def _map_shards(self, fn: Callable[[int], Any], indices: Sequence[int]) -> List[Any]:
        """``fn(i)`` for each shard index, on the shard threads (each with its
        card current and inference mode on), so that every shard's work is
        issued before any is waited on."""
        if self._shard_pool is None:
            self._shard_pool = ThreadPoolExecutor(
                max_workers=self._dp, thread_name_prefix="dp-shard"
            )
        devices = self.mesh_plan.data_devices

        def run(i: int):
            with torch.inference_mode(), _device_guard(devices[i]):
                return fn(i)

        return list(self._shard_pool.map(run, indices))

    def _on_shards(self, body: Callable[["_Shard"], Any], n_rows: Optional[int] = None) -> List[Any]:
        """Run ``body(shard)`` once per dp shard, every shard's work launched
        before any is waited on; returns the per-shard results in shard order.

        ``shard.put(tensor)`` gives the shard's contiguous block of the
        tensor's leading (row) axis on the shard's card, ``shard.put(tensor,
        rows=False)`` the whole tensor there; ``shard.rows`` is the block's
        row count.  With ``n_rows`` not a multiple of dp the rows do not
        split: shard 0 runs them all, as the JAX package leaves such a batch
        replicated (``tpu.py:495-508``).  Without ``n_rows`` every shard gets
        whole tensors (a replicated step, such as a shared prefill)."""
        split = n_rows is not None and self._dp > 1 and n_rows % self._dp == 0
        if self._dp == 1 or (n_rows is not None and not split):
            with torch.inference_mode():
                return [body(_Shard(0, self.params, self.device, n_rows, 0, False))]
        block = n_rows // self._dp if split else n_rows
        devices = self.mesh_plan.data_devices
        return self._map_shards(
            lambda i: body(_Shard(i, self._shard_params[i], devices[i], block,
                                  i * block if split else 0, split)),
            range(self._dp),
        )

    def _gather(self, outs: List[Any]) -> Any:
        """Per-shard results -> one, rows concatenated in shard order on
        ``self.device`` (a tensor, or a tuple of tensors field by field)."""
        if len(outs) == 1:
            return outs[0]
        first = outs[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([o.to(self.device) for o in outs])
        fields = [self._gather([o[i] for o in outs]) for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)

    def _run_rows(self, body: Callable, n_rows: int) -> Any:
        """:meth:`_on_shards` over ``n_rows`` rows, gathered."""
        return self._gather(self._on_shards(body, n_rows))

    def _next_nonce(self) -> int:
        """The next unseeded-call nonce, shared by every shard view."""
        owner = self._nonce_owner
        with owner._nonce_lock:
            owner._unseeded_calls += 1
            return owner._unseeded_calls

    # -- helpers -------------------------------------------------------------

    def kv_cache_identity(self) -> tuple:
        """Content-key identity for cross-request prefix KV reuse: model,
        KV mode and tensor-parallel width (``tpu.py:423-436``): a tp=2
        backend's pages hold each card's half of the kv heads.  dp does not
        enter: pages replicate over data."""
        return (self.model_name, "int8" if self.kv_quant else "dense", ("tp", self._tp))

    def suggest_kv_page_pool(self, page_size: int = 16) -> int:
        """Size the decode engine's KV page pool from the session budget
        (``tpu.py:438-459``): half the budget goes to pages (the rest stays
        for fused search sessions); one page holds ``page_size`` tokens of
        per-layer K+V, at 1.25 bytes an element under ``kv_quant`` (int8
        plus its per-token scale).  The count includes the prefix cache's
        share, which the engine's LRU budget bounds."""
        c = self.config
        kv_itemsize = (
            1.25 if self.kv_quant else torch.finfo(params_dtype(self.params)).bits // 8
        )
        bytes_per_token = (
            int(2 * c.n_layers * self._kv_heads_per_card * c.head_dim * kv_itemsize) or 1
        )
        return max(64, (self._session_budget.cap // 2) // (bytes_per_token * page_size))

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

    def _tally(self, table: Dict[str, int], key: str, amount: int) -> None:
        with self._stats_lock:
            table[key] += amount

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        with self.instruments.time_h2d():
            return torch.from_numpy(array).to(self.device)

    def _fetch(self, *tensors: torch.Tensor):
        """Device tensors -> numpy, timed as D2H.  CUDA work is asynchronous,
        so the fetch waits for the device work still in flight: the reading
        is an upper bound that includes device execution (``tpu.py:510-521``)."""
        with self.instruments.time_d2h():
            out = tuple(t.cpu().numpy() for t in tensors)
        return out if len(tensors) > 1 else out[0]

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

    @staticmethod
    def _fold(*parts) -> int:
        """A 4-byte blake2b digest of ``parts`` mod 2**31 (stable across
        processes, unlike ``hash()``), ``tpu.py:579-585``."""
        digest = hashlib.blake2b(repr(parts).encode(), digest_size=4).digest()
        return int.from_bytes(digest, "big") % (2**31)

    def _fold_seed(self, *parts) -> torch.Tensor:
        """A (2,) key on the device: ``fold_in(PRNGKey(base_seed), fold)``."""
        return threefry.fold_in(threefry.prng_key(self.base_seed, self.device), self._fold(*parts))

    def _row_keys(self, kind: str, seeds: Sequence[Optional[int]]) -> torch.Tensor:
        """(B, 2) per-row keys (``tpu.py:587-603``), made by one ``fold_in``
        over the rows' folds.  Seeded rows fold their own seed only; unseeded
        rows fold their row index plus a per-backend nonce, so identical
        unseeded prompts in one batch draw distinct streams."""
        folds = []
        for row, seed in enumerate(seeds):
            if seed is None:
                nonce = self._next_nonce()
                folds.append(self._fold(kind, "unseeded", row, nonce))
            else:
                folds.append(self._fold(kind, seed))
        base = threefry.prng_key(self.base_seed, self.device)
        return threefry.fold_in(base, torch.tensor(folds, dtype=torch.int64, device=self.device))

    def _free_device_bytes(self) -> int:
        """What the device has free, this process's cached blocks included
        (read once, when the weights are resident: ``_device_budget``)."""
        if self.device.type != "cuda":
            return _CPU_BUDGET_BYTES
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(
            self.device
        )
        return free + cached

    def _rows_for(self, row_bytes: int) -> int:
        """Largest batch of ``row_bytes``-per-row decode state that fits the
        fixed device budget beside the live search sessions, rounded down to
        the {1, 1.5} x power-of-two ladder (``tpu.py:717-748``).  Shards on
        one card split its budget, each keeping its own activation reserve."""
        if self._shards is not None:
            # dp shards hold dp x the rows of the tightest one; scaling the
            # per-shard ladder keeps every chunk divisible by dp
            # (``tpu.py:745-748``).
            return min(view._rows_for(row_bytes) for view in self._shards) * self._dp
        budget = (
            (self._device_budget - self._session_budget.used) // self._card_share
            - _ACTIVATION_RESERVE_BYTES
        )
        allowed = max(1, budget // max(1, row_bytes))
        bucket = 1
        while bucket * 2 <= allowed:
            bucket *= 2
        if bucket >= 2 and bucket + bucket // 2 <= allowed:
            bucket += bucket // 2
        return bucket

    def _kv_bytes_per_column(self) -> int:
        c = self.config
        itemsize = torch.finfo(params_dtype(self.params)).bits // 8
        return 2 * c.n_layers * self._kv_heads_per_card * c.head_dim * itemsize

    def _generate_rows_allowed(self, prompt_width: int, max_new: int) -> int:
        """Rows of a monolithic decode: a cache of ``prompt_width + max_new``
        columns per row plus the prefill's per-layer fp32 logits and their
        softmax over that cache."""
        columns = prompt_width + max_new
        prefill_row = 2 * self._q_heads_per_card * prompt_width * columns * 4
        return self._rows_for(columns * self._kv_bytes_per_column() + prefill_row)

    def _segmented_rows_allowed(self, prompt_width: int, max_new: int, seg_len: int) -> int:
        """Rows of a SEGMENTED decode (``tpu.py:683-715``): per row the prompt
        trunk, the frozen blocks (max_new - seg_len columns), the live tail
        and one seg_len of compaction-gather transient.  With ``kv_quant``
        the blocks, the tail and the per-row trunk are int8 (half the
        bytes, plus seg_len / 4 columns for the scales), and the binding
        moment for a wide prompt is its prefill -> quantize transient.  Plus
        the prefill's per-layer fp32 logits over the trunk."""
        gen_cols = (max_new - seg_len) + 2 * seg_len + seg_len
        if self.kv_quant:
            q_cols = (gen_cols + 1) // 2 + seg_len // 4
            effective = max(
                prompt_width + prompt_width // 2 + 2 * seg_len,
                (prompt_width + 1) // 2 + prompt_width // 16 + q_cols,
            )
        else:
            effective = prompt_width + gen_cols
        prefill_row = 2 * self._q_heads_per_card * prompt_width * prompt_width * 4
        return self._rows_for(effective * self._kv_bytes_per_column() + prefill_row)

    def _seg_len_for(self, max_new: int) -> Optional[int]:
        """Segment length for a decode budget, or None for one monolithic
        loop (``tpu.py:646-681``).  Budgets under two segments stay
        monolithic, and so does every budget with ``use_decode_attention``:
        the decode kernel has no frozen-block variant.  The length must
        divide the bucketed budget: 128 fits 256/384/512/768/1024, 96 the
        192 bucket."""
        if not self.segmented_decode or self.config.use_decode_attention:
            return None
        for seg_len in (self.decode_segment_len, 96, 64):
            if max_new >= 2 * seg_len and max_new % seg_len == 0:
                if seg_len != self.decode_segment_len and max_new not in self._seg_len_fallbacks:
                    self._seg_len_fallbacks.add(max_new)
                    logger.info(
                        "segmented decode: budget %d is not a multiple of "
                        "decode_segment_len=%d >= 2x; using seg_len=%d",
                        max_new, self.decode_segment_len, seg_len,
                    )
                return seg_len
        return None

    # -- generate ------------------------------------------------------------

    def generate(
        self, requests: Sequence[GenerationRequest], shards: Optional[Sequence[int]] = None
    ) -> List[GenerationResult]:
        """Slices of up to 256 requests: the shared-trunk path prefills one
        row, so a wide group of identical prompts decodes in one loop; the
        classic path re-caps itself at ``max_batch_rows``.

        ``shards`` (the decode engine's, over dp shards) names each
        request's shard: each shard's requests then run as one batch on
        that shard's card, rather than split by position."""
        if not requests:
            return []
        if shards is not None and self._shards is not None:
            groups: Dict[int, List[int]] = {}
            for row, shard in enumerate(shards):
                groups.setdefault(shard % self._dp, []).append(row)
            parts = self._map_shards(
                lambda s: self._shards[s].generate([requests[r] for r in groups[s]]), list(groups)
            )
            results: List[Optional[GenerationResult]] = [None] * len(requests)
            for s, part in zip(groups, parts):
                for row, result in zip(groups[s], part):
                    results[row] = result
            return results  # type: ignore[return-value]
        return self._sliced(list(requests), self._generate_impl, limit=256)

    def _generate_impl(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        """Route (``tpu.py:750-813``): a group of identical prompts takes the
        shared-trunk decode when it has at least ``_SHARED_TRUNK_MIN_ROWS``
        rows and is the whole batch or at least ``_SHARED_TRUNK_SOLO_ROWS``;
        every other request takes the classic per-row path, in one batch."""
        token_lists = [
            self.tokenizer.encode(self._render_prompt(r), add_bos=True) for r in requests
        ]
        if not self.shared_trunk_generation:
            return self._generate_classic(requests, token_lists)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, ids in enumerate(token_lists):
            groups.setdefault(tuple(ids), []).append(i)

        def takes_shared_path(ids, idxs) -> bool:
            return bool(ids) and len(idxs) >= _SHARED_TRUNK_MIN_ROWS and (
                len(idxs) >= _SHARED_TRUNK_SOLO_ROWS or len(idxs) == len(requests)
            )

        if not any(takes_shared_path(ids, idxs) for ids, idxs in groups.items()):
            return self._generate_classic(requests, token_lists)
        results: List[Optional[GenerationResult]] = [None] * len(requests)
        classic: List[int] = []
        for ids, idxs in groups.items():
            if takes_shared_path(ids, idxs):
                sub = self._generate_shared([requests[i] for i in idxs], list(ids))
                for i, result in zip(idxs, sub):
                    results[i] = result
            else:
                classic.extend(idxs)
        if classic:
            sub = self._generate_classic(
                [requests[i] for i in classic], [token_lists[i] for i in classic]
            )
            for i, result in zip(classic, sub):
                results[i] = result
        return results  # type: ignore[return-value]

    def generate_stream(
        self,
        requests: Sequence[GenerationRequest],
        decode_steps: int = 1,
        speculative: bool = False,
        shards: Optional[Sequence[int]] = None,
    ):
        """Multi-token decode stream, the engine's ``decode_steps`` seam
        (``tpu.py:619-643``): the cohort is prefilled into a private page
        pool and then served in K-step windows of
        ``stepper.paged_decode_steps``.  ``dispatch()`` launches one window
        and returns without a host sync (CUDA launches are asynchronous, so
        the engine's host phases overlap the device), ``collect()`` fetches
        the window and finalises the rows that froze inside it with
        ``_finish_generation``'s semantics.  Sampling replays the sequential
        per-row key splits, so the tokens do not depend on K.

        With ``speculative=True`` each window instead drafts K tokens per
        row from an n-gram self-proposer and verifies them in ONE
        ``stepper.paged_verify_steps`` dispatch: ``1 + accepted`` real
        tokens per window, on the same sequential key schedule.

        Over dp shards the cohort's rows run as one stream per shard on the
        shard's card (:class:`_ShardedStream`): by ``shards`` (the engine's
        per-row shard, whose pool books the row's pages) or, without it, in
        contiguous blocks."""
        if self._shards is None:
            return _PagedGenerateStream(self, list(requests), decode_steps, speculative=speculative)
        return _ShardedStream(self, list(requests), decode_steps, speculative, shards)

    def _prep_generation_rows(self, requests: Sequence[GenerationRequest], allowed: int):
        """Row bucketing + per-row sampling state shared by the classic and
        shared-trunk paths (``tpu.py:815-855``)."""
        target = min(_bucket(len(requests), minimum=min(8, allowed)), allowed)
        if target % self._dp:  # dp > 8: power-of-two buckets may undershoot
            target = min(-(-target // self._dp) * self._dp, allowed)
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
        keys = self._row_keys("generate", [r.seed for r in requests] + [0] * pad_rows)
        eos = (-1,) if self.pin_generation_budget else self.tokenizer.eos_ids
        eos_ids = torch.tensor(eos, dtype=torch.int32, device=self.device)
        return (target, pad_rows, temperatures, bias_table, bias_index,
                keys, eos_ids, rep_penalty)

    def _generate_shared(
        self, requests: Sequence[GenerationRequest], prompt_ids: List[int]
    ) -> List[GenerationResult]:
        """Decode every row from ONE shared prompt trunk (``tpu.py:857-935``),
        padded to ``max_context`` columns: one trunk width for every prompt."""
        max_new = _width_bucket(max(r.max_tokens for r in requests), minimum=16)
        width = self.max_context
        prompt_ids = prompt_ids[-width:]
        seg_len = self._seg_len_for(max_new)
        # Only the tails are per row: the trunk is one row.
        if seg_len is not None:
            allowed = self._segmented_rows_allowed(0, max_new, seg_len)
        else:
            allowed = self._generate_rows_allowed(0, max_new)
        if len(requests) > allowed:
            out: List[GenerationResult] = []
            for i in range(0, len(requests), allowed):
                out.extend(self._generate_shared(requests[i : i + allowed], prompt_ids))
            return out

        self._tally(self.call_counts, "generate", len(requests))
        (target, pad_rows, temperatures, bias_table, bias_index, keys,
         eos_ids, rep_penalty) = self._prep_generation_rows(requests, allowed)
        self.instruments.record_padding("generate_trunk", 1, width, len(prompt_ids))
        self.instruments.record_launch(
            "generate_shared",
            (target, width, max_new, int(seg_len is not None), int(bias_table is not None)),
        )
        tokens = np.full((1, width), self.tokenizer.pad_id, np.int32)
        valid = np.zeros((1, width), bool)
        tokens[0, width - len(prompt_ids):] = prompt_ids
        valid[0, width - len(prompt_ids):] = True
        # Bucket-pad rows start done: they would sample real tokens from the
        # real prompt and hold the early exit off.
        init_done = np.zeros((target,), bool)
        init_done[len(requests):] = True
        kwargs = dict(
            keys=keys, temperature=temperatures, eos_ids=eos_ids,
            bias_table=bias_table, bias_index=bias_index, pad_id=self.tokenizer.pad_id,
            init_done=self._to_device(init_done), rep_penalty=rep_penalty,
        )
        tokens, valid = self._to_device(tokens), self._to_device(valid)

        def body(shard: _Shard):
            # Every shard decodes its block of rows from its own copy of the
            # one-row trunk.
            trunk = (shard.put(tokens, rows=False), shard.put(valid, rows=False))
            if seg_len is not None:
                return gen.generate_tokens_shared_trunk_segmented(
                    shard.params, self.config, *trunk, shard.rows, max_new,
                    seg_len=seg_len, kv_quant=self.kv_quant, **shard.put_kwargs(kwargs),
                )
            return gen.generate_tokens_shared_trunk(
                shard.params, self.config, *trunk, shard.rows, max_new,
                **shard.put_kwargs(kwargs),
            )

        out = self._run_rows(body, target)
        return self._finish_generation(requests, out, target, max_new)

    def _generate_classic(
        self, requests: Sequence[GenerationRequest], token_lists: List[List[int]]
    ) -> List[GenerationResult]:
        """Per-row prompts (``tpu.py:937-1014``): monolithic, or segmented
        with an int8 prompt trunk under ``kv_quant``."""
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
        seg_len = self._seg_len_for(max_new)
        if seg_len is not None:
            allowed = self._segmented_rows_allowed(width, max_new, seg_len)
        else:
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

        self._tally(self.call_counts, "generate", len(requests))
        (target, pad_rows, temperatures, bias_table, bias_index, keys,
         eos_ids, rep_penalty) = self._prep_generation_rows(requests, allowed)
        self.instruments.record_padding(
            "generate_prompt", target, width, sum(min(len(t), width) for t in token_lists)
        )
        self.instruments.record_launch(
            "generate",
            (target, width, max_new, int(seg_len is not None), int(bias_table is not None)),
        )
        tokens, valid = self._left_pad_batch(list(token_lists) + [[]] * pad_rows)
        kwargs = dict(
            keys=keys, temperature=temperatures, eos_ids=eos_ids,
            bias_table=bias_table, bias_index=bias_index, pad_id=self.tokenizer.pad_id,
            rep_penalty=rep_penalty,
        )

        def body(shard: _Shard):
            # A shard's segmented loop compacts its own rows.
            if seg_len is not None:
                return gen.generate_tokens_segmented(
                    shard.params, self.config, shard.put(tokens), shard.put(valid), max_new,
                    seg_len=seg_len, kv_quant=self.kv_quant, **shard.put_kwargs(kwargs),
                )
            return gen.generate_tokens(
                shard.params, self.config, shard.put(tokens), shard.put(valid), max_new,
                **shard.put_kwargs(kwargs),
            )

        out = self._run_rows(body, target)
        return self._finish_generation(requests, out, target, max_new)

    def _finish_generation(
        self, requests: Sequence[GenerationRequest], out, rows: int, max_new: int
    ) -> List[GenerationResult]:
        """Host-side post-processing: decode, EOS/stop semantics (none under
        ``pin_generation_budget``), token accounting (``tpu.py:1016-1060``)."""
        generated, counts, hit_eos = self._fetch(out.tokens, out.num_generated, out.hit_eos)
        # Decode-grid padding from the tokens actually emitted: EOS early
        # exits and bucket-pad rows both show up as empty slots.
        self.instruments.record_padding(
            "generate_decode", rows, max_new, int(counts[: len(requests)].sum())
        )
        results = []
        for row, request in enumerate(requests):
            emitted = int(counts[row])
            ids = [int(t) for t in generated[row, :emitted]][: request.max_tokens]
            text = self.tokenizer.decode(ids)
            # "stop" only if EOS arrived within the request's own cap.
            finish = "stop" if (hit_eos[row] and emitted <= request.max_tokens) else "length"
            truncated = False
            for stop in () if self.pin_generation_budget else request.stop:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
                    finish = "stop"
                    truncated = True
            if truncated:
                ids = self.tokenizer.encode(text)
            self._tally(self.token_counts, "generated", len(ids))
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
        """Teacher-forced scoring (``tpu.py:1080-1178``).  Without
        ``shared_context_scoring``: ``max_batch_rows`` slices of the per-call
        scorer.  With it, requests group by rendered prefix; a group of at
        least 4 rows whose context and longest continuation fit the window
        prefills its context ONCE and scores every continuation against it,
        in row chunks that start at 4 x ``max_batch_rows`` and halve until the
        suffix attention's fp32 logits fit ``_SHARED_SCORE_ATTN_BYTES_CAP``.
        Other rows, and chunk tails under 4 rows, take the per-call scorer."""
        if not requests:
            return []
        if not self.shared_context_scoring:
            return self._sliced(list(requests), self._score_impl)
        prepared = []
        prefix_ids: Dict[str, List[int]] = {}
        for request in requests:
            prefix = self._score_prefix(request)
            if prefix not in prefix_ids:
                prefix_ids[prefix] = self.tokenizer.encode(prefix, add_bos=True)
            prepared.append((prefix, prefix_ids[prefix], self.tokenizer.encode(request.continuation)))
        by_prefix: Dict[str, List[int]] = {}
        for i, (prefix, _, _) in enumerate(prepared):
            by_prefix.setdefault(prefix, []).append(i)

        results: List[Optional[ScoreResult]] = [None] * len(requests)
        legacy: List[int] = []
        for idxs in by_prefix.values():
            ctx_ids = prepared[idxs[0]][1]
            conts = [prepared[i][2] for i in idxs]
            max_cont = max(len(c) for c in conts)
            rows_cap, attn_bytes = self._shared_score_rows_cap(
                self._shared_cont_width(max_cont)
            )
            fits = (
                len(idxs) >= 4
                and all(conts)
                and ctx_ids
                and len(ctx_ids) + max_cont <= self.max_context
                and attn_bytes <= _SHARED_SCORE_ATTN_BYTES_CAP
            )
            if not fits:
                legacy.extend(idxs)
                continue
            trunk_state = None
            for start in range(0, len(idxs), rows_cap):
                chunk = idxs[start : start + rows_cap]
                if len(chunk) < 4:
                    legacy.extend(chunk)
                    continue
                if trunk_state is None:
                    trunk_state = self._shared_prefill(ctx_ids)
                self._score_shared_group(trunk_state, chunk, prepared, results, rows_cap)
        for start in range(0, len(legacy), self.max_batch_rows):
            chunk = legacy[start : start + self.max_batch_rows]
            chunk_results = self._score_impl(
                [requests[i] for i in chunk],
                prepared=[(prepared[i][1], prepared[i][2]) for i in chunk],
            )
            for i, result in zip(chunk, chunk_results):
                results[i] = result
        return results  # type: ignore[return-value]

    def _shared_score_rows_cap(self, cont_width: int) -> Tuple[int, int]:
        """(rows, bytes): the row chunk of a shared-context score, from
        ``max(max_batch_rows, 128)`` halved until the suffix attention's fp32
        logits over the query heads one card holds fit
        ``_SHARED_SCORE_ATTN_BYTES_CAP`` (or 8 to 15 rows are reached), and
        those logits' bytes at that chunk."""
        rows_cap = max(self.max_batch_rows, 128)
        while True:
            attn_bytes = (
                rows_cap * self._q_heads_per_card * cont_width
                * (self.max_context + cont_width) * 4
            )
            if attn_bytes <= _SHARED_SCORE_ATTN_BYTES_CAP or rows_cap < 16:
                return rows_cap, attn_bytes
            rows_cap //= 2

    def _shared_cont_width(self, max_cont: int) -> int:
        """Continuation-width bucket of a shared-context group: powers of two
        from 64, capped at the context window."""
        width = 64
        while width < max_cont:
            width *= 2
        return min(width, self.max_context)

    def _shared_prefill(self, ctx_ids: List[int]):
        """Prefill one shared scoring context, right-padded to
        ``max_context`` columns -> per dp shard (trunk, ctx_len, last_hidden)."""
        width = self.max_context
        self.instruments.record_padding("score_trunk", 1, width, len(ctx_ids))
        self.instruments.record_launch("score_trunk", (1, width))
        tokens = np.full((1, width), self.tokenizer.pad_id, np.int32)
        tokens[0, : len(ctx_ids)] = ctx_ids
        valid = np.zeros((1, width), bool)
        valid[0, : len(ctx_ids)] = True
        tokens, valid = self._to_device(tokens), self._to_device(valid)
        # One trunk per dp shard: every shard scores its rows against it.
        return self._on_shards(
            lambda shard: shared_context_prefill(
                shard.params, self.config, shard.put(tokens), shard.put(valid)
            )
        )

    def _score_shared_group(self, trunk_state, idxs: List[int], prepared, results, rows_cap: int) -> None:
        """Score one row chunk of a shared-context group against its trunk:
        rows bucket to powers of two from 32 up to ``rows_cap``."""
        self._tally(self.call_counts, "score", len(idxs))
        conts = [prepared[i][2] for i in idxs]
        n_rows = min(rows_cap, _bucket(len(idxs), minimum=32))
        width = self._shared_cont_width(max(len(c) for c in conts))
        self.instruments.record_padding("score_shared", n_rows, width, sum(len(c) for c in conts))
        self.instruments.record_launch("score_shared", (n_rows, width))
        tokens = np.full((n_rows, width), self.tokenizer.pad_id, np.int32)
        valid = np.zeros((n_rows, width), bool)
        for row, ids in enumerate(conts):
            tokens[row, : len(ids)] = ids
            valid[row, : len(ids)] = True
        tokens_t, valid_t = self._to_device(tokens), self._to_device(valid)
        logprobs = self._fetch(self._run_rows(
            lambda shard: shared_context_cont_logprobs(
                shard.params, self.config, *trunk_state[shard.index],
                shard.put(tokens_t), shard.put(valid_t),
            ),
            n_rows,
        ))
        for row, i in enumerate(idxs):
            ids = conts[row]
            self._tally(self.token_counts, "scored", len(ids))
            results[i] = ScoreResult(
                tokens=tuple(self.tokenizer.token_str(t) for t in ids),
                logprobs=tuple(float(v) for v in logprobs[row, : len(ids)]),
            )

    def _score_impl(
        self,
        requests: Sequence[ScoreRequest],
        prepared: Optional[Sequence[Tuple[List[int], List[int]]]] = None,
    ) -> List[ScoreResult]:
        """Full-sequence batch scorer (``tpu.py:1253-1338``).  ``prepared``
        carries already-encoded (context_ids, continuation_ids)."""
        self._tally(self.call_counts, "score", len(requests))
        self._tally(self.call_counts, "score_batches", 1)
        rows = []
        spans = []  # (context_len, continuation_len) per row
        for i, request in enumerate(requests):
            if prepared is not None:
                context_ids, continuation_ids = prepared[i]
            else:
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
        self.instruments.record_padding(
            "score", len(rows), width, sum(min(len(r), width) for r in rows[: len(requests)])
        )
        self.instruments.record_launch("score", (len(rows), width))
        tokens_t, valid_t = self._to_device(tokens), self._to_device(valid)
        logprobs = self._fetch(self._run_rows(
            lambda shard: scorer(shard.params, self.config, shard.put(tokens_t), shard.put(valid_t)),
            len(rows),
        ))

        results = []
        for i, (ctx_len, cont_len) in enumerate(spans):
            end = min(ctx_len + cont_len, width)
            span_lp = logprobs[i, ctx_len:end]
            span_ids = tokens[i, ctx_len:end]
            self._tally(self.token_counts, "scored", len(span_lp))
            results.append(
                ScoreResult(
                    tokens=tuple(self.tokenizer.token_str(t) for t in span_ids),
                    logprobs=tuple(float(v) for v in span_lp),
                )
            )
        return results

    # -- fused (candidates x agents) utility matrix ---------------------------

    #: KV page width of the fused scoring pool: everything up to the last
    #: full page of an agent context is shared read-only by every candidate
    #: row; only the <= 15-token tail and the candidate run per row.
    _SCORE_PAGE_SIZE = 16

    def score_matrix(self, requests) -> List[ScoreMatrixResult]:
        """Evaluate whole (candidates x agents) utility matrices on the device
        (``tpu.py:1348-1387``).  Each agent context's full pages prefill once
        (deduped across agents with the same rendered prefix) and every
        candidate row reads them through its block table; the row batch is
        chunked under the session budget; per-row reductions and the welfare
        fold run on the device, and only the (C, A) utilities, the (C,)
        welfare and the moments aux come to the host.  A request with a row
        that needs the per-call scorer's truncation falls back to it whole
        (``matrix_stats["fallbacks"]``)."""
        out = []
        for request in requests:
            self._tally(self.call_counts, "score_matrix", 1)
            self._tally(self.matrix_stats, "calls", 1)
            if not request.candidates or not request.agents:
                out.append(reduce_matrix(request, [], path="fused"))
                continue
            result = self._score_matrix_fused(request)
            if result is None:
                self._tally(self.matrix_stats, "fallbacks", 1)
                result = fallback_score_matrix_many(self, [request])[0]
            else:
                record_matrix(result, len(request.agents), welfare_rule=request.welfare_rule)
            out.append(result)
        return out

    def _score_matrix_fused(self, request) -> Optional[ScoreMatrixResult]:
        """The fused path of one matrix (``tpu.py:1389-1520``), or None when a
        row needs the per-call truncation or one row's pages exceed the
        session budget."""
        ps = self._SCORE_PAGE_SIZE
        c = self.config
        n_candidates, n_agents = len(request.candidates), len(request.agents)
        prefix_ids: Dict[str, List[int]] = {}
        agent_prefixes: List[str] = []
        for agent in request.agents:
            prefix = self._score_prefix(agent.to_score_request(""))
            if prefix not in prefix_ids:
                prefix_ids[prefix] = self.tokenizer.encode(prefix, add_bos=True)
            agent_prefixes.append(prefix)
        cont_ids = [self.tokenizer.encode(text) for text in request.candidates]
        max_cont = max(len(ids) for ids in cont_ids)
        if any(len(ids) + max_cont > self.max_context for ids in prefix_ids.values()):
            return None  # the per-call scorer owns truncation

        # Each unique context owns the pages below its last full page
        # boundary; its 1..ps-token tail is re-fed per row, so the hidden
        # state at the final context position exists to teacher-force the
        # first candidate token.
        shared: Dict[str, Tuple[int, int, int]] = {}  # prefix -> (first, n_pages, n0)
        next_page = 0
        for prefix, ids in prefix_ids.items():
            n0 = ((len(ids) - 1) // ps) * ps
            shared[prefix] = (next_page, n0 // ps, n0)
            next_page += n0 // ps
        shared_total = next_page

        # Candidate-major rows; the query block is the context tail plus all
        # but the last candidate token (targets are the NEXT stream token).
        rows = []  # (prefix, cont, q_len, n_private)
        max_q = max_private = max_blocks = 1
        for cont in cont_ids:
            for prefix in agent_prefixes:
                _, n_pages, n0 = shared[prefix]
                q_len = (len(prefix_ids[prefix]) - n0) + max(len(cont) - 1, 0)
                n_private = (n0 + q_len - 1) // ps - n0 // ps + 1
                rows.append((prefix, cont, q_len, n_private))
                max_q = max(max_q, q_len)
                max_private = max(max_private, n_private)
                max_blocks = max(max_blocks, n_pages + n_private)

        dtype = params_dtype(self.params)
        page_bytes = c.n_layers * ps * self._kv_heads_per_card * c.head_dim * 2 * (
            torch.finfo(dtype).bits // 8
        )

        def pool_bytes(n_rows: int) -> int:
            return (shared_total + n_rows * max_private + 1) * page_bytes

        total_rows = len(rows)
        chunk_rows = min(
            _bucket(total_rows, minimum=8), _bucket(max(self.max_batch_rows, 64), minimum=8)
        )
        budget = self._session_budget.cap
        while chunk_rows > 1 and pool_bytes(chunk_rows) > budget:
            chunk_rows //= 2
        if pool_bytes(chunk_rows) > budget:
            return None  # even one row over-commits; the per-call path chunks finer
        width = _bucket(max_q, minimum=ps)
        num_pages = shared_total + chunk_rows * max_private
        layout = (shared, shared_total, max_private, max_blocks, num_pages)

        nbytes = pool_bytes(chunk_rows)
        self._session_budget.acquire(nbytes)
        try:
            with torch.inference_mode():
                # One pool per dp shard, each holding the shared pages; a
                # chunk's rows split over the shards.
                states = self._on_shards(
                    lambda shard: stepper.make_page_state(
                        c, num_pages, ps, dtype, shard.device, shard.params
                    )
                )
                self._prefill_shared_pages(states, prefix_ids, shared, num_pages)
                chunk_stats = []
                for start in range(0, total_rows, chunk_rows):
                    chunk = rows[start : start + chunk_rows]
                    stats, states = self._score_matrix_chunk(
                        states, chunk, prefix_ids, chunk_rows, width, layout
                    )
                    chunk_stats.append(tuple(t[: len(chunk)] for t in stats))
                    self._tally(self.matrix_stats, "chunks", 1)
                del states
                stats = tuple(torch.cat([cs[i] for cs in chunk_stats]) for i in range(4))
                utilities, welfare_vals, aux = stepper.utility_matrix(
                    stats, n_candidates, n_agents, stat=request.stat,
                    rule=request.welfare_rule, default=request.default,
                )
                utilities_np, welfare_np = self._fetch(utilities, welfare_vals)
                aux_np = self._fetch(aux) if aux is not None else None
        finally:
            self._session_budget.release(nbytes)
        self._tally(self.token_counts, "scored", n_agents * sum(len(ids) for ids in cont_ids))
        return ScoreMatrixResult(
            utilities=utilities_np,
            welfare=welfare_np,
            best=int(np.argmax(welfare_np)) if welfare_np.size else 0,
            aux=aux_np,
            cells=n_candidates * n_agents,
            d2h_bytes=utilities_np.nbytes + welfare_np.nbytes
            + (aux_np.nbytes if aux_np is not None else 0),
            path="fused",
        )

    def _prefill_shared_pages(self, states, prefix_ids, shared, sink: int) -> None:
        """Write every unique agent context's full pages (one row per unique
        prefix, in chunks of up to 256 columns) into each dp shard's pool
        (``tpu.py:1522-1576``).  Rows that pad the batch bucket repeat row 0
        with their writes sent to the sink."""
        ps = self._SCORE_PAGE_SIZE
        pre = [p for p in prefix_ids if shared[p][1] > 0]
        if not pre:
            return
        n_rows = _bucket(len(pre), minimum=8)
        max_n0 = max(shared[p][2] for p in pre)
        chunk = min(256, _bucket(max_n0, minimum=ps))
        tables = np.full((n_rows, max(shared[p][1] for p in pre)), -1, np.int32)
        for r, p in enumerate(pre):
            first, n_pages, _ = shared[p]
            tables[r, :n_pages] = np.arange(first, first + n_pages, dtype=np.int32)
        tables[len(pre):] = tables[0]
        for k in range(0, max_n0, chunk):
            tokens = np.full((n_rows, chunk), self.tokenizer.pad_id, np.int32)
            valid = np.zeros((n_rows, chunk), bool)
            lengths = np.zeros((n_rows,), np.int32)
            write_pages = np.full((n_rows, chunk), sink, np.int32)
            write_offsets = np.zeros((n_rows, chunk), np.int32)
            for r, p in enumerate(pre):
                first, _, n0 = shared[p]
                hi = min(n0, k + chunk)
                lengths[r] = hi
                if hi <= k:
                    continue
                span = prefix_ids[p][k:hi]
                valid[r, : len(span)] = True
                tokens[r, : len(span)] = span
                cols = np.arange(k, hi)
                write_pages[r, : len(span)] = first + cols // ps
                write_offsets[r, : len(span)] = cols % ps
            tokens[len(pre):] = tokens[0]
            valid[len(pre):] = valid[0]
            lengths[len(pre):] = lengths[0]
            self.instruments.record_launch("score_matrix_prefill", (n_rows, chunk))
            inputs = [self._to_device(a) for a in (tokens, valid, tables, lengths, write_pages, write_offsets)]
            self._on_shards(
                lambda shard: stepper.paged_prefill_chunk(
                    shard.params, self.config, *map(shard.put, inputs[:2]), states[shard.index],
                    *map(shard.put, inputs[2:]),
                )
            )

    def _score_matrix_chunk(self, states, chunk, prefix_ids, n_rows: int, width: int, layout):
        """One fused teacher-forced pass over a chunk of matrix rows
        (``tpu.py:1578-1638``), its rows split over the dp shards' pools ->
        (stats, per-shard states); rows past the chunk repeat row 0, write
        to the sink and score nothing."""
        ps = self._SCORE_PAGE_SIZE
        shared, shared_total, max_private, max_blocks, sink = layout
        tokens = np.full((n_rows, width), self.tokenizer.pad_id, np.int32)
        targets = np.zeros((n_rows, width), np.int32)
        score_mask = np.zeros((n_rows, width), bool)
        chunk_valid = np.zeros((n_rows, width), bool)
        tables = np.full((n_rows, max_blocks), -1, np.int32)
        lengths = np.zeros((n_rows,), np.int32)
        write_pages = np.full((n_rows, width), sink, np.int32)
        write_offsets = np.zeros((n_rows, width), np.int32)
        for r, (prefix, cont, q_len, n_private) in enumerate(chunk):
            ids = prefix_ids[prefix]
            first, n_pages, n0 = shared[prefix]
            stream = ids + cont
            tokens[r, :q_len] = stream[n0 : n0 + q_len]
            chunk_valid[r, :q_len] = True
            lengths[r] = n0 + q_len
            tables[r, :n_pages] = np.arange(first, first + n_pages, dtype=np.int32)
            base = shared_total + r * max_private
            tables[r, n_pages : n_pages + n_private] = np.arange(
                base, base + n_private, dtype=np.int32
            )
            pos = np.arange(n0, n0 + q_len)
            write_pages[r, :q_len] = base + pos // ps - n0 // ps
            write_offsets[r, :q_len] = pos % ps
            has_next = pos + 1 < len(stream)
            targets[r, :q_len][has_next] = np.asarray(stream)[pos[has_next] + 1]
            lo = len(ids) - 1 - n0
            score_mask[r, lo : lo + len(cont)] = bool(cont)
        n_real = len(chunk)
        for array in (tokens, targets, chunk_valid, lengths, tables):
            array[n_real:] = array[0]
        self.instruments.record_padding(
            "score_matrix", n_rows, width, sum(q for (_, _, q, _) in chunk)
        )
        self.instruments.record_launch("score_matrix", (n_rows, width))
        inputs = [
            self._to_device(a) for a in (tokens, targets, score_mask, chunk_valid,
                                         tables, lengths, write_pages, write_offsets)
        ]
        outs = self._on_shards(
            lambda shard: stepper.paged_score_chunk(
                shard.params, self.config, *map(shard.put, inputs[:4]), states[shard.index],
                *map(shard.put, inputs[4:]),
            ),
            n_rows,
        )
        return self._gather([o[0] for o in outs]), [o[1] for o in outs] + states[len(outs):]

    # -- token-search sessions -----------------------------------------------

    def open_fused_token_search(self, spec: SearchSpec) -> "TorchTokenSearchSession":
        """Incremental KV-cache search session (``models/stepper.py``): one
        fused step per emitted token.  Raises :class:`FusedSessionUnavailable`
        when its caches would not fit the session budget.

        Over dp shards a session whose slots divide dp splits them into
        contiguous blocks, one per shard's card (:class:`_ShardedSearchSession`);
        any other runs whole on one shard, the shards taken in turn."""
        if self._shards is None:
            return TorchTokenSearchSession(self, spec)
        if spec.n_slots % self._dp == 0:
            return _ShardedSearchSession(self, spec)
        with self._nonce_lock:
            turn = self._session_turn
            self._session_turn += 1
        return TorchTokenSearchSession(self._shards[turn % self._dp], spec)

    # -- embed ---------------------------------------------------------------

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(N, d_model) unit-norm embeddings: the masked mean-pool of the
        final hidden states (``tpu.py:1743-1766``), in ``max_batch_rows``
        slices with rows bucketed to at least 8.  With
        ``use_flash_attention`` the forward attends through the flash
        kernel, as the reference's does."""
        pieces = [
            self._embed_impl(texts[i : i + self.max_batch_rows])
            for i in range(0, len(texts), self.max_batch_rows)
        ] or [np.zeros((0, self.config.d_model), np.float32)]
        return np.vstack(pieces)

    def _embed_impl(self, texts: Sequence[str]) -> np.ndarray:
        self._tally(self.call_counts, "embed", len(texts))
        token_lists = [self.tokenizer.encode(t, add_bos=True) for t in texts]
        token_lists += [[]] * (_bucket(len(texts), minimum=8) - len(texts))
        tokens, valid = self._left_pad_batch(token_lists)
        width = int(tokens.shape[1])
        self.instruments.record_padding(
            "embed", len(token_lists), width,
            sum(min(len(t), width) for t in token_lists[: len(texts)]),
        )
        self.instruments.record_launch("embed", (len(token_lists), width))
        hidden = self._run_rows(
            lambda shard: _embed_forward(shard.params, self.config, shard.put(tokens), shard.put(valid)),
            len(token_lists),
        )
        hidden = self._fetch(hidden[: len(texts)])
        norms = np.linalg.norm(hidden, axis=1, keepdims=True)
        return hidden / np.maximum(norms, 1e-12)

    # -- next-token distribution ---------------------------------------------

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        """k candidate next tokens per request from one cacheless forward
        (``tpu.py:1642-1730``), in ``max_batch_rows`` slices.  With
        ``use_flash_attention`` the forward attends through the flash
        kernel."""
        if not requests:
            return []
        return self._sliced(list(requests), self._next_token_impl)

    def _next_token_impl(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        self._tally(self.call_counts, "next_token", len(requests))
        self._tally(self.token_counts, "scored", len(requests))
        token_lists = [
            self.tokenizer.encode(self._render_prompt(r), add_bos=True) for r in requests
        ]
        # Rows bucket to at least 8 and k to at least 4: search steps vary
        # both, the buckets keep the launch shapes few.
        pad_rows = _bucket(len(requests), minimum=8) - len(requests)
        tokens, valid = self._left_pad_batch(token_lists + [[]] * pad_rows)
        bias_table, bias_index = self._bias_table(requests)
        if bias_index is not None and pad_rows:
            bias_index = torch.cat(
                [bias_index, torch.zeros((pad_rows,), dtype=bias_index.dtype, device=self.device)]
            )
        vocab = self.config.vocab_size
        k = min(_bucket(max(min(r.k, vocab) for r in requests), minimum=4), vocab)
        temperatures = torch.tensor(
            [r.temperature for r in requests] + [1.0] * pad_rows,
            dtype=torch.float32, device=self.device,
        )
        gumbel_rows = [r.mode != "topk" and r.temperature > 0 for r in requests]
        gumbel_rows += [False] * pad_rows
        if any(gumbel_rows):
            keys = self._row_keys("next_token", [r.seed for r in requests] + [0] * pad_rows)
        else:
            # Pure top-k batches are deterministic: the unseeded nonce is not
            # burned, so unrelated unseeded calls stay reproducible.
            keys = torch.zeros((len(gumbel_rows), 2), dtype=torch.int64, device=self.device)
        width = int(tokens.shape[1])
        all_rows = len(token_lists) + pad_rows
        self.instruments.record_padding(
            "next_token", all_rows, width, sum(min(len(t), width) for t in token_lists)
        )
        self.instruments.record_launch(
            "next_token", (all_rows, width, k, int(bias_table is not None))
        )
        gumbel = torch.tensor(gumbel_rows, dtype=torch.bool, device=self.device)
        ids, logprobs = self._run_rows(
            lambda shard: gen.next_token_topk(
                shard.params, self.config, shard.put(tokens), shard.put(valid), shard.put(keys),
                k, shard.put(temperatures), shard.put(gumbel), shard.put(bias_table, rows=False),
                shard.put(bias_index), with_gumbel=any(gumbel_rows),
            ),
            all_rows,
        )
        ids, logprobs = self._fetch(ids, logprobs)
        out: List[List[TokenCandidate]] = []
        for row, request in enumerate(requests):
            # This request's k in score order (the without-replacement
            # sample), presented best-first by true logprob.
            row_k = min(request.k, vocab)
            pairs = sorted(zip(ids[row, :row_k], logprobs[row, :row_k]), key=lambda p: -p[1])
            out.append([
                TokenCandidate(
                    token=self.tokenizer.token_str(int(t)), token_id=int(t), logprob=float(lp),
                )
                for t, lp in pairs
            ])
        return out


#: Page size and prefill chunk of a generate stream's private page pool
#: (``tpu.py:1784-1787``).
_STREAM_PAGE_SIZE = 16
_STREAM_PREFILL_CHUNK = 64


class _PagedGenerateStream:
    """One generate cohort served as K-step decode windows
    (``tpu.py:1797-2138``).

    Construction prefills every prompt into a PRIVATE page pool (contiguous
    block tables, fixed-width chunks) and projects the first sampling
    logits.  Then the engine's stream protocol:

    - ``dispatch()`` launches ONE ``paged_decode_steps`` window and returns
      without reading anything back: the window's tensors stay on the
      device until ``collect()``.
    - ``collect()`` fetches the window's tokens / emitted / done / hit_eos,
      extends per-row ids, and returns ``(per_row_token_counts, {row:
      GenerationResult})`` for rows that froze inside the window, finalised
      with ``_finish_generation``'s semantics (max_tokens truncation, stop
      strings, token accounting).
    - ``finished`` / ``close()`` manage drain and teardown.

    Sampling state (keys, budgets, bias, penalties) comes from the same
    ``_prep_generation_rows`` the dense paths use, and the window replays
    the sequential key-split schedule, so the tokens match the dense paths
    for any ``decode_steps``, up to paged-vs-dense forward numerics.

    ``speculative`` turns each window into a draft-and-verify window: the
    rows' n-gram self-drafts go through one ``paged_verify_steps`` and each
    row's emitted tokens feed its proposer at ``collect()``."""

    def __init__(
        self,
        backend: TorchBackend,
        requests: List[GenerationRequest],
        decode_steps: int,
        speculative: bool = False,
    ):
        be = self.backend = backend
        self.requests = requests
        self.decode_steps = max(1, int(decode_steps))
        self.speculative = bool(speculative)
        self._pending = None
        self._closed = False
        self._finished_rows: set = set()
        self._results: Dict[int, GenerationResult] = {}

        be._tally(be.call_counts, "generate", len(requests))
        tok = be.tokenizer
        prompt_ids = [
            tok.encode(be._render_prompt(r), add_bos=True)[-be.max_context:] for r in requests
        ]
        (target, pad_rows, temperatures, bias_table, bias_index, keys,
         eos_ids, rep_penalty) = be._prep_generation_rows(
            requests, allowed=_bucket(len(requests), minimum=8)
        )
        self._n_rows = len(requests)
        self._ids: List[List[int]] = [[] for _ in requests]

        # Contiguous block tables over a bucketed private pool: each row
        # reserves ceil((prompt + max_tokens) / page) pages up front, so
        # every page a window's cursor can reach exists before the first
        # window; the eos-check token lands in the sink.
        ps = _STREAM_PAGE_SIZE
        pages_per = [
            -(-(len(ids) + r.max_tokens) // ps) for ids, r in zip(prompt_ids, requests)
        ] + [1] * pad_rows
        max_blocks = _bucket(max(pages_per), minimum=8)
        num_pages = min(_width_bucket(sum(pages_per), minimum=16), target * max_blocks)
        tables = np.full((target, max_blocks), -1, np.int32)
        off = 0
        for row, n in enumerate(pages_per):
            tables[row, :n] = np.arange(off, off + n)
            off += n
        be.instruments.record_launch(
            "generate_stream", (target, num_pages, max_blocks, self.decode_steps)
        )
        state = stepper.make_page_state(
            be.config, num_pages, ps, dtype=params_dtype(be.params), device=be.device,
            params=be.params,
        )
        sink = num_pages
        tables_t = be._to_device(tables)

        # Fixed-width chunked prefill; each row's final-prompt hidden is
        # taken from the chunk that holds its last prompt token.
        chunk = _STREAM_PREFILL_CHUNK
        maxlen = max(len(ids) for ids in prompt_ids)
        lengths = np.zeros(target, np.int32)
        final_hidden = None
        with torch.inference_mode():
            for start in range(0, maxlen, chunk):
                ctok = np.zeros((target, chunk), np.int32)
                cval = np.zeros((target, chunk), bool)
                wp = np.full((target, chunk), sink, np.int32)
                wo = np.zeros((target, chunk), np.int32)
                is_last = np.zeros(target, bool)
                for row, ids in enumerate(prompt_ids):
                    piece = ids[start : start + chunk]
                    if not piece:
                        continue
                    ctok[row, : len(piece)] = piece
                    cval[row, : len(piece)] = True
                    pos = start + np.arange(len(piece))
                    wp[row, : len(piece)] = tables[row, pos // ps]
                    wo[row, : len(piece)] = pos % ps
                    lengths[row] = start + len(piece)
                    is_last[row] = start + len(piece) >= len(ids)
                hid, state = stepper.paged_prefill_chunk(
                    be.params, be.config, be._to_device(ctok), be._to_device(cval), state,
                    tables_t, be._to_device(lengths.copy()), be._to_device(wp), be._to_device(wo),
                )
                mask = be._to_device(is_last)[:, None]
                final_hidden = hid if final_hidden is None else torch.where(mask, hid, final_hidden)
            self._logits = project_logits(be.params, be.config, final_hidden.to(torch.float32))
        be.instruments.record_padding(
            "generate_trunk", target, -(-maxlen // chunk) * chunk,
            int(sum(len(ids) for ids in prompt_ids)),
        )
        self._state = state
        self._tables = tables_t
        self._lengths = be._to_device(lengths)
        self._keys = keys
        # Bucket-pad rows start done with budget 0: they sample pad ids into
        # the sink and never show up in collect().
        row_pad = np.zeros(target, bool)
        row_pad[len(requests):] = True
        self._done = be._to_device(row_pad)
        self._budgets = be._to_device(
            np.asarray([r.max_tokens for r in requests] + [0] * pad_rows, np.int32)
        )
        self._hit_eos = torch.zeros(target, dtype=torch.bool, device=be.device)
        self._temperatures = temperatures
        #: Whether any row samples, known on the host: a greedy window
        #: splits no keys and needs no host read of the temperatures.
        self._sampling = any(r.temperature > 0 for r in requests)
        self._eos_ids = eos_ids
        self._bias_table = bias_table
        self._bias_index = bias_index
        self._rep_penalty = rep_penalty
        self._presence = None
        if rep_penalty is not None:
            width = max(maxlen, 1)
            ptok = np.full((target, width), tok.pad_id, np.int32)
            pval = np.zeros((target, width), bool)
            for row, ids in enumerate(prompt_ids):
                ptok[row, width - len(ids):] = ids
                pval[row, width - len(ids):] = True
            self._presence = gen._prompt_presence(
                be._to_device(ptok), be._to_device(pval), be.config.vocab_size
            )

        #: Cumulative draft accounting the engine reads after collect().
        self.spec_proposed = 0
        self.spec_accepted = 0
        if self.speculative:
            # One n-gram self-draft table per row, seeded from the row's own
            # prompt; emitted tokens feed it at collect().
            self._proposers = [NGramProposer() for _ in requests]
            self._ctx: List[List[int]] = []
            for proposer, ids in zip(self._proposers, prompt_ids):
                proposer.observe(ids)
                self._ctx.append(list(ids))
            self._target = target
            self._pending_tok = torch.zeros(target, dtype=torch.int32, device=be.device)
            self._has_pending = False
            reg = be.instruments.registry
            self._obs_spec_proposed = reg.counter(
                "spec_draft_proposed_tokens_total",
                "Draft tokens proposed for speculative rollout verification",
                ("backend",),
            ).labels(be.name)
            self._obs_spec_verified = reg.counter(
                "spec_draft_verified_tokens_total",
                "Draft tokens accepted by the parallel verify pass",
                ("backend",),
            ).labels(be.name)

    @property
    def finished(self) -> bool:
        return self._closed or len(self._finished_rows) >= self._n_rows

    def dispatch(self) -> None:
        """Launch one K-step window; nothing is read back until ``collect()``."""
        if self._closed or self._pending is not None or self.finished:
            return
        if self.speculative:
            self._dispatch_verify()
            return
        be = self.backend
        with torch.inference_mode():
            (tokens, emitted, self._logits, self._state, self._lengths, self._keys,
             self._done, self._budgets, self._hit_eos, self._presence) = stepper.paged_decode_steps(
                be.params, be.config, self._logits, self._state, self._tables,
                self._lengths, self._keys, self._done, self._budgets, self._hit_eos,
                temperature=self._temperatures, eos_ids=self._eos_ids,
                num_steps=self.decode_steps, bias_table=self._bias_table,
                bias_index=self._bias_index, pad_id=be.tokenizer.pad_id,
                presence=self._presence, rep_penalty=self._rep_penalty,
                sampling=self._sampling,
            )
        self._pending = (tokens, emitted, self._done, self._hit_eos)

    def _dispatch_verify(self) -> None:
        """Speculative window: draft K tokens per live row on the host and
        verify them in ONE ``paged_verify_steps`` launch.  Drafting happens
        between collect() and dispatch(), so the window stays asynchronous
        like the plain one."""
        be = self.backend
        k = self.decode_steps
        drafts = np.zeros((self._target, k), np.int32)
        live = 0
        for row in range(self._n_rows):
            if row in self._finished_rows:
                continue
            drafts[row] = self._proposers[row].draft(self._ctx[row], k)
            live += 1
        self.spec_proposed += live * k
        self._obs_spec_proposed.inc(live * k)
        with torch.inference_mode():
            (tokens, emitted, accepted, self._pending_tok, self._state, self._lengths,
             self._keys, self._done, self._budgets, self._hit_eos,
             self._presence) = stepper.paged_verify_steps(
                be.params, be.config, self._logits, self._state, self._tables,
                self._lengths, self._keys, self._done, self._budgets, self._hit_eos,
                temperature=self._temperatures, draft_tokens=be._to_device(drafts),
                pending=self._pending_tok, eos_ids=self._eos_ids, num_steps=k,
                bias_table=self._bias_table, bias_index=self._bias_index,
                pad_id=be.tokenizer.pad_id, presence=self._presence,
                rep_penalty=self._rep_penalty, has_pending=self._has_pending,
                sampling=self._sampling,
            )
        # The carried prefill logits are consumed by the first window; every
        # later first decision re-derives its logits from the pending column.
        self._logits = None
        self._has_pending = True
        self._pending = (tokens, emitted, self._done, self._hit_eos, accepted)

    def collect(self) -> Tuple[List[int], Dict[int, GenerationResult]]:
        """Wait for the pending window; return (per-row emitted counts,
        {row: result}) for the rows that froze inside it."""
        if self._pending is None:
            raise RuntimeError("collect() before dispatch()")
        fetched = self.backend._fetch(*self._pending)
        tokens, emitted, done, hit = fetched[:4]
        accepted = fetched[4] if self.speculative else None
        self._pending = None
        row_tokens = [0] * self._n_rows
        newly_finished: Dict[int, GenerationResult] = {}
        for row in range(self._n_rows):
            if row in self._finished_rows:
                continue
            ids = [int(t) for t, e in zip(tokens[row], emitted[row]) if e]
            self._ids[row].extend(ids)
            row_tokens[row] = len(ids)
            if accepted is not None and ids:
                self._proposers[row].observe(ids)
                self._ctx[row].extend(ids)
            if bool(done[row]):
                self._finished_rows.add(row)
                result = self._finish_row(row, bool(hit[row]))
                self._results[row] = result
                newly_finished[row] = result
        if accepted is not None:
            window_accepted = int(accepted[: self._n_rows].sum())
            self.spec_accepted += window_accepted
            self._obs_spec_verified.inc(window_accepted)
        if self.finished:
            self.backend.instruments.record_padding(
                "generate_decode", self._n_rows,
                max((r.max_tokens for r in self.requests), default=0),
                sum(len(ids) for ids in self._ids),
            )
        return row_tokens, newly_finished

    def _finish_row(self, row: int, hit_eos: bool) -> GenerationResult:
        """One row of ``_finish_generation``: the same truncation,
        stop-string, finish-reason and token-accounting semantics."""
        be = self.backend
        request = self.requests[row]
        emitted = len(self._ids[row])
        ids = self._ids[row][: request.max_tokens]
        text = be.tokenizer.decode(ids)
        finish = "stop" if (hit_eos and emitted <= request.max_tokens) else "length"
        truncated = False
        for stop in () if be.pin_generation_budget else request.stop:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
                finish = "stop"
                truncated = True
        if truncated:
            ids = be.tokenizer.encode(text)
        be._tally(be.token_counts, "generated", len(ids))
        return GenerationResult(text=text, token_ids=tuple(ids), finish_reason=finish)

    def results(self) -> List[GenerationResult]:
        """All results in request order (valid once ``finished``)."""
        return [self._results[row] for row in range(self._n_rows)]

    def close(self) -> None:
        self._closed = True
        self._pending = None
        self._state = None
        self._logits = None
        if self.speculative:
            self._pending_tok = None


def _embed_forward(params, config: ModelConfig, tokens, valid) -> torch.Tensor:
    """Masked mean-pool of final hidden states -> (B, D) float32
    (``tpu.py:1769-1778``)."""
    positions = torch.clamp(torch.cumsum(valid.to(torch.int32), dim=1) - 1, min=0)
    hidden, _ = forward(params, config, tokens, positions, valid, return_hidden=True)
    mask = valid[..., None].to(torch.float32)
    return (hidden.to(torch.float32) * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)


class TorchTokenSearchSession:
    """Incremental token search over persistent per-(slot x role) KV tails
    (``TPUTokenSearchSession``, ``tpu.py:2140-2687``).

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
    from the key ``fold_in(fold_in(fold_in(base_key, f), i), s)`` as in the
    reference (``stepper.py:112-118``), ``base_key`` being the backend's fold
    of ("search", seed).  Rollouts (family 2) draw path p's token t from
    ``fold_in(fold_in(fold_in(base_key, 2), salt_p), t)``.
    """

    def __init__(
        self,
        backend: TorchBackend,
        spec: SearchSpec,
        base_key: Optional[torch.Tensor] = None,
        slot_offset: int = 0,
    ):
        self.backend = backend
        self.spec = spec
        #: Global index of this session's slot 0: a dp shard's part of a
        #: split session draws the noise of its own slots.
        self._slot_offset = slot_offset
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
            * backend._kv_heads_per_card * c.head_dim * itemsize
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
        if base_key is not None:
            self._base_key = base_key.to(backend.device)
        elif spec.seed is None:
            self._base_key = backend._fold_seed("search", "unseeded", backend._next_nonce())
        else:
            self._base_key = backend._fold_seed("search", spec.seed)
        self._eos_ids = tuple(tok.eos_ids)
        #: Speculative rollout verification (``backends/speculative.py`` +
        #: ``stepper.rollout_verify_many``): an n-gram self-draft proposer
        #: seeded from the reference prompt and every trunk advance; counted
        #: in ``draft_tokens`` and the reference's
        #: ``spec_draft_{proposed,verified}_tokens_total`` families.
        self._proposer = None
        self.draft_tokens = {"proposed": 0, "verified": 0, "verify_dispatches": 0}
        if spec.speculative:
            self._proposer = NGramProposer()
            self._proposer.observe(token_lists[0])
            reg = backend.instruments.registry
            self._obs_spec_proposed = reg.counter(
                "spec_draft_proposed_tokens_total",
                "Draft tokens proposed for speculative rollout verification",
                ("backend",),
            ).labels(backend.name)
            self._obs_spec_verified = reg.counter(
                "spec_draft_verified_tokens_total",
                "Draft tokens accepted by the parallel verify pass",
                ("backend",),
            ).labels(backend.name)
            #: Trunk token ids (reference prompt + advances): the drafting
            #: context every rollout continues from.
            self._trunk_ids = list(token_lists[0])

    # -- protocol ------------------------------------------------------------

    def propose(self) -> List[List[ScoredCandidate]]:
        """Root proposals (every slot starts with the empty sequence)."""
        self._check_open()
        spec = self.spec
        # k candidates x (n_roles - 1) agent evaluations per slot.
        scored = spec.n_slots * spec.k * (self.n_roles - 1)
        self.backend._tally(self.backend.token_counts, "scored", scored)
        self.dispatch_count += 1
        out = search_prefill(
            self.backend.params, self.backend.config, self._tokens, self._valid,
            spec.n_slots, self.n_roles, spec.temperature, spec.k, spec.sample,
            spec.max_steps, ref_bias=self._ref_bias,
            base_key=self._base_key, slot_offset=self._slot_offset,
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
        backend = self.backend
        backend._tally(backend.token_counts, "generated", spec.n_slots)
        backend._tally(backend.token_counts, "scored", spec.n_slots * spec.k * (self.n_roles - 1))
        backend._tally(backend.call_counts, "search_advances", 1)
        if self._proposer is not None:
            self._proposer.observe([c.token_id for c in chosen])
            self._trunk_ids.extend(c.token_id for c in chosen)
        self.dispatch_count += 1
        out = search_step(
            self.backend.params, self.backend.config, self._state,
            [int(p) for p in parents], [c.token_id for c in chosen], self._step - 1,
            spec.n_slots, self.n_roles, spec.temperature, spec.k, spec.sample,
            ref_bias=self._ref_bias,
            base_key=self._base_key, slot_offset=self._slot_offset,
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
        groups = _group_by_span(suffixes)
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
        scored = len(suffixes) * (span + spec.k) * (self.n_roles - 1)
        self.backend._tally(self.backend.token_counts, "scored", scored)
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
            base_key=self._base_key, salt=salt,
        )
        return self._unpack(packed.cpu().numpy()[: len(suffixes)])

    def rollout_from(
        self, suffix: Sequence[ScoredCandidate], depth: int, salt: int
    ) -> Tuple[List[int], str, List[float], bool]:
        """Continue ``depth`` reference-policy tokens past trunk+suffix and
        return (rollout token ids, rollout text, per-agent total logprob of
        the rollout tokens, ok): the MCTS rollout and its evaluation as one
        ``stepper.rollout_scored`` call.  Trunk sessions only.  The ids are
        authoritative; the text is for display."""
        self._check_rollout()
        if not suffix:
            raise ValueError("rollout_from needs a non-empty suffix")
        self.dispatch_count += 1
        rows = rollout_scored(
            self.backend.params, self.backend.config, self._state, self._step,
            self.backend._to_device(np.asarray([c.token_id for c in suffix], np.int32)),
            self.n_roles, depth,
            self.spec.temperature, self._eos_ids, self._base_key, salt,
        )
        return self._rollout_result(rows.cpu().numpy(), depth)

    def rollout_many(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], depth: int, salts: Sequence[int]
    ) -> List[Tuple[List[int], str, List[float], bool]]:
        """Batched :meth:`rollout_from` over a wave of tree paths
        (``tpu.py:2433-2503``).  Paths are grouped by suffix length; a
        singleton chunk delegates to ``rollout_from``, a larger one runs one
        ``rollout_scored_many`` call per chunk of at most
        :meth:`_rollout_chunk_cap` paths, the path count bucketed to at
        least 2 by repeating row 0 (sliced away).  With
        ``SearchSpec.speculative`` the drafts are verified instead
        (:meth:`_rollout_many_spec`)."""
        self._check_rollout()
        if len(salts) != len(suffixes):
            raise ValueError(f"expected {len(suffixes)} salts, got {len(salts)}")
        if not suffixes:
            return []
        if any(not s for s in suffixes):
            raise ValueError("rollout_many needs non-empty suffixes")
        if self._proposer is not None:
            return self._rollout_many_spec(suffixes, depth, salts)
        results: List[Optional[Tuple[List[int], str, List[float], bool]]] = [None] * len(suffixes)
        for span, idxs in _group_by_span(suffixes).items():
            cap = self._rollout_chunk_cap(span, depth)
            for lo in range(0, len(idxs), cap):
                chunk = idxs[lo : lo + cap]
                if len(chunk) == 1:
                    i = chunk[0]
                    results[i] = self.rollout_from(suffixes[i], depth, salts[i])
                    continue
                tokens, salt_arr = self._path_arrays(
                    [suffixes[i] for i in chunk], span, [salts[i] for i in chunk]
                )
                self.dispatch_count += 1
                rows = rollout_scored_many(
                    self.backend.params, self.backend.config, self._state, self._step,
                    tokens, salt_arr, self.n_roles, depth, self.spec.temperature,
                    self._eos_ids, self._base_key,
                ).cpu().numpy()
                for j, i in enumerate(chunk):
                    results[i] = self._rollout_result(rows[j], depth)
        return results

    def _rollout_many_spec(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], depth: int, salts: Sequence[int]
    ) -> List[Tuple[List[int], str, List[float], bool]]:
        """Speculative ``rollout_many`` (``tpu.py:2505-2613``): draft each
        path's whole remaining rollout from the n-gram proposer and verify
        every active path's draft in one ``rollout_verify_many`` call per
        round.  A round accepts each path's longest draft-matched prefix
        plus the first corrected token (standard rejection), so accepted
        token streams replay the sequential rollout, with agent totals
        equal to float tolerance; a perfect draft finishes a depth-d
        rollout in one round instead of d decode steps."""
        n_agents = self.n_roles - 1
        results: List[Optional[Tuple[List[int], str, List[float], bool]]] = [None] * len(suffixes)
        for span, idxs in _group_by_span(suffixes).items():
            cap = self._rollout_chunk_cap(span, depth)
            for lo in range(0, len(idxs), cap):
                chunk = idxs[lo : lo + cap]
                #: Per path: accepted rows [token, counted, lps...], and
                #: whether an EOS ended the counted stream.
                emitted: Dict[int, List[List[float]]] = {i: [] for i in chunk}
                finished = {i: False for i in chunk}
                contexts = {i: self._trunk_ids + [c.token_id for c in suffixes[i]] for i in chunk}
                while True:
                    active = [i for i in chunk if not finished[i] and len(emitted[i]) < depth]
                    if not active:
                        break
                    drafts: Dict[int, List[int]] = {}
                    for i in active:
                        accepted = [int(r[0]) for r in emitted[i]]
                        fresh = self._proposer.draft(contexts[i] + accepted, depth - len(accepted))
                        self.draft_tokens["proposed"] += len(fresh)
                        self._obs_spec_proposed.inc(len(fresh))
                        drafts[i] = accepted + fresh
                    tokens, salt_arr = self._path_arrays(
                        [suffixes[i] for i in active], span, [salts[i] for i in active]
                    )
                    draft_arr = np.asarray([drafts[i] for i in active], np.int32)
                    draft_arr = np.concatenate(
                        [draft_arr, np.repeat(draft_arr[:1], tokens.shape[0] - len(active), 0)]
                    )
                    self.dispatch_count += 1
                    self.draft_tokens["verify_dispatches"] += 1
                    rows = rollout_verify_many(
                        self.backend.params, self.backend.config, self._state, self._step,
                        tokens, self.backend._to_device(draft_arr), salt_arr, self.n_roles,
                        self.spec.temperature, self._eos_ids, self._base_key,
                    ).cpu().numpy()
                    for j, i in enumerate(active):
                        t = len(emitted[i])
                        while t < depth:
                            chosen = int(rows[j, t, 0])
                            is_eos = rows[j, t, 1] > 0.5
                            counted = 0.0 if is_eos else 1.0
                            emitted[i].append(
                                [float(chosen), counted] + [float(v) * counted for v in rows[j, t, 2:]]
                            )
                            matched = chosen == int(drafts[i][t])
                            if matched:
                                self.draft_tokens["verified"] += 1
                                self._obs_spec_verified.inc()
                            t += 1
                            if is_eos:
                                # Post-EOS tokens are uncounted in the
                                # sequential rollout: stop generating them.
                                finished[i] = True
                                break
                            if not matched:
                                # ``chosen`` is the correction; later rows
                                # were conditioned on the wrong draft.
                                break
                for i in chunk:
                    out = np.zeros((depth, 2 + n_agents), np.float32)
                    if emitted[i]:
                        got = np.asarray(emitted[i], np.float32)
                        out[: got.shape[0]] = got
                    results[i] = self._rollout_result(out, depth)
        return results

    def _rollout_chunk_cap(self, span: int, depth: int) -> int:
        """How many wave paths one rollout call may carry
        (``tpu.py:2615-2629``, one device): each path adds an (n_layers x
        n_roles x (span + depth)) decode tail on top of the scratch trunk
        copy the session's 2x reservation pre-books; the tails are capped
        at 1/8 of the reservation."""
        c = self.backend.config
        itemsize = torch.finfo(params_dtype(self.backend.params)).bits // 8
        per_path = (
            2 * c.n_layers * self.n_roles * (span + depth) * self.backend._kv_heads_per_card
            * c.head_dim * itemsize
        )
        return max(1, int((self._budget_bytes // 8) // max(per_path, 1)))

    def _rollout_result(
        self, rows: np.ndarray, depth: int
    ) -> Tuple[List[int], str, List[float], bool]:
        """Unpack one path's (depth, 2 + A) rollout rows, with the token
        accounting (``tpu.py:2631-2642``)."""
        counted = rows[:, 1] > 0.5
        ids = [int(rows[t, 0]) for t in range(depth) if counted[t]]
        self.backend._tally(self.backend.token_counts, "generated", len(ids))
        self.backend._tally(self.backend.token_counts, "scored", len(ids) * (self.n_roles - 1))
        text = "".join(self.backend.tokenizer.token_str(i) for i in ids)
        totals = [float(v) for v in rows[counted, 2:].sum(axis=0)]
        return ids, text, totals, True

    def _check_rollout(self) -> None:
        self._check_open()
        if self.spec.n_slots != 1:
            raise ValueError("rollouts require an n_slots=1 session")
        if self._state is None:
            raise ValueError("call propose() before a rollout")

    def _path_arrays(
        self, suffixes: Sequence[Sequence[ScoredCandidate]], span: int, salts: Sequence[int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (tokens (P', span), salts (P',)) for equal-length paths,
        the count bucketed to at least 2 by repeating row 0 (same salt:
        identical compute, sliced away by the caller)."""
        n_paths = _bucket(len(suffixes), minimum=2)
        tokens = np.zeros((n_paths, span), np.int32)
        salt_arr = np.zeros((n_paths,), np.int64)
        for j, (suffix, salt) in enumerate(zip(suffixes, salts)):
            tokens[j] = [c.token_id for c in suffix]
            salt_arr[j] = salt
        tokens[len(suffixes):] = tokens[0]
        salt_arr[len(suffixes):] = salt_arr[0]
        return self.backend._to_device(tokens), self.backend._to_device(salt_arr)

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


class _ShardedStream:
    """A generate cohort over the dp shards: each shard's rows run as one
    :class:`_PagedGenerateStream` on the shard's card, with the same stream
    protocol.  ``dispatch()`` launches every shard's window before any is
    waited on (a window holds no host sync); ``collect()`` gathers the
    windows back in row order."""

    def __init__(
        self,
        backend: TorchBackend,
        requests: List[GenerationRequest],
        decode_steps: int,
        speculative: bool,
        shards: Optional[Sequence[int]],
    ):
        dp = backend._dp
        if shards is None:
            block = -(-len(requests) // dp)
            shards = [row // block for row in range(len(requests))]
        groups: Dict[int, List[int]] = {}
        for row, shard in enumerate(shards):
            groups.setdefault(int(shard) % dp, []).append(row)
        self.speculative = bool(speculative)
        self._rows = list(groups.values())
        # Each shard's prefill runs on its own thread and card.
        self._parts = backend._map_shards(
            lambda s: _PagedGenerateStream(
                backend._shards[s], [requests[r] for r in groups[s]], decode_steps,
                speculative=speculative,
            ),
            list(groups),
        )
        self._devices = [backend._shards[s].device for s in groups]
        self._n_rows = len(requests)

    @property
    def finished(self) -> bool:
        return all(part.finished for part in self._parts)

    @property
    def spec_proposed(self) -> int:
        return sum(part.spec_proposed for part in self._parts)

    @property
    def spec_accepted(self) -> int:
        return sum(part.spec_accepted for part in self._parts)

    def dispatch(self) -> None:
        for part, device in zip(self._parts, self._devices):
            with _device_guard(device):
                part.dispatch()

    def collect(self) -> Tuple[List[int], Dict[int, GenerationResult]]:
        row_tokens = [0] * self._n_rows
        finished: Dict[int, GenerationResult] = {}
        for rows, part in zip(self._rows, self._parts):
            if part._pending is None:  # finished before this window
                continue
            tokens, done = part.collect()
            for local, row in enumerate(rows):
                row_tokens[row] = tokens[local]
            for local, result in done.items():
                finished[rows[local]] = result
        return row_tokens, finished

    def results(self) -> List[GenerationResult]:
        out: List[Optional[GenerationResult]] = [None] * self._n_rows
        for rows, part in zip(self._rows, self._parts):
            for row, result in zip(rows, part.results()):
                out[row] = result
        return out  # type: ignore[return-value]

    def close(self) -> None:
        for part in self._parts:
            part.close()


class _ShardedSearchSession:
    """A search session whose slots split over the dp shards: shard i holds
    slots ``[i*m, (i+1)*m)`` (all their roles) as a
    :class:`TorchTokenSearchSession` on its card, over its own copy of the
    prefix trunk.  A step launches every shard's part before any is waited
    on.  A slot whose parent lives on another shard takes the parent's
    tails by a device-to-device copy, made for every shard before any
    shard's step writes its tails in place.  Each slot draws the noise of
    its global index from one session key, so the proposals equal those of
    one session over every slot."""

    def __init__(self, backend: TorchBackend, spec: SearchSpec):
        self.backend = backend
        self.spec = spec
        dp = backend._dp
        self._m = spec.n_slots // dp
        if spec.seed is None:
            key = backend._fold_seed("search", "unseeded", backend._next_nonce())
        else:
            key = backend._fold_seed("search", spec.seed)
        sub_spec = dataclasses.replace(spec, n_slots=self._m)
        self._subs: List[TorchTokenSearchSession] = []
        try:
            for i in range(dp):
                self._subs.append(TorchTokenSearchSession(
                    backend._shards[i], sub_spec, base_key=key, slot_offset=i * self._m,
                ))
        except BaseException:
            self.close()
            raise
        self.n_roles = self._subs[0].n_roles

    @property
    def dispatch_count(self) -> int:
        return self._subs[0].dispatch_count if self._subs else 0

    def _on_subs(self, fn) -> List[List[ScoredCandidate]]:
        parts = self.backend._map_shards(lambda i: fn(i, self._subs[i]), range(len(self._subs)))
        return [row for part in parts for row in part]

    def propose(self) -> List[List[ScoredCandidate]]:
        return self._on_subs(lambda i, sub: sub.propose())

    def advance_and_propose(
        self, parents: Sequence[int], chosen: Sequence[ScoredCandidate]
    ) -> List[List[ScoredCandidate]]:
        spec, m = self.spec, self._m
        if len(parents) != spec.n_slots or len(chosen) != spec.n_slots:
            raise ValueError(
                f"expected {spec.n_slots} (parent, token) pairs, got "
                f"{len(parents)}/{len(chosen)}"
            )
        parents = [int(p) for p in parents]
        local_parents = []
        moved = {}
        for i, sub in enumerate(self._subs):
            mine = parents[i * m : (i + 1) * m]
            if all(i * m <= p < (i + 1) * m for p in mine):
                local_parents.append([p - i * m for p in mine])
                continue
            if sub._state is None:
                raise ValueError("call propose() before advance_and_propose()")
            moved[i] = self._gathered_state(sub, mine)
            local_parents.append(list(range(m)))
        for i, state in moved.items():
            self._subs[i]._state = state
        return self._on_subs(
            lambda i, sub: sub.advance_and_propose(
                local_parents[i], chosen[i * m : (i + 1) * m]
            )
        )

    def _gathered_state(self, sub: TorchTokenSearchSession, parents: Sequence[int]):
        """``sub``'s state with the tails of its slots' (global) parents,
        copied from whichever shard holds them onto ``sub``'s card."""
        roles, device = self.n_roles, sub.backend.device
        pieces: Dict[str, list] = {"tail_k": [], "tail_v": [], "tail_positions": [], "cur_pos": []}
        for p in parents:
            src = self._subs[p // self._m]._state
            if src is None:
                raise ValueError("call propose() before advance_and_propose()")
            rows = slice((p % self._m) * roles, (p % self._m + 1) * roles)
            pieces["tail_k"].append(to_devices(src.tail_k[:, rows], sub.backend._tp_devices))
            pieces["tail_v"].append(to_devices(src.tail_v[:, rows], sub.backend._tp_devices))
            pieces["tail_positions"].append(src.tail_positions[rows].to(device))
            pieces["cur_pos"].append(src.cur_pos[rows].to(device))
        return sub._state._replace(
            tail_k=torch.cat(pieces["tail_k"], dim=1),
            tail_v=torch.cat(pieces["tail_v"], dim=1),
            tail_positions=torch.cat(pieces["tail_positions"]),
            cur_pos=torch.cat(pieces["cur_pos"]),
        )

    def _single_slot_only(self, *args, **kwargs):
        raise ValueError("tree paths and rollouts require an n_slots=1 session")

    propose_suffixes = rollout_from = rollout_many = _single_slot_only

    def close(self) -> None:
        for sub in getattr(self, "_subs", []):
            sub.close()

    def __del__(self):
        self.close()
