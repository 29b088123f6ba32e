"""Batched autoregressive generation (PyTorch port of
``consensus_tpu/models/generate.py``).

Prompts are LEFT-padded so every row's next token writes the same cache
column.  Rows with no valid prompt token (bucket padding) start done, and
every decode loop exits as soon as every row has emitted an EOS id.

* ``generate_tokens`` -- the classic path, as the reference runs it: the
  prompt batch prefills once into a per-row trunk, then ONE
  ``_decode_segment`` as long as the budget decodes every row over its own
  trunk plus a fresh tail (``transformer.forward_trunk_tail`` with
  ``n_slots=1, n_roles=B``), so with ``config.use_decode_attention`` every
  step attends through the decode kernel.
* ``generate_tokens_shared_trunk`` -- B rows from ONE shared prompt: the
  prompt prefills once into a one-row trunk that every row attends
  (``transformer.forward_trunk_tail`` with ``n_slots=B, n_roles=1``), so a
  step reads the prompt's keys once for all rows.
* ``generate_tokens_shared_trunk_segmented`` and ``generate_tokens_segmented``
  -- the same two layouts (shared trunk; per-row trunks, ``n_slots=1,
  n_roles=B``) as a host loop over ``seg_len``-step segments: each segment
  writes a fresh ``seg_len``-column tail, finished segments stay as a list of
  read-only frozen blocks, rows that finished compact away by halving the
  batch, and with ``kv_quant`` the tails (and the per-row prompt trunk) are
  int8 with per-(token, head) scales.
* ``next_token_topk`` / ``next_token_logits`` -- one cacheless forward of
  the prompt batch and the last position's distribution: the
  ``Backend.next_token_logprobs`` primitive of the full-prefix search
  session.

Each row carries its own threefry key ((B, 2), ``utils/threefry.py``) and
splits it once per step exactly as ``generate.py:352-356`` does
(``vmap(split)`` -> key, sub; sub draws the token), so a seed draws the
JAX package's tokens.  Keys move with their rows when rows compact, so a
row's tokens depend on its own key only, whatever else shares the batch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.sampling import sample_tokens
from consensus_tpu_torch.models.transformer import (
    KVCache,
    forward,
    forward_trunk_tail,
    make_cache,
    params_dtype,
    project_logits,
    quantize_kv,
)
from consensus_tpu_torch.utils import threefry


class GenerateOutput(NamedTuple):
    """Decode results: tensors on the model's device, or on the CPU from the
    segmented host loops, which gather their segments there."""

    tokens: torch.Tensor  # (B, max_new_tokens) int32; pad_id after EOS
    num_generated: torch.Tensor  # (B,) int32 -- tokens before (excluding) EOS
    hit_eos: torch.Tensor  # (B,) bool


def _assemble_output(tokens_buf, emitted_buf, max_new_tokens: int, pad_id: int) -> GenerateOutput:
    """(T, B) step buffers -> GenerateOutput."""
    tokens, emitted = tokens_buf.t(), emitted_buf.t()
    num_generated = emitted.sum(dim=1, dtype=torch.int32)
    return GenerateOutput(
        tokens=torch.where(emitted, tokens, torch.full_like(tokens, pad_id)),
        num_generated=num_generated,
        hit_eos=num_generated < max_new_tokens,
    )


def left_pad_positions(valid: torch.Tensor) -> torch.Tensor:
    """RoPE positions for a left-padded valid mask: pads clamp to 0."""
    return torch.clamp(torch.cumsum(valid.to(torch.int32), dim=1) - 1, min=0)


#: The absmax-int8 KV quantizer of the per-step tail writes
#: (``transformer.quantize_kv``), used for whole prompt trunks too, so the
#: two scale layouts cannot drift apart.
_quantize_kv = quantize_kv


def _prompt_presence(
    prompt_tokens: torch.Tensor, prompt_valid: torch.Tensor, vocab_size: int
) -> torch.Tensor:
    """(B, V) bool mask of the prompt's token ids (repetition penalty)."""
    rows = prompt_tokens.shape[0]
    presence = torch.zeros((rows, vocab_size), dtype=torch.bool, device=prompt_tokens.device)
    presence[
        torch.arange(rows, device=prompt_tokens.device)[:, None].expand_as(prompt_tokens)[prompt_valid],
        prompt_tokens.long()[prompt_valid],
    ] = True
    return presence


def _prefill_classic(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (B, S_ctx), LEFT-padded
    prompt_valid: torch.Tensor,  # (B, S_ctx) bool
):
    """Prefill per-row prompts -> (next_logits (B, V), trunk, last_pos (B,))."""
    cache = make_cache(
        config, prompt_tokens.shape[0], prompt_tokens.shape[1], params_dtype(params),
        prompt_tokens.device,
    )
    positions = left_pad_positions(prompt_valid)
    hidden, cache = forward(
        params, config, prompt_tokens, positions, prompt_valid, cache, 0,
        return_hidden=True,
    )
    next_logits = project_logits(params, config, hidden[:, -1, :])
    return next_logits, cache, positions[:, -1]


@torch.no_grad()
def generate_tokens(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (B, S_ctx) int, LEFT-padded
    prompt_valid: torch.Tensor,  # (B, S_ctx) bool
    max_new_tokens: int,
    keys: Optional[torch.Tensor] = None,  # (B, 2) per-row threefry keys
    temperature: float | torch.Tensor = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_ids: Optional[torch.Tensor] = None,  # (E,) int; None/empty = no EOS stop
    logit_bias: Optional[torch.Tensor] = None,  # (V,) or (B, V) additive
    bias_table: Optional[torch.Tensor] = None,  # (U, V) unique bias vectors
    bias_index: Optional[torch.Tensor] = None,  # (B,) row -> table index
    pad_id: int = 0,
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32; None = off
) -> GenerateOutput:
    """Prefill + ONE full-budget ``_decode_segment`` over per-row trunks
    (``generate.py:112-161``).  Bucket-padding rows (no valid prompt token)
    start done, so they never hold the EOS exit off."""
    batch = prompt_tokens.shape[0]
    next_logits, trunk, cur_pos = _prefill_classic(params, config, prompt_tokens, prompt_valid)
    presence = (
        _prompt_presence(prompt_tokens, prompt_valid, config.vocab_size)
        if rep_penalty is not None
        else None
    )
    tokens_buf, emitted_buf, *_ = _decode_segment(
        params, config, trunk, (), (), cur_pos, 0, next_logits, keys,
        ~prompt_valid.any(dim=1), n_slots=1, n_roles=batch, seg_len=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, eos_ids=eos_ids,
        logit_bias=logit_bias, bias_table=bias_table, bias_index=bias_index,
        pad_id=pad_id, presence=presence, rep_penalty=rep_penalty,
    )
    return _assemble_output(tokens_buf, emitted_buf, max_new_tokens, pad_id)


@torch.no_grad()
def generate_tokens_shared_trunk(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (1, S_ctx) int -- ONE shared prompt, LEFT-padded
    prompt_valid: torch.Tensor,  # (1, S_ctx) bool
    batch: int,  # rows to decode from the shared prompt
    max_new_tokens: int,
    keys: Optional[torch.Tensor] = None,  # (B, 2) per-row threefry keys
    temperature: float | torch.Tensor = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_ids: Optional[torch.Tensor] = None,
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    init_done: Optional[torch.Tensor] = None,  # (B,) bool -- bucket-pad rows
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32; None = off
) -> GenerateOutput:
    """``generate_tokens`` for B rows sharing ONE prompt (``generate.py:164-227``):
    the prompt prefills once into a one-row trunk and every row attends it,
    so a step reads ctx + B*t keys instead of B*(ctx + t).  One segment as
    long as the budget, so with ``config.use_decode_attention`` every step
    attends through the decode kernel."""
    c = config
    next_logits_1, trunk, last_pos = _prefill_shared(params, c, prompt_tokens, prompt_valid)
    device = prompt_tokens.device
    if init_done is None:
        init_done = torch.zeros((batch,), dtype=torch.bool, device=device)
    presence = (
        _prompt_presence(prompt_tokens, prompt_valid, c.vocab_size).expand(batch, -1).clone()
        if rep_penalty is not None
        else None
    )
    tokens_buf, emitted_buf, *_ = _decode_segment(
        params, c, trunk, (), (), last_pos.expand(batch), 0,
        next_logits_1.expand(batch, -1), keys, init_done,
        n_slots=batch, n_roles=1, seg_len=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_ids=eos_ids, bias_table=bias_table,
        bias_index=bias_index, pad_id=pad_id, presence=presence, rep_penalty=rep_penalty,
    )
    return _assemble_output(tokens_buf, emitted_buf, max_new_tokens, pad_id)


def _prefill_shared(params, config: ModelConfig, prompt_tokens, prompt_valid):
    """Prefill one shared prompt row -> (next_logits (1, V), trunk, last_pos ())."""
    trunk = make_cache(
        config, 1, prompt_tokens.shape[1], params_dtype(params), prompt_tokens.device
    )
    positions = left_pad_positions(prompt_valid)
    hidden, trunk = forward(
        params, config, prompt_tokens, positions, prompt_valid, trunk, 0, return_hidden=True
    )
    return project_logits(params, config, hidden[:, -1, :]), trunk, positions[0, -1]


def _decode_segment(
    params,
    config: ModelConfig,
    trunk: KVCache,  # n_roles rows: one shared row, or one per request
    frozen_k: Sequence,  # (L, B, F_i, KV, hd) blocks or (int8, scale) pairs
    frozen_v: Sequence,
    base_pos: torch.Tensor,  # (B,) int32 -- per-row last prompt position
    seg_start: int,  # tokens decoded before this segment
    next_logits: torch.Tensor,  # (B, V) float32
    keys: Optional[torch.Tensor],  # (B, 2) per-row threefry keys
    done: torch.Tensor,  # (B,) bool
    n_slots: int,
    n_roles: int,
    seg_len: int,
    temperature: float | torch.Tensor,  # scalar or (B,)
    top_k: int = 0,
    top_p: float = 1.0,
    eos_ids: Optional[torch.Tensor] = None,
    logit_bias: Optional[torch.Tensor] = None,  # (V,) or (B, V) additive
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    quantize_tail: bool = False,
    presence: Optional[torch.Tensor] = None,  # (B, V) bool seen-token mask, updated in place
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32
):
    """One ``seg_len``-step slice of a decode over B = n_slots * n_roles rows
    (``generate.py:248-398``): a fresh ``seg_len``-column tail (int8 with
    ``quantize_tail``) after the frozen blocks of earlier segments, one
    ``forward_trunk_tail`` per step, exiting once every row is done.
    Serves both layouts: shared trunk (n_slots=B, n_roles=1) and per-row
    trunks (n_slots=1, n_roles=B).  Every step splits each row's key (key,
    sub) and samples with sub, as the reference does; a decode that is
    greedy in every row needs no keys.  Returns (tokens (seg_len, B),
    emitted (seg_len, B), next_logits, tail_k, tail_v, done, keys,
    presence)."""
    c = config
    batch = n_slots * n_roles
    device = next_logits.device
    if eos_ids is None:
        eos_ids = torch.zeros((0,), dtype=torch.int32, device=device)
    if bias_table is not None:
        logit_bias = bias_table[bias_index.long()]
    frozen_positions = []
    offset = 0
    for block in frozen_k:
        width = (block[0] if isinstance(block, tuple) else block).shape[2]
        cols = torch.arange(width, dtype=torch.int32, device=device)
        frozen_positions.append(base_pos[:, None] + 1 + offset + cols[None, :])
        offset += width
    cur_pos = base_pos + seg_start
    tail_positions = cur_pos[:, None] + 1 + torch.arange(seg_len, dtype=torch.int32, device=device)
    tail_shape = (c.n_layers, batch, seg_len, c.n_kv_heads, c.head_dim)
    if quantize_tail:
        scale_shape = tail_shape[:-1] + (1,)
        tail_k, tail_v = (
            (torch.zeros(tail_shape, dtype=torch.int8, device=device),
             torch.zeros(scale_shape, dtype=torch.float32, device=device))
            for _ in range(2)
        )
    else:
        dtype = params_dtype(params)
        tail_k, tail_v = (torch.zeros(tail_shape, dtype=dtype, device=device) for _ in range(2))
    tokens_buf = torch.full((seg_len, batch), pad_id, dtype=torch.int32, device=device)
    emitted_buf = torch.zeros((seg_len, batch), dtype=torch.bool, device=device)
    use_rp = presence is not None and rep_penalty is not None
    rows = torch.arange(batch, device=device)
    # A decode that is greedy in every row never reads its keys (nor do later
    # segments of it), so it skips the splits: ~170 small kernels a step.
    sampling = keys is not None and bool(
        (torch.as_tensor(temperature, dtype=torch.float32) > 0.0).any()
    )

    for step in range(seg_len):
        if bool(done.all()):
            break
        sub = None
        if sampling:
            pairs = threefry.split(keys)
            keys, sub = pairs[:, 0], pairs[:, 1]
        token = sample_tokens(
            next_logits, temperature=temperature, top_k=top_k, top_p=top_p,
            logit_bias=logit_bias, presence=presence if use_rp else None,
            rep_penalty=rep_penalty if use_rp else None, keys=sub,
        )
        token = torch.where(done, torch.full_like(token, pad_id), token)
        if use_rp:
            presence[rows, token.long()] = True
        token_is_eos = torch.isin(token, eos_ids) & ~done
        emitted = ~done & ~token_is_eos
        done = done | token_is_eos
        cur_pos = cur_pos + 1
        hidden, tail_k, tail_v = forward_trunk_tail(
            params, c, token, cur_pos, trunk, tail_k, tail_v, tail_positions, step,
            n_slots, n_roles, frozen_k=frozen_k, frozen_v=frozen_v,
            frozen_positions=frozen_positions,
        )
        next_logits = project_logits(params, c, hidden)
        tokens_buf[step] = token
        emitted_buf[step] = emitted
    return tokens_buf, emitted_buf, next_logits, tail_k, tail_v, done, keys, presence


def _take_rows(block, idx: torch.Tensor, dim: int):
    """Row gather of a dense tensor or an (int8, scale) pair."""
    if isinstance(block, tuple):
        return tuple(part.index_select(dim, idx) for part in block)
    return block.index_select(dim, idx)


def _segmented_loop(
    params,
    config: ModelConfig,
    trunk: KVCache,
    base_pos: torch.Tensor,  # (B,) int32 per-row last prompt position
    next_logits: torch.Tensor,  # (B, V)
    keys: Optional[torch.Tensor],  # (B, 2) per-row threefry keys
    done: torch.Tensor,
    n_slots: int,
    n_roles: int,
    max_new_tokens: int,
    seg_len: int,
    temperature: torch.Tensor,  # (B,) float32
    top_k: int,
    top_p: float,
    eos_ids: Optional[torch.Tensor],
    bias_table,
    bias_index,
    pad_id: int,
    logit_bias=None,
    kv_quant: bool = False,
    presence: Optional[torch.Tensor] = None,
    rep_penalty: Optional[torch.Tensor] = None,
) -> GenerateOutput:
    """Host loop over ``_decode_segment`` calls shared by both layouts
    (``generate.py:401-549``).

    Between segments the host stops once every row is done.  A finished
    segment's tail (already int8 under ``kv_quant``) is appended to the
    LIST of frozen blocks, never concatenated.  Rows that finished compact
    away, but only by HALVING the batch (and never below 8 rows): every
    per-row tensor, the per-row keys and, in the classic layout, the
    per-row trunk gather down to the survivors, padded with done rows.
    Each row keeps its own key, so compaction changes no token, only the
    work per step."""
    batch = n_slots * n_roles
    shared_layout = n_roles == 1
    row_map = np.arange(batch)  # current row -> original row

    frozen_k: List = []
    frozen_v: List = []
    tokens = np.full((batch, max_new_tokens), pad_id, np.int32)
    emitted = np.zeros((batch, max_new_tokens), bool)
    n_segs = max_new_tokens // seg_len
    for seg in range(n_segs):
        tokens_buf, emitted_buf, next_logits, tail_k, tail_v, done, keys, presence = _decode_segment(
            params, config, trunk, tuple(frozen_k), tuple(frozen_v), base_pos, seg * seg_len,
            next_logits, keys, done,
            n_slots=batch if shared_layout else 1, n_roles=1 if shared_layout else batch,
            seg_len=seg_len, temperature=temperature, top_k=top_k, top_p=top_p,
            eos_ids=eos_ids, logit_bias=logit_bias, bias_table=bias_table,
            bias_index=bias_index, pad_id=pad_id, quantize_tail=kv_quant,
            presence=presence, rep_penalty=rep_penalty,
        )
        col = seg * seg_len
        tokens[row_map, col : col + seg_len] = tokens_buf.t().cpu().numpy()
        emitted[row_map, col : col + seg_len] = emitted_buf.t().cpu().numpy()
        if seg + 1 == n_segs:
            break
        done_host = done.cpu().numpy()
        if done_host.all():
            break
        frozen_k.append(tail_k)
        frozen_v.append(tail_v)
        alive = np.flatnonzero(~done_host)
        target = batch
        while target // 2 >= len(alive) and target // 2 >= 8:
            target //= 2
        if target == batch:
            continue
        # Pad the survivors with done rows up to the bucket (their outputs
        # are discarded; they stay done).
        idx_host = np.concatenate([alive, np.flatnonzero(done_host)[: target - len(alive)]])
        idx = torch.from_numpy(idx_host).to(done.device)
        row_map = row_map[idx_host]
        frozen_k = [_take_rows(b, idx, 1) for b in frozen_k]
        frozen_v = [_take_rows(b, idx, 1) for b in frozen_v]
        next_logits, done = next_logits[idx], done[idx]
        base_pos, temperature = base_pos[idx], temperature[idx]
        if keys is not None:
            keys = keys[idx]
        if bias_index is not None:
            bias_index = bias_index[idx]
        if logit_bias is not None and logit_bias.dim() == 2:
            logit_bias = logit_bias[idx]
        if presence is not None:
            presence = presence[idx]
        if rep_penalty is not None:
            rep_penalty = rep_penalty[idx]
        if not shared_layout:
            trunk = KVCache(
                k=_take_rows(trunk.k, idx, 1), v=_take_rows(trunk.v, idx, 1),
                key_positions=trunk.key_positions[idx], key_valid=trunk.key_valid[idx],
            )
        batch = target

    num_generated = emitted.sum(axis=1).astype(np.int32)
    return GenerateOutput(
        tokens=torch.from_numpy(np.where(emitted, tokens, pad_id).astype(np.int32)),
        num_generated=torch.from_numpy(num_generated),
        hit_eos=torch.from_numpy(num_generated < max_new_tokens),
    )


def _check_segmented(config: ModelConfig, max_new_tokens: int, seg_len: int) -> None:
    if config.use_decode_attention:
        # The decode kernel has no frozen-block variant: segment 0 would use
        # the kernel and later segments the einsum route.
        raise ValueError(
            "segmented decode is incompatible with use_decode_attention; "
            "use the monolithic decode path instead"
        )
    if max_new_tokens % seg_len:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} must be a multiple of "
            f"seg_len={seg_len} (bucketed widths are)"
        )


def _row_temperatures(temperature, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(temperature, dtype=torch.float32, device=device).expand(batch).clone()


@torch.no_grad()
def generate_tokens_shared_trunk_segmented(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (1, S_ctx) int -- ONE shared prompt, LEFT-padded
    prompt_valid: torch.Tensor,  # (1, S_ctx) bool
    batch: int,
    max_new_tokens: int,
    keys: Optional[torch.Tensor] = None,  # (B, 2) per-row threefry keys
    seg_len: int = 128,
    temperature: float | torch.Tensor = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_ids: Optional[torch.Tensor] = None,
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    init_done: Optional[torch.Tensor] = None,
    kv_quant: bool = False,
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32; None = off
) -> GenerateOutput:
    """``generate_tokens_shared_trunk`` as a host loop over ``seg_len``-step
    segments (``generate.py:552-628``): the same sampling, over the same
    keys, with a ``seg_len``-column live tail; earlier segments are frozen
    blocks."""
    c = config
    _check_segmented(c, max_new_tokens, seg_len)
    device = prompt_tokens.device
    next_logits_1, trunk, last_pos = _prefill_shared(params, c, prompt_tokens, prompt_valid)
    done = torch.zeros((batch,), dtype=torch.bool, device=device) if init_done is None else init_done
    presence = (
        _prompt_presence(prompt_tokens, prompt_valid, c.vocab_size).expand(batch, -1).clone()
        if rep_penalty is not None
        else None
    )
    return _segmented_loop(
        params, c, trunk, last_pos.expand(batch), next_logits_1.expand(batch, -1),
        keys, done, n_slots=batch, n_roles=1, max_new_tokens=max_new_tokens,
        seg_len=seg_len, temperature=_row_temperatures(temperature, batch, device),
        top_k=top_k, top_p=top_p, eos_ids=eos_ids, bias_table=bias_table,
        bias_index=bias_index, pad_id=pad_id, kv_quant=kv_quant, presence=presence,
        rep_penalty=rep_penalty,
    )


@torch.no_grad()
def generate_tokens_segmented(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (B, S_ctx) int, LEFT-padded
    prompt_valid: torch.Tensor,  # (B, S_ctx) bool
    max_new_tokens: int,
    keys: Optional[torch.Tensor] = None,  # (B, 2) per-row threefry keys
    seg_len: int = 128,
    temperature: float | torch.Tensor = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_ids: Optional[torch.Tensor] = None,
    logit_bias: Optional[torch.Tensor] = None,
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    kv_quant: bool = False,
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32; None = off
) -> GenerateOutput:
    """``generate_tokens`` (per-row prompts) as a host loop over segments
    (``generate.py:652-734``): the per-row prompt cache is a read-only trunk
    (n_slots=1, n_roles=B), int8 under ``kv_quant`` since every step re-reads
    it, and earlier segments are frozen blocks."""
    batch = prompt_tokens.shape[0]
    _check_segmented(config, max_new_tokens, seg_len)
    next_logits, trunk, last_pos = _prefill_classic(params, config, prompt_tokens, prompt_valid)
    if kv_quant:
        trunk = KVCache(
            k=_quantize_kv(trunk.k), v=_quantize_kv(trunk.v),
            key_positions=trunk.key_positions, key_valid=trunk.key_valid,
        )
    presence = (
        _prompt_presence(prompt_tokens, prompt_valid, config.vocab_size)
        if rep_penalty is not None
        else None
    )
    return _segmented_loop(
        params, config, trunk, last_pos, next_logits, keys, ~prompt_valid.any(dim=1),
        n_slots=1, n_roles=batch, max_new_tokens=max_new_tokens, seg_len=seg_len,
        temperature=_row_temperatures(temperature, batch, prompt_tokens.device),
        top_k=top_k, top_p=top_p, eos_ids=eos_ids, logit_bias=logit_bias,
        bias_table=bias_table, bias_index=bias_index, pad_id=pad_id, kv_quant=kv_quant,
        presence=presence, rep_penalty=rep_penalty,
    )


# ---------------------------------------------------------------------------
# Next-token distribution
# ---------------------------------------------------------------------------


def next_token_logits(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (B, S) LEFT-padded
    prompt_valid: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    """Full next-token logit rows (B, V) float32: one forward, no cache
    (``generate.py:784-800``).  The forward is the one prefill runs, so with
    ``config.use_flash_attention`` it attends through the flash kernel."""
    positions = left_pad_positions(prompt_valid)
    hidden, _ = forward(params, config, prompt_tokens, positions, prompt_valid, return_hidden=True)
    return project_logits(params, config, hidden[:, -1, :])


def next_token_topk(
    params,
    config: ModelConfig,
    prompt_tokens: torch.Tensor,  # (B, S) LEFT-padded
    prompt_valid: torch.Tensor,  # (B, S) bool
    keys: torch.Tensor,  # (B, 2) per-row threefry keys (Gumbel perturbation)
    k: int,
    temperature: torch.Tensor,  # (B,) float32
    use_gumbel: torch.Tensor,  # (B,) bool -- False rows take deterministic top-k
    bias_table: Optional[torch.Tensor] = None,  # (U, V) unique bias vectors
    bias_index: Optional[torch.Tensor] = None,  # (B,) row -> table index
    with_gumbel: bool = True,  # False: skip the (B, V) noise for pure top-k batches
) -> tuple:
    """Top-k next-token candidates per row, selected on the device
    (``generate.py:737-781``): (ids (B, k) int32, logprobs (B, k) float32),
    so only O(B k) crosses to the host.

    Scores are ``log_softmax(logits + bias) / max(temp, 1e-6)`` plus, on
    ``use_gumbel`` rows, Gumbel noise from each row's key
    (``threefry.gumbel``, bit for bit ``jax.random.gumbel``).  On the other
    rows positive temperature scaling keeps the order, so their top-k by
    score is the top-k by logprob.  Results come back in SCORE order
    (Gumbel-top-k is sampling without replacement: a caller wanting fewer
    candidates takes a prefix); the logprobs are the true (biased,
    untempered) log-softmax values."""
    logits = next_token_logits(params, config, prompt_tokens, prompt_valid)
    if bias_table is not None:
        logits = logits + bias_table[bias_index]
    logprobs = torch.log_softmax(logits, dim=-1)
    scores = logprobs / torch.clamp(temperature, min=1e-6)[:, None]
    if with_gumbel:
        noise = threefry.gumbel(keys, (logits.shape[-1],))
        scores = scores + noise * use_gumbel[:, None].to(torch.float32)
    ids = torch.topk(scores, k, dim=-1).indices
    return ids.to(torch.int32), torch.gather(logprobs, 1, ids)
