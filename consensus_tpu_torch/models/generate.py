"""Batched autoregressive generation with a preallocated KV cache (PyTorch
port of the classic path of ``consensus_tpu/models/generate.py``).

Prompts are LEFT-padded so every row's next token writes the same cache
column.  ``generate_tokens`` prefills the prompt batch once into a cache of
``S_ctx + max_new_tokens`` columns, then decodes one token per step through
``transformer.forward`` with the cache, exiting as soon as every row has
emitted an EOS id.  Rows with no valid prompt token (bucket padding) start
done.

The JAX decode attends a prompt trunk plus a separate generated tail
(``forward_trunk_tail``); here both live in one cache and the keys seen at
each step are the same set.  The shared-trunk and segmented variants, and
int8 generated KV, are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.sampling import sample_tokens
from consensus_tpu_torch.models.transformer import (
    forward,
    make_cache,
    params_dtype,
    project_logits,
)


class GenerateOutput(NamedTuple):
    """Decode results, as tensors on the model's device."""

    tokens: torch.Tensor  # (B, max_new_tokens) int32; pad_id after EOS
    num_generated: torch.Tensor  # (B,) int32 -- tokens before (excluding) EOS
    hit_eos: torch.Tensor  # (B,) bool


def left_pad_positions(valid: torch.Tensor) -> torch.Tensor:
    """RoPE positions for a left-padded valid mask: pads clamp to 0."""
    return torch.clamp(torch.cumsum(valid.to(torch.int32), dim=1) - 1, min=0)


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
    cache_len: int,
):
    """Prefill per-row prompts -> (next_logits (B, V), cache, last_pos (B,))."""
    cache = make_cache(
        config, prompt_tokens.shape[0], cache_len, params_dtype(params),
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
    generators: Optional[Sequence[torch.Generator]] = None,  # one per row
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
    """Prefill + decode loop with EOS early exit (``generate.py:112-157``)."""
    batch, width = prompt_tokens.shape
    device = prompt_tokens.device
    next_logits, cache, cur_pos = _prefill_classic(
        params, config, prompt_tokens, prompt_valid, width + max_new_tokens
    )
    if bias_table is not None:
        logit_bias = bias_table[bias_index.long()]
    if eos_ids is None:
        eos_ids = torch.zeros((0,), dtype=torch.int32, device=device)
    presence = (
        _prompt_presence(prompt_tokens, prompt_valid, config.vocab_size)
        if rep_penalty is not None
        else None
    )
    done = ~prompt_valid.any(dim=1)
    tokens_buf = torch.full((batch, max_new_tokens), pad_id, dtype=torch.int32, device=device)
    emitted_buf = torch.zeros((batch, max_new_tokens), dtype=torch.bool, device=device)
    step_valid = torch.ones((batch, 1), dtype=torch.bool, device=device)
    rows = torch.arange(batch, device=device)

    for step in range(max_new_tokens):
        if bool(done.all()):
            break
        token = sample_tokens(
            next_logits, temperature=temperature, top_k=top_k, top_p=top_p,
            logit_bias=logit_bias, presence=presence, rep_penalty=rep_penalty,
            generators=generators,
        )
        token = torch.where(done, torch.full_like(token, pad_id), token)
        if presence is not None:
            presence[rows, token.long()] = True
        token_is_eos = torch.isin(token, eos_ids) & ~done
        emitted = ~done & ~token_is_eos
        done = done | token_is_eos

        cur_pos = cur_pos + 1
        hidden, cache = forward(
            params, config, token[:, None], cur_pos[:, None], step_valid,
            cache, width + step, return_hidden=True,
        )
        next_logits = project_logits(params, config, hidden[:, -1, :])
        tokens_buf[:, step] = token
        emitted_buf[:, step] = emitted

    num_generated = emitted_buf.sum(dim=1, dtype=torch.int32)
    hit_eos = num_generated < max_new_tokens
    tokens = torch.where(emitted_buf, tokens_buf, torch.full_like(tokens_buf, pad_id))
    return GenerateOutput(tokens=tokens, num_generated=num_generated, hit_eos=hit_eos)
