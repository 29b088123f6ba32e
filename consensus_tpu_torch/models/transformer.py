"""Decoder-only transformer runtime (Gemma-2 / Llama-3 families), PyTorch port.

Counterpart of ``consensus_tpu/models/transformer.py``.  Parameters are a
plain dict: ``embed`` (V, D), ``final_norm`` (D,), optional ``lm_head``
(V, D), and ``layers``, a list with one dict per layer whose matmul weights
keep the JAX layout (d_in, d_out).  Weights may be int8
:class:`~consensus_tpu_torch.models.quant.QTensor`s.

* ``forward`` with no cache attends through the hand-written flash kernel
  when ``config.use_flash_attention`` is set (``ops/flash_attention.py``);
  the Gemma-2 local/global choice is a Python branch per layer where the
  JAX package used ``lax.cond``.
* ``forward`` with a cache is the einsum path of the JAX package
  (``transformer.py:329-341``): the cache is written IN PLACE at
  ``write_index`` (the JAX version returns a new cache; here the same
  object comes back updated, which saves a copy per step).
* ``forward_trunk_tail`` is the body of every fused token-search step and
  of every decode step of the shared-trunk and segmented generators: one
  position per (slot x role) row over a trunk shared by the slots, frozen
  blocks of earlier decode segments and per-row tails, any of them int8
  (``quantize_kv``).  It attends through the hand-written decode kernel
  (``ops/decode_attention.py``) when ``config.use_decode_attention`` is set
  and there is no frozen or int8 block, else through einsums.
* ``forward_shared_trunk`` runs lookahead path suffixes, the prefill of
  MCTS's batched rollouts (with their roped suffix keys and values), and the
  continuations of shared-context scoring (``shared_context_prefill``,
  ``shared_context_cont_logprobs``), over one shared trunk (einsum
  attention, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import (
    QTensor,
    gather_target_logits,
    head_matmul,
    matmul,
    quantize,
    slice_rows,
    take_rows,
)
from consensus_tpu_torch.ops.decode_attention import decode_attention
from consensus_tpu_torch.ops.flash_attention import flash_attention
from consensus_tpu_torch.parallel.tensor import (
    Ranked,
    all_reduce,
    gather_vocab,
    is_tp,
    kv_zeros,
    lead_part,
    rank_views,
)

Params = Dict[str, Any]

MASK_FILL = -1e9  # finite fill: pad query rows softmax to uniform, not NaN


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
    int8: bool = False,
) -> Params:
    """Random-normal parameters drawn on ``device`` from ``generator``.

    The distributions follow the JAX ``init_params`` (normal weights scaled
    by d_in^-0.5, embedding x0.02, lm_head x d_model^-0.5, norms at their
    identity values); the numbers differ, since the generators do.  With
    ``int8`` every matmul weight is quantized as soon as it is drawn, so the
    full-precision tree never exists at once (llama3-8b in bf16 is 16 GB)."""
    c = config
    device = torch.device(device)

    def normal(*shape, scale: float) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def dense(d_in: int, d_out: int):
        w = normal(d_in, d_out, scale=d_in ** -0.5)
        return quantize(w, contract_axis=0) if int8 else w

    def norm() -> torch.Tensor:
        fill = 0.0 if c.rmsnorm_style == "gemma" else 1.0
        return torch.full((c.d_model,), fill, dtype=dtype, device=device)

    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    layers = []
    for _ in range(c.n_layers):
        layer = {
            "attn_norm": norm(),
            "wq": dense(c.d_model, h * hd),
            "wk": dense(c.d_model, kv * hd),
            "wv": dense(c.d_model, kv * hd),
            "wo": dense(h * hd, c.d_model),
            "ffn_norm": norm(),
            "w_gate": dense(c.d_model, c.ffn_hidden),
            "w_up": dense(c.d_model, c.ffn_hidden),
            "w_down": dense(c.ffn_hidden, c.d_model),
        }
        if c.use_post_norms:
            layer["post_attn_norm"] = norm()
            layer["post_ffn_norm"] = norm()
        layers.append(layer)

    embed = normal(c.vocab_size, c.d_model, scale=0.02)
    params: Params = {
        "embed": quantize(embed, contract_axis=-1) if int8 else embed,
        "layers": layers,
        "final_norm": norm(),
    }
    if not c.tie_lm_head:
        head = normal(c.vocab_size, c.d_model, scale=c.d_model ** -0.5)
        params["lm_head"] = quantize(head, contract_axis=-1) if int8 else head
    return params


def params_dtype(params: Params) -> torch.dtype:
    if is_tp(params):
        params = params.ranks[0]
    embed = params["embed"]
    return embed.compute_dtype if isinstance(embed, QTensor) else embed.dtype


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, style: str) -> torch.Tensor:
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    w32 = weight.to(torch.float32)
    scale = (1.0 + w32) if style == "gemma" else w32
    return (normed * scale).to(x.dtype)


def _rope_angles(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[Tuple[float, float, float, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exponent)
    if scaling is not None:
        # Llama-3.1 "llama3" rope scaling: long wavelengths are divided by
        # ``factor``, short ones kept, the mid band interpolated.
        factor, low_freq_factor, high_freq_factor, original_max = scaling
        wavelen = 2.0 * math.pi / freq
        low_freq_wavelen = original_max / low_freq_factor
        high_freq_wavelen = original_max / high_freq_factor
        smooth = (original_max / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        interp = (1.0 - smooth) * freq / factor + smooth * freq
        freq = torch.where(
            wavelen > low_freq_wavelen,
            freq / factor,
            torch.where(wavelen < high_freq_wavelen, freq, interp),
        )
    angles = positions[..., None].to(torch.float32) * freq  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of (B, S, H, hd) by (B, S, 1, half) angles."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    scaling: Optional[Tuple[float, float, float, int]] = None,
) -> torch.Tensor:
    """Rotate (B, S, H, hd) by per-token positions (B, S). Half-split layout."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta, scaling)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, T, KV, hd)
    v: torch.Tensor  # (L, B, T, KV, hd)
    key_positions: torch.Tensor  # (B, T) int32
    key_valid: torch.Tensor  # (B, T) bool


def make_cache(
    config: ModelConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype,
    device: torch.device | str,
    params: Optional[Params] = None,
) -> KVCache:
    """An empty cache; for a tensor-parallel ``params`` its k/v are
    :class:`Ranked` (each rank's kv heads on its card) and the positions
    and validity stay on ``device``, the lead."""
    c = config
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
    return KVCache(
        k=kv_zeros(params, shape, dtype, device),
        v=kv_zeros(params, shape, dtype, device),
        key_positions=torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        key_valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _attention_masks(
    config: ModelConfig,
    q_positions: torch.Tensor,  # (B, S)
    q_valid: torch.Tensor,  # (B, S)
    k_positions: torch.Tensor,  # (B, T)
    k_valid: torch.Tensor,  # (B, T)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global_mask, local_mask), each (B, 1, S, T) boolean."""
    qp = q_positions[:, :, None]
    kp = k_positions[:, None, :]
    causal = (kp <= qp) & k_valid[:, None, :] & q_valid[:, :, None]
    global_mask = causal[:, None, :, :]
    if config.sliding_window is not None:
        local_mask = (causal & (qp - kp < config.sliding_window))[:, None, :, :]
    else:
        local_mask = global_mask
    return global_mask, local_mask


def forward(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor,  # (B, S) int RoPE positions
    valid: torch.Tensor,  # (B, S) bool -- real (non-pad) tokens
    cache: Optional[KVCache] = None,
    write_index: int = 0,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the transformer -> (logits (B, S, V) float32, cache).

    Without a cache, attention runs over this call's own keys.  With a
    cache, this call's k/v are written into it at ``write_index`` (the same
    slot for every row -- callers left-pad prompts) and attention runs over
    the whole cache buffer.  ``return_hidden=True`` returns the final-norm
    hidden states (B, S, D) instead of logits.  Tensor-parallel ``params``
    (:class:`~consensus_tpu_torch.parallel.tensor.TPParams`) run each rank's
    heads on its card; the results lie on the lead card."""
    c = config
    batch, span = tokens.shape
    hd = c.head_dim

    x = _embed(params, c, tokens)

    if cache is None:
        k_positions, k_valid = positions, valid
    else:
        cache.key_positions[:, write_index : write_index + span] = positions
        cache.key_valid[:, write_index : write_index + span] = valid
        k_positions, k_valid = cache.key_positions, cache.key_valid

    use_flash = c.use_flash_attention and cache is None
    if use_flash:
        # One contiguous valid span per row, as the kernel's masking model
        # needs: start = first valid column, length = valid count.
        lengths = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
        starts = valid.to(torch.int32).argmax(dim=1).to(torch.int32)
    else:
        global_mask, local_mask = _attention_masks(c, positions, valid, k_positions, k_valid)

    cos, sin = _rope_angles(positions, hd, c.rope_theta, c.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    def attend(layer, lp, attn_in, r):
        h, kv = r.config.n_heads, r.config.n_kv_heads
        reps = h // kv
        is_local = c.layer_is_local(layer)
        q = matmul(attn_in, lp["wq"]).reshape(batch, span, h, hd)
        k = matmul(attn_in, lp["wk"]).reshape(batch, span, kv, hd)
        v = matmul(attn_in, lp["wv"]).reshape(batch, span, kv, hd)
        q = _rotate(q, r(cos), r(sin))
        k = _rotate(k, r(cos), r(sin))

        if cache is None:
            keys, values = k, v
        else:
            cache_k, cache_v = r(cache.k), r(cache.v)
            cache_k[layer, :, write_index : write_index + span] = k
            cache_v[layer, :, write_index : write_index + span] = v
            keys, values = cache_k[layer], cache_v[layer]

        if use_flash:
            window = c.sliding_window if is_local else None
            attn = flash_attention(
                q, keys, values, r(lengths), r(starts),
                scale=c.q_scale, softcap=c.attn_softcap, window=window, causal=True,
            ).to(attn_in.dtype)
        else:
            qg = q.reshape(batch, span, kv, reps, hd)
            logits = torch.einsum("bsgrd,btgd->bgrst", qg, keys).to(torch.float32)
            logits = _softcap(logits * c.q_scale, c.attn_softcap)
            mask = r(local_mask if is_local else global_mask)
            logits = logits.masked_fill(~mask[:, :, None], MASK_FILL)
            weights = torch.softmax(logits, dim=-1).to(attn_in.dtype)
            attn = torch.einsum("bgrst,btgd->bsgrd", weights, values)
        return attn.reshape(batch, span, h * hd)

    x = _run_layers(params, c, x, attend)
    if return_hidden:
        return lead_part(x), cache
    return project_logits(params, c, x), cache


def _run_layers(params, c: ModelConfig, x, attend):
    """The layer loop every forward shares: ``attend(layer, lp, attn_in,
    view)`` is the caller's attention half for one layer on one rank (its
    output (..., H_local * hd)); the projection, FFN and residuals follow.
    A rank whose column range cuts a query head keeps its own columns of
    that output (``view.columns``) for its slice of ``wo`` rows.  Returns
    the final-norm hidden states: a tensor, or for a tensor-parallel model
    a list with every rank's identical copy."""
    if not is_tp(params):
        (view,) = rank_views(params, c)
        for layer, lp in enumerate(params["layers"]):
            attn_in = rms_norm(x, lp["attn_norm"], c.rms_eps, c.rmsnorm_style)
            x = _finish_layer(c, lp, x, attend(layer, lp, attn_in, view))
        return rms_norm(x, params["final_norm"], c.rms_eps, c.rmsnorm_style)
    views = rank_views(params, c)
    for layer in range(c.n_layers):
        lps = [view.tree["layers"][layer] for view in views]
        attns = [
            attend(layer, lp, rms_norm(xt, lp["attn_norm"], c.rms_eps, c.rmsnorm_style), view)
            for view, lp, xt in zip(views, lps, x)
        ]
        attns = [a if view.columns is None else a[..., view.columns]
                 for view, a in zip(views, attns)]
        x = _finish_layer_tp(c, lps, x, attns)
    return [rms_norm(xt, view.tree["final_norm"], c.rms_eps, c.rmsnorm_style)
            for view, xt in zip(views, x)]


def _gated(c: ModelConfig, lp, ffn_in: torch.Tensor) -> torch.Tensor:
    """The gated FFN's hidden activations, before ``w_down``."""
    gate = matmul(ffn_in, lp["w_gate"])
    if c.activation == "geglu":
        gate = F.gelu(gate, approximate="tanh")
    else:
        gate = F.silu(gate)
    return gate * matmul(ffn_in, lp["w_up"])


def _finish_layer(c: ModelConfig, lp, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Output projection + residual, then the gated FFN + residual, with
    Gemma-2's post-norms; ``attn`` is the attention output (..., H * hd)."""
    attn = matmul(attn, lp["wo"])
    if c.use_post_norms:
        attn = rms_norm(attn, lp["post_attn_norm"], c.rms_eps, c.rmsnorm_style)
    x = x + attn
    ffn_in = rms_norm(x, lp["ffn_norm"], c.rms_eps, c.rmsnorm_style)
    ffn = matmul(_gated(c, lp, ffn_in), lp["w_down"])
    if c.use_post_norms:
        ffn = rms_norm(ffn, lp["post_ffn_norm"], c.rms_eps, c.rmsnorm_style)
    return x + ffn


class _FloatResultMatmul(torch.autograd.Function):
    """``a @ w`` of half-precision (M, K) and (K, N) operands with the
    tensor cores' float32 result, unrounded (``torch.mm(..., out_dtype=)``,
    which has no derivative of its own).  The backward takes the products
    in the operands' dtype, as a plain ``a @ w`` would: the incoming
    gradient is the float32 image of a half-precision one."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        grad = grad.to(a.dtype)
        grad_a = grad @ w.t() if ctx.needs_input_grad[0] else None
        grad_w = a.t() @ grad if ctx.needs_input_grad[1] else None
        return grad_a, grad_w


def _row_parallel(a: torch.Tensor, w) -> torch.Tensor:
    """One rank's share of a row-parallel product ``a @ w`` (its slice of
    the contraction) in float32, so that the ranks' shares sum in float32
    and round to the activation dtype once, as one device's float32
    accumulator does.  On the card the half-precision product runs on the
    tensor cores with a float32 result (:class:`_FloatResultMatmul`);
    elsewhere on float32 operands."""
    q, scale = (w.q, w.scale.reshape(-1)) if isinstance(w, QTensor) else (w, None)
    if a.is_cuda and a.dtype != torch.float32:
        flat = _FloatResultMatmul.apply(a.reshape(-1, a.shape[-1]), q.to(a.dtype))
        y = flat.reshape(*a.shape[:-1], flat.shape[-1])
    else:
        y = torch.matmul(a.to(torch.float32), q.to(torch.float32))
    return y if scale is None else y * scale


def _finish_layer_tp(c: ModelConfig, lps, xs, attns):
    """:func:`_finish_layer` over tp ranks: each rank projects its heads
    through its ``wo`` rows and its FFN columns through its ``w_down`` rows
    (:func:`_row_parallel`), and the partials are summed over the ranks
    (:func:`all_reduce`) in float32, then rounded once, before Gemma-2's
    post-norms, which need the whole sum."""
    dtype = xs[0].dtype
    attn = [a.to(dtype) for a in all_reduce(
        [_row_parallel(a, lp["wo"]) for a, lp in zip(attns, lps)])]
    if c.use_post_norms:
        attn = [rms_norm(a, lp["post_attn_norm"], c.rms_eps, c.rmsnorm_style)
                for a, lp in zip(attn, lps)]
    xs = [x + a for x, a in zip(xs, attn)]
    ffn = [f.to(dtype) for f in all_reduce([
        _row_parallel(_gated(c, lp, rms_norm(x, lp["ffn_norm"], c.rms_eps, c.rmsnorm_style)),
                      lp["w_down"])
        for x, lp in zip(xs, lps)
    ])]
    if c.use_post_norms:
        ffn = [rms_norm(f, lp["post_ffn_norm"], c.rms_eps, c.rmsnorm_style)
               for f, lp in zip(ffn, lps)]
    return [x + f for x, f in zip(xs, ffn)]


def _embed(params: Params, c: ModelConfig, tokens: torch.Tensor):
    if is_tp(params):
        return _embed_tp(params, c, tokens)
    x = take_rows(params["embed"], tokens)
    if c.scale_embeddings:
        x = x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed_tp(params, c: ModelConfig, tokens: torch.Tensor):
    """Vocab-parallel lookup: each rank gathers the rows in its vocab range
    and zeros elsewhere, summed over the ranks; the ``sqrt(d_model)`` scale
    follows the sum, as unsharded.  Returns every rank's copy."""
    parts = []
    for t, (tree, device) in enumerate(zip(params.ranks, params.devices)):
        table = tree["embed"]
        n = table.shape[0]
        local = tokens.to(device).long() - t * n
        inside = (local >= 0) & (local < n)
        rows = take_rows(table, local.clamp(0, n - 1))
        parts.append(rows * inside[..., None].to(rows.dtype))
    xs = all_reduce(parts)
    if c.scale_embeddings:
        xs = [x * torch.tensor(c.d_model ** 0.5, dtype=x.dtype) for x in xs]
    return xs


def _each(fn, x):
    """``fn`` on a tensor, or on each rank's copy of a per-rank list."""
    return [fn(xt) for xt in x] if isinstance(x, list) else fn(x)


def _per_rank(params, config: ModelConfig, x):
    """(view, rank's copy of ``x``) per rank: a per-rank list as it is, a
    lead tensor copied to each rank's card."""
    views = rank_views(params, config)
    if isinstance(x, list):
        return list(zip(views, x))
    return [(view, view(x)) for view in views]


def _ranked(parts):
    """Per-rank results as one value: the tensor itself at tp=1."""
    return parts[0] if len(parts) == 1 else Ranked(parts)


def quantize_kv(arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the head (last) dim, shape-agnostic:
    (..., hd) -> (int8 same shape, float32 scale (..., 1))
    (``transformer.py:389-402`` of the JAX package).

    The one quantizer of every generated-KV surface: the per-step tail
    writes here, and whole prompt trunks through ``generate._quantize_kv``
    (an alias), so the per-(token, head) scale layout of a tail and of the
    frozen block it turns into is the same.  Rounds half to even, as
    ``jnp.round`` does."""
    a = arr.to(torch.float32)
    scale = a.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(a / torch.clamp(scale, min=1e-12))
    return q.to(torch.int8), scale


def _kv_values(block, dtype: torch.dtype) -> torch.Tensor:
    """A KV block's values in the compute dtype (int8 pairs convert)."""
    return block[0].to(dtype) if isinstance(block, tuple) else block


def _kv_scales(block, shape) -> Optional[torch.Tensor]:
    """Per-(row, token, head) scales of an int8 block as (P, R, KV, 1, T),
    against logits (p, r, g, m, t); None for a dense block."""
    if not isinstance(block, tuple):
        return None
    n_slots, n_roles, width, kv = shape
    s = block[1].reshape(n_slots, n_roles, width, kv)
    return s.permute(0, 1, 3, 2)[:, :, :, None, :]


def _block_width(block) -> int:
    return (block[0] if isinstance(block, tuple) else block).shape[2]


def forward_trunk_tail(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (Rows,) int -- one new token per (slot x role) row
    positions: torch.Tensor,  # (Rows,) int32 -- RoPE position of the new token
    trunk: KVCache,  # (L, R, W0, ...) shared read-only prefix, R = n_roles
    tail_k,  # (L, Rows, Ts, KV, hd) per-row generated keys, or (int8, scale)
    tail_v,
    tail_positions: torch.Tensor,  # (Rows, Ts) int32
    write_col: int,  # tail column of this step's token, a host int
    n_slots: int,
    n_roles: int,
    frozen_k=(),  # sequence of (L, Rows, F_i, KV, hd) blocks, or (int8, scale)
    frozen_v=(),
    frozen_positions=(),  # sequence of (Rows, F_i) int32, one per block
    use_decode_kernel: bool = True,
):
    """One-token decode step where every search slot shares ONE trunk cache
    (``transformer.py:404-694`` of the JAX package).

    The prefix lives once per role and every (slot x role) row attends it
    plus its own tail, whose columns ``<= write_col`` are visible (this
    step's token is written there first).  This step's k/v are written
    into the tail IN PLACE at ``write_col``; the JAX version returns new
    tails from donated buffers.

    ``frozen_*`` are read-only blocks of tokens the row generated in earlier
    decode segments (``generate.py``'s segmented decode), in chronological
    order: attended where they lie, never concatenated, always fully visible
    but to a sliding window.  A block, the live tail and the trunk may each
    be an (int8 values, float32 per-(token, head) scales) pair; an int8 tail
    is written quantized, one absmax round per step, so freezing a segment
    is a list append.  Keys are taken in the order [trunk, frozen..., tail].

    Attention goes through the decode kernel when ``config.use_decode_attention``
    and ``use_decode_kernel`` are both set and there is no frozen block, no
    int8 tail and no int8 trunk (``:542-548``).  That masking model needs
    each trunk row valid on ``[start_r, W0)`` with positions ``c - start_r``
    and a query position uniform across slots, which the call sites give.
    Otherwise it is the einsum path, masked by ``trunk.key_valid`` and the
    block positions.

    Returns (final-norm hidden (Rows, D), tail_k, tail_v)."""
    c = config
    hd = c.head_dim
    rows = tokens.shape[0]
    frozen_k, frozen_v = tuple(frozen_k), tuple(frozen_v)
    tail_quantized = isinstance(tail_k, tuple)
    trunk_quantized = isinstance(trunk.k, tuple)
    t_tail = _block_width(tail_k)
    w0 = _block_width(trunk.k)
    x = _embed(params, c, tokens)  # (Rows, D)
    device = tokens.device

    use_kernel = (
        c.use_decode_attention and use_decode_kernel
        and not frozen_k and not tail_quantized and not trunk_quantized
    )
    if use_kernel:
        # Trunk spans from key_valid (left-padded prefills); query positions
        # from slot 0's rows, uniform across slots.
        starts = trunk.key_valid.to(torch.int32).argmax(dim=1).to(torch.int32)
        qpos_r = positions.reshape(n_slots, n_roles)[0]
    else:
        # Per-block (P, R, width) masks, global and sliding-window, in key
        # order [trunk, frozen..., tail].
        qp = positions.reshape(n_slots, n_roles)[:, :, None]
        trunk_mask = trunk.key_valid[None].expand(n_slots, n_roles, w0)
        tail_fill = (torch.arange(t_tail, device=device) <= write_col)[None, None, :]
        tail_mask = tail_fill.expand(n_slots, n_roles, t_tail)
        widths = [_block_width(b) for b in frozen_k]
        global_masks = [trunk_mask]
        global_masks += [torch.ones((n_slots, n_roles, w), dtype=torch.bool, device=device)
                         for w in widths]
        global_masks.append(tail_mask)
        if c.sliding_window is not None:
            local_masks = [trunk_mask & (qp - trunk.key_positions[None] < c.sliding_window)]
            local_masks += [
                qp - fp.reshape(n_slots, n_roles, w) < c.sliding_window
                for fp, w in zip(frozen_positions, widths)
            ]
            tail_kp = tail_positions.reshape(n_slots, n_roles, t_tail)
            local_masks.append(tail_fill & (qp - tail_kp < c.sliding_window))
        else:
            local_masks = global_masks
        global_mask = torch.cat(global_masks, dim=-1)[:, :, None, None]
        local_mask = torch.cat(local_masks, dim=-1)[:, :, None, None]

    cos, sin = _rope_angles(positions[:, None], hd, c.rope_theta, c.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    def attend(layer, lp, attn_in, r):
        h, kv = r.config.n_heads, r.config.n_kv_heads
        is_local = c.layer_is_local(layer)
        q = _rotate(matmul(attn_in, lp["wq"]).reshape(rows, 1, h, hd), r(cos), r(sin))
        k = _rotate(matmul(attn_in, lp["wk"]).reshape(rows, 1, kv, hd), r(cos), r(sin))
        v = matmul(attn_in, lp["wv"]).reshape(rows, kv, hd)
        rank_tail_k, rank_tail_v = r(tail_k), r(tail_v)
        if tail_quantized:
            for block, new in ((rank_tail_k, k[:, 0]), (rank_tail_v, v)):
                values, scales = quantize_kv(new)
                block[0][layer, :, write_col] = values
                block[1][layer, :, write_col] = scales
        else:
            rank_tail_k[layer, :, write_col] = k[:, 0]
            rank_tail_v[layer, :, write_col] = v

        rank_trunk = r(trunk)
        if use_kernel:
            attn = decode_attention(
                q[:, 0], rank_trunk.k[layer], rank_trunk.v[layer], rank_tail_k[layer],
                rank_tail_v[layer], r(starts), r(qpos_r), write_col, n_slots, n_roles,
                scale=c.q_scale, softcap=c.attn_softcap,
                window=c.sliding_window if is_local else None,
            ).to(attn_in.dtype)
        else:
            attn = _trunk_tail_attention(
                r.config, q, attn_in.dtype, layer, rank_trunk, r(frozen_k), r(frozen_v),
                rank_tail_k, rank_tail_v, n_slots, n_roles,
                r(local_mask if is_local else global_mask),
            )
        return attn.reshape(rows, h * hd)

    x = _run_layers(params, c, x, attend)
    return lead_part(x), tail_k, tail_v


def _layer_block(block, layer: int):
    """Layer ``layer`` of a dense (L, ...) block or an (int8, scale) pair."""
    if isinstance(block, tuple):
        return block[0][layer], block[1][layer]
    return block[layer]


def _trunk_tail_attention(
    c: ModelConfig, q, dtype, layer, trunk, frozen_k, frozen_v, tail_k, tail_v,
    n_slots, n_roles, mask,
) -> torch.Tensor:
    """The einsum route of :func:`forward_trunk_tail` for one layer: logits
    over [trunk, frozen..., tail], int8 blocks dequantized through their
    per-(token, head) scales (keys: on the fp32 logits; values: folded into
    the weights), one masked softmax.  Returns (P, R, KV, reps, hd)."""
    kv, hd = c.n_kv_heads, c.head_dim
    reps = c.n_heads // kv
    qg = q.reshape(n_slots, n_roles, kv, reps, hd)
    k_trunk = _layer_block(trunk.k, layer)
    v_trunk = _layer_block(trunk.v, layer)
    w0 = _block_width(trunk.k)
    # The trunk's (R, W0, KV, 1) scales broadcast over slots.
    lt = torch.einsum("prgmd,rtgd->prgmt", qg, _kv_values(k_trunk, dtype)).to(torch.float32)
    if isinstance(k_trunk, tuple):
        lt = lt * k_trunk[1][..., 0].permute(0, 2, 1)[None, :, :, None, :]
    keys = [_layer_block(b, layer) for b in frozen_k] + [_layer_block(tail_k, layer)]
    values = [_layer_block(b, layer) for b in frozen_v] + [_layer_block(tail_v, layer)]
    widths = [_block_width(b) for b in frozen_k] + [_block_width(tail_k)]
    blocks = [lt]
    for block, width in zip(keys, widths):
        kg = _kv_values(block, dtype).reshape(n_slots, n_roles, width, kv, hd)
        lg = torch.einsum("prgmd,prtgd->prgmt", qg, kg).to(torch.float32)
        scales = _kv_scales(block, (n_slots, n_roles, width, kv))
        blocks.append(lg if scales is None else lg * scales)
    logits = _softcap(torch.cat(blocks, dim=-1) * c.q_scale, c.attn_softcap)
    logits = logits.masked_fill(~mask, MASK_FILL)
    weights = torch.softmax(logits, dim=-1).to(dtype)

    wt = weights[..., :w0]
    if isinstance(v_trunk, tuple):
        sv = v_trunk[1][..., 0].permute(0, 2, 1)[None, :, :, None, :]
        wt = (wt.to(torch.float32) * sv).to(dtype)
    attn = torch.einsum("prgmt,rtgd->prgmd", wt, _kv_values(v_trunk, dtype))
    offset = w0
    for block, width in zip(values, widths):
        w = weights[..., offset : offset + width]
        scales = _kv_scales(block, (n_slots, n_roles, width, kv))
        if scales is not None:
            w = (w.to(torch.float32) * scales).to(dtype)
        vg = _kv_values(block, dtype).reshape(n_slots, n_roles, width, kv, hd)
        attn = attn + torch.einsum("prgmt,prtgd->prgmd", w, vg)
        offset += width
    return attn


def forward_shared_trunk(
    params: Params,
    config: ModelConfig,
    suffix_tokens: torch.Tensor,  # (P, L) int -- per-path suffix token ids
    cache: KVCache,  # R-row trunk cache (one row per role), read-only
    cur_pos: torch.Tensor,  # (R,) int32 -- last written trunk position per role
    return_all_positions: bool = False,
    return_suffix_kv: bool = False,
):
    """Forward P path suffixes over ONE shared R-row trunk cache
    (``transformer.py:697-830`` of the JAX package): the trunk keeps its
    (R, T, ...) shape and broadcasts against the (P, R, ...) suffix queries
    inside the attention einsums, so the only per-path state is the suffix
    itself.  The cache is not written.  Returns the final-norm hidden states
    of the LAST suffix position, (P, R, D), or of every position, (P, R, L,
    D), with ``return_all_positions`` (the shared-context scorer).

    ``return_suffix_kv`` also returns the per-layer ROPED suffix keys and
    plain values, each (n_layers, P, R, L, KV, hd): what a per-(path x
    role) tail would hold, so a batched rollout
    (``stepper.rollout_scored_many``) seeds its decode tails from this one
    shared prefill."""
    c = config
    n_paths, span = suffix_tokens.shape
    hd = c.head_dim
    n_roles = cache.key_valid.shape[0]
    t_len = cache.k.shape[2]
    device = suffix_tokens.device

    x = _embed(params, c, suffix_tokens)  # (P, L, D)
    x = _each(lambda xt: xt[:, None].expand(n_paths, n_roles, span, xt.shape[-1]), x)

    # Suffix positions continue each role's trunk: (R, L).  Masks are
    # path-independent: every suffix position sees every valid trunk key
    # (trunk positions precede the suffix); the suffix is causal.
    positions = cur_pos[:, None] + 1 + torch.arange(span, device=device)[None, :]
    qp = positions[:, :, None]
    trunk_mask = cache.key_valid[:, None, :].expand(n_roles, span, t_len)
    suffix_causal = (
        torch.arange(span, device=device)[:, None] >= torch.arange(span, device=device)[None, :]
    )[None].expand(n_roles, span, span)
    if c.sliding_window is not None:
        trunk_local = trunk_mask & (qp - cache.key_positions[:, None, :] < c.sliding_window)
        suffix_local = suffix_causal & (qp - positions[:, None, :] < c.sliding_window)
    else:
        trunk_local, suffix_local = trunk_mask, suffix_causal
    global_mask = torch.cat([trunk_mask, suffix_causal], dim=-1)[None, :, None, None]
    local_mask = torch.cat([trunk_local, suffix_local], dim=-1)[None, :, None, None]

    cos, sin = _rope_angles(positions.repeat(n_paths, 1), hd, c.rope_theta, c.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    suffix_k = [[] for _ in range(params.tp if is_tp(params) else 1)]
    suffix_v = [[] for _ in suffix_k]

    def attend(layer, lp, attn_in, r):
        h, kv = r.config.n_heads, r.config.n_kv_heads
        reps = h // kv
        is_local = c.layer_is_local(layer)
        flat = attn_in.reshape(n_paths * n_roles, span, -1)
        q = _rotate(matmul(flat, lp["wq"]).reshape(n_paths * n_roles, span, h, hd), r(cos), r(sin))
        ks = _rotate(matmul(flat, lp["wk"]).reshape(n_paths * n_roles, span, kv, hd), r(cos), r(sin))
        vs = matmul(flat, lp["wv"]).reshape(n_paths, n_roles, span, kv, hd)
        qg = q.reshape(n_paths, n_roles, span, kv, reps, hd)
        ks = ks.reshape(n_paths, n_roles, span, kv, hd)
        if return_suffix_kv:
            suffix_k[r.index].append(ks)
            suffix_v[r.index].append(vs)

        cache_k, cache_v = r(cache.k), r(cache.v)
        logits = torch.cat(
            [
                torch.einsum("prsgmd,rtgd->prgmst", qg, cache_k[layer]).to(torch.float32),
                torch.einsum("prsgmd,prtgd->prgmst", qg, ks).to(torch.float32),
            ],
            dim=-1,
        )
        logits = _softcap(logits * c.q_scale, c.attn_softcap)
        mask = r(local_mask if is_local else global_mask)
        logits = logits.masked_fill(~mask, MASK_FILL)
        weights = torch.softmax(logits, dim=-1).to(attn_in.dtype)
        attn = torch.einsum(
            "prgmst,rtgd->prsgmd", weights[..., :t_len], cache_v[layer]
        ) + torch.einsum("prgmst,prtgd->prsgmd", weights[..., t_len:], vs)
        return attn.reshape(n_paths, n_roles, span, h * hd)

    x = lead_part(_run_layers(params, c, x, attend))
    out = x if return_all_positions else x[:, :, -1, :]
    if return_suffix_kv:
        return (out, _ranked([torch.stack(k) for k in suffix_k]),
                _ranked([torch.stack(v) for v in suffix_v]))
    return out


# ---------------------------------------------------------------------------
# Teacher-forced scoring
# ---------------------------------------------------------------------------


def project_logits(params: Params, config: ModelConfig, hidden) -> torch.Tensor:
    """Head-project hidden states (..., D) -> float32 logits (..., V), with
    the model's final softcap.  A tensor-parallel model projects each
    rank's vocab slice on its card and gathers the slices on the lead."""
    if not is_tp(params):
        head = params["embed"] if config.tie_lm_head else params["lm_head"]
        return _softcap(head_matmul(hidden, head), config.final_softcap)
    return gather_vocab([
        _softcap(head_matmul(h, _head(view.tree, config)), config.final_softcap)
        for view, h in _per_rank(params, config, hidden)
    ])


def _head(tree: Params, config: ModelConfig):
    return tree["embed"] if config.tie_lm_head else tree["lm_head"]


def _score_positions(valid: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.cumsum(valid.to(torch.int32), dim=1) - 1, min=0)


def token_logprobs(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B, S) right-padded
    valid: torch.Tensor,  # (B, S)
) -> torch.Tensor:
    """Per-position logprob of tokens[:, t] given tokens[:, :t] -> (B, S)
    float32; position 0 gets 0.0.  Materializes the full (B, S, V) logits;
    use :func:`token_logprobs_streamed` for large vocabularies."""
    logits, _ = forward(params, config, tokens, _score_positions(valid), valid)
    logprobs = torch.log_softmax(logits, dim=-1)
    gathered = torch.gather(logprobs[:, :-1, :], 2, tokens[:, 1:, None].long())[..., 0]
    return F.pad(gathered, (1, 0))


def token_logprobs_streamed(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,
    valid: torch.Tensor,
    vocab_chunk: int = 8192,
) -> torch.Tensor:
    """:func:`token_logprobs` without a (B, S, V) tensor: a streaming
    logsumexp over vocab tiles plus a direct gather of the target logits."""
    x, _ = forward(
        params, config, tokens, _score_positions(valid), valid, return_hidden=True
    )
    gathered = _streamed_target_logprobs(
        params, config, x[:, :-1, :], tokens[:, 1:], vocab_chunk
    )
    return F.pad(gathered, (1, 0))


def _streamed_target_logprobs(
    params: Params,
    config: ModelConfig,
    x: torch.Tensor,  # (B, S, D) final-norm hidden states
    targets: torch.Tensor,  # (B, S)
    vocab_chunk: int,
) -> torch.Tensor:
    c = config
    if is_tp(params):
        return _streamed_target_logprobs_tp(params, c, x, targets, vocab_chunk)
    head = _head(params, c)
    run_max, run_sum = _streamed_lse(head, x, c.final_softcap, vocab_chunk)
    lse = run_max + torch.log(run_sum)
    target_logits = _softcap(gather_target_logits(x, head, targets.long()), c.final_softcap)
    return target_logits - lse


def _streamed_lse(head, x: torch.Tensor, softcap, vocab_chunk: int):
    """Running (max, sum of exp(logit - max)) over ``head``'s rows in
    ``vocab_chunk`` tiles: no (..., V) tensor."""
    vocab = head.shape[0]
    x32 = x.to(torch.float32)
    run_max = torch.full(x.shape[:-1], -math.inf, dtype=torch.float32, device=x.device)
    run_sum = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for start in range(0, vocab, vocab_chunk):
        rows, row_scales = slice_rows(head, start, min(vocab_chunk, vocab - start))
        tile = torch.matmul(x32, rows.to(torch.float32).t())
        if row_scales is not None:
            tile = tile * row_scales[:, 0]
        tile = _softcap(tile, softcap)
        new_max = torch.maximum(run_max, tile.amax(dim=-1))
        run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
            tile - new_max[..., None]
        ).sum(dim=-1)
        run_max = new_max
    return run_max, run_sum


def _streamed_target_logprobs_tp(params, c: ModelConfig, x, targets, vocab_chunk: int):
    """The streamed route over tp ranks: each rank streams its vocab slice
    to a running (max, sum) and takes the target logit where the target is
    in its range; the lead merges them by a logsumexp, so no rank ever
    holds (B, S, V) logits."""
    lead = targets.device
    maxes, sums, picked = [], [], []
    for view, xt in _per_rank(params, c, x):
        head = _head(view.tree, c)
        n = head.shape[0]
        run_max, run_sum = _streamed_lse(head, xt, c.final_softcap, vocab_chunk)
        local = view(targets).long() - view.index * n
        inside = (local >= 0) & (local < n)
        logit = _softcap(gather_target_logits(xt, head, local.clamp(0, n - 1)), c.final_softcap)
        maxes.append(run_max.to(lead))
        sums.append(run_sum.to(lead))
        picked.append(torch.where(inside, logit, torch.zeros_like(logit)).to(lead))
    top = torch.stack(maxes).amax(dim=0)
    total = sum(s * torch.exp(m - top) for m, s in zip(maxes, sums))
    return sum(picked) - (top + torch.log(total))


# ---------------------------------------------------------------------------
# Shared-context scoring
# ---------------------------------------------------------------------------


def shared_context_token_logprobs(
    params: Params,
    config: ModelConfig,
    ctx_tokens: torch.Tensor,  # (1, C) int, RIGHT-padded shared context
    ctx_valid: torch.Tensor,  # (1, C) bool
    cont_tokens: torch.Tensor,  # (P, L) int, RIGHT-padded continuations
    cont_valid: torch.Tensor,  # (P, L) bool
    vocab_chunk: int = 8192,
) -> torch.Tensor:
    """Score P continuations of ONE shared context (``transformer.py:944-978``
    of the JAX package): (P, L) float32 where slot [p, j] = log p(cont[p, j]
    | ctx, cont[p, :j]); invalid slots are 0.  The context prefills once into
    a trunk cache and only the continuations run, with the trunk broadcast
    against every candidate (:func:`forward_shared_trunk`): O(C + P*L)
    token forwards where :func:`token_logprobs` on the concatenation needs
    O(P*(C + L)), with the same semantics up to summation order."""
    trunk, ctx_len, last_hidden = shared_context_prefill(params, config, ctx_tokens, ctx_valid)
    return shared_context_cont_logprobs(
        params, config, trunk, ctx_len, last_hidden, cont_tokens, cont_valid, vocab_chunk
    )


def shared_context_prefill(
    params: Params,
    config: ModelConfig,
    ctx_tokens: torch.Tensor,  # (1, C) int, RIGHT-padded shared context
    ctx_valid: torch.Tensor,  # (1, C) bool
) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """Prefill ONE shared context into a trunk cache -> (trunk, ctx_len (1,),
    last_hidden (1, 1, D)), so a scoring group wider than one row chunk
    prefills its context once (``transformer.py:981-1006``).  Positions come
    from a cumsum over the right-padded valid mask."""
    trunk = make_cache(
        config, 1, ctx_tokens.shape[1], params_dtype(params), ctx_tokens.device, params
    )
    hidden, trunk = forward(
        params, config, ctx_tokens, _score_positions(ctx_valid), ctx_valid, trunk, 0,
        return_hidden=True,
    )
    ctx_len = ctx_valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    last = (ctx_len - 1).long()[:, None, None].expand(-1, 1, hidden.shape[-1])
    last_hidden = torch.gather(hidden, 1, last)
    return trunk, ctx_len, last_hidden


def shared_context_cont_logprobs(
    params: Params,
    config: ModelConfig,
    trunk: KVCache,
    ctx_len: torch.Tensor,  # (1,)
    last_hidden: torch.Tensor,  # (1, 1, D)
    cont_tokens: torch.Tensor,  # (P, L) int, RIGHT-padded continuations
    cont_valid: torch.Tensor,  # (P, L) bool
    vocab_chunk: int = 8192,
) -> torch.Tensor:
    """Score P continuations against an already-prefilled shared trunk
    (``transformer.py:1009-1046``): continuation token 0 from the context's
    last hidden state, token j > 0 from the suffix forward at j - 1."""
    n_cont, span = cont_tokens.shape
    first = last_hidden[:, 0].expand(n_cont, last_hidden.shape[-1])[:, None, :]
    logprobs = _streamed_target_logprobs(params, config, first, cont_tokens[:, :1], vocab_chunk)
    if span > 1:
        hidden = forward_shared_trunk(
            params, config, cont_tokens[:, :-1], trunk, ctx_len - 1, return_all_positions=True
        )  # (P, 1, L-1, D)
        rest = _streamed_target_logprobs(
            params, config, hidden[:, 0], cont_tokens[:, 1:], vocab_chunk
        )
        logprobs = torch.cat([logprobs, rest], dim=1)
    return torch.where(cont_valid, logprobs, torch.zeros_like(logprobs))
