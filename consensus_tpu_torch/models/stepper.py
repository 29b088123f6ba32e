"""Incremental token-search stepper: shared trunk + per-(slot x role) tails
(PyTorch port of ``consensus_tpu/models/stepper.py:69-646``).

The token-level decoders (beam search, finite lookahead, MCTS) need, at every
emitted token, (a) k proposed next tokens from the reference policy and (b)
every proposal's logprob under every agent-conditioned policy.  Each search
step here is one forward of one position for every row:

  - The PREFIX KV cache (prompt + issue + opinions) lives ONCE per role
    (role 0 = reference policy, roles 1..A = agent policies: same weights,
    different prompt) and every search slot attends it
    (``transformer.forward_trunk_tail``, the decode kernel K2 on the card).
  - Only the <= max_steps-column TAIL of generated tokens is per-(slot x
    role) state; beam reorders gather tails, never the prefix.

  step(parents, token):
    1. gather the TAIL rows of surviving parent beams,
    2. append the chosen token id to every role-row of its beam,
    3. forward ONE position for all rows over [shared trunk | own tail],
    4. ref rows:   (Gumbel-)top-k over biased logits -> k proposals/beam,
    5. agent rows: log-softmax gathered at those k proposal ids.

Gumbel noise per (family, step, slot) comes from the reference's key
scheme (``stepper.py:112-118``): ``fold_in(fold_in(base_key, family),
step)``, then ``fold_in(., slot)`` and ``gumbel`` (``utils/threefry.py``,
bit for bit ``jax.random``); or from an explicit ``noise`` tensor.  The JAX functions are
jitted and donate the tails; here ``search_step`` updates the tails of the
state it is given in place and ``search_prefill`` / ``suffix_propose`` run
eagerly.

The scored rollouts of MCTS and finite lookahead's leaves follow
(``rollout_scored``, ``rollout_scored_many`` and the speculative
``rollout_verify_many``), then the paged programs of the fused (candidates
x agents) score matrix (``stepper.py:647-832, 1228-1350``): a page pool
with a write sink, chunked prefill of shared context pages, and a
teacher-forced scoring pass reduced on the device; and the decode
engine's paged programs (``stepper.py:835-1006, 1353-1391``): one decode
step, the K-step window ``paged_decode_steps`` with per-row freezing into
the sink page, the speculative window ``paged_verify_steps`` (K draft
columns teacher-forced in one forward, K+1 decisions on the sequential key
schedule), and the read-only gather step over shared prefix pages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.generate import left_pad_positions
from consensus_tpu_torch.models.quant import matmul
from consensus_tpu_torch.models.sampling import gumbel_noise, sample_tokens
from consensus_tpu_torch.models.transformer import (
    KVCache,
    _embed,
    _finish_layer,
    _rope_angles,
    _rotate,
    forward,
    forward_shared_trunk,
    forward_trunk_tail,
    make_cache,
    params_dtype,
    project_logits,
    rms_norm,
)
from consensus_tpu_torch.ops.decode_attention import paged_attention
from consensus_tpu_torch.ops.welfare import DEFAULT_REWARD, WELFARE_RULES, sanitize_utilities
from consensus_tpu_torch.utils import threefry


class SearchState(NamedTuple):
    """Device-resident search state: one shared trunk, per-row tails."""

    trunk: KVCache  # (L, n_roles, W0, KV, hd) -- read-only after prefill
    tail_k: torch.Tensor  # (L, n_slots * n_roles, Ts, KV, hd)
    tail_v: torch.Tensor
    tail_positions: torch.Tensor  # (n_slots * n_roles, Ts) int32
    cur_pos: torch.Tensor  # (n_slots * n_roles,) int32 -- last written position


class StepOutput(NamedTuple):
    packed: torch.Tensor  # (B, k, 2 + A) f32: [id, ref_logprob, agent_logprobs...]
    state: SearchState


def _propose_and_score(
    params,
    config: ModelConfig,
    hidden_last: torch.Tensor,  # (Rows, D) final-norm hidden of the last position
    n_beams: int,
    n_roles: int,
    temperature: float,
    k: int,
    sample: bool,
    ref_bias: Optional[torch.Tensor] = None,  # (V,) additive bias for ref rows only
    base_key: Optional[torch.Tensor] = None,  # (2,) session key
    step_index: int = 0,
    key_family: int = 0,  # trunk steps 0, suffix trees 1, rollouts 2
    noise: Optional[torch.Tensor] = None,  # (B, V) Gumbel noise
    slot_offset: int = 0,  # global index of slot 0 (a dp shard's first slot)
) -> torch.Tensor:
    """Top-k proposals of the reference rows, scored under every agent row,
    packed into one (B, k, 2 + A) float32 tensor so the host needs a single
    fetch per step (ids are exact in f32 up to 2^24)."""
    logits = project_logits(params, config, hidden_last)  # (Rows, V) f32
    per_beam = logits.reshape(n_beams, n_roles, -1)
    ref_logits = per_beam[:, 0, :]
    if ref_bias is not None:
        ref_logits = ref_logits + ref_bias[None, :]
    ref_lp = torch.log_softmax(ref_logits, dim=-1)

    # Gumbel-top-k at temperature == sampling k distinct tokens without
    # replacement; sample=False is deterministic top-k.
    scores = ref_lp / max(float(temperature), 1e-6)
    if sample:
        if noise is None:
            if base_key is None:
                raise ValueError("sample=True needs a base key or noise")
            step_key = threefry.fold_in(threefry.fold_in(base_key, key_family), step_index)
            slots = torch.arange(
                slot_offset, slot_offset + n_beams, dtype=torch.int64, device=base_key.device
            )
            noise = gumbel_noise(threefry.fold_in(step_key, slots), ref_lp.shape[-1])
        scores = scores + noise
    ids = torch.topk(scores, k, dim=-1).indices  # (B, k)
    ref_picked = torch.gather(ref_lp, 1, ids)

    agent_lp = torch.log_softmax(per_beam[:, 1:, :], dim=-1)  # (B, A, V)
    agent_picked = torch.gather(
        agent_lp, 2, ids[:, None, :].expand(n_beams, n_roles - 1, k)
    )
    return torch.cat(
        [ids.to(torch.float32)[..., None], ref_picked[..., None], agent_picked.transpose(1, 2)],
        dim=-1,
    )


def _scratch_cache(state: SearchState, t_filled: int, extra: int = 0) -> Tuple[KVCache, int]:
    """Materialize [trunk | tail | ``extra`` empty columns] as one KVCache
    for the n_slots=1 (trunk-session) read paths: tree levels and rollouts.
    Tail columns >= ``t_filled`` and the extra columns are masked invalid.
    Returns the cache and the column where new writes land (W0 +
    ``t_filled``)."""
    trunk, tail_k = state.trunk, state.tail_k
    rows, t_tail = tail_k.shape[1:3]
    device = tail_k.device
    tail_valid = (torch.arange(t_tail, device=device)[None, :] < t_filled).expand(rows, t_tail)
    parts_k, parts_v = [trunk.k, tail_k], [trunk.v, state.tail_v]
    key_positions = [trunk.key_positions, state.tail_positions]
    key_valid = [trunk.key_valid, tail_valid]
    if extra:
        pad = (tail_k.shape[0], rows, extra) + tuple(tail_k.shape[3:])
        parts_k.append(torch.zeros(pad, dtype=tail_k.dtype, device=device))
        parts_v.append(torch.zeros(pad, dtype=tail_k.dtype, device=device))
        key_positions.append(torch.zeros((rows, extra), dtype=torch.int32, device=device))
        key_valid.append(torch.zeros((rows, extra), dtype=torch.bool, device=device))
    cache = KVCache(
        k=torch.cat(parts_k, dim=2),
        v=torch.cat(parts_v, dim=2),
        key_positions=torch.cat(key_positions, dim=1),
        key_valid=torch.cat(key_valid, dim=1),
    )
    return cache, trunk.k.shape[2] + t_filled


@torch.no_grad()
def search_prefill(
    params,
    config: ModelConfig,
    prefix_tokens: torch.Tensor,  # (n_roles, W0) int, LEFT-padded
    prefix_valid: torch.Tensor,  # (n_roles, W0) bool
    n_beams: int,
    n_roles: int,
    temperature: float,
    k: int,
    sample: bool,
    max_steps: int,
    ref_bias: Optional[torch.Tensor] = None,
    base_key: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    slot_offset: int = 0,
) -> StepOutput:
    """Prefill the (ref + agents) prefixes ONCE into the shared trunk,
    allocate empty per-(slot x role) tails, and return the root proposals
    (every slot starts identical)."""
    c = config
    w0 = prefix_tokens.shape[1]
    device = prefix_tokens.device
    dtype = params_dtype(params)
    positions = left_pad_positions(prefix_valid)
    trunk = make_cache(c, n_roles, w0, dtype, device)
    hidden, trunk = forward(
        params, c, prefix_tokens, positions, prefix_valid, trunk, 0, return_hidden=True
    )
    rows = n_beams * n_roles
    tail_shape = (c.n_layers, rows, max_steps, c.n_kv_heads, c.head_dim)
    state = SearchState(
        trunk=trunk,
        tail_k=torch.zeros(tail_shape, dtype=dtype, device=device),
        tail_v=torch.zeros(tail_shape, dtype=dtype, device=device),
        tail_positions=torch.zeros((rows, max_steps), dtype=torch.int32, device=device),
        cur_pos=positions[:, -1].repeat(n_beams).to(torch.int32),
    )
    hidden_last = hidden[:, -1, :].repeat(n_beams, 1)
    packed = _propose_and_score(
        params, c, hidden_last, n_beams, n_roles, temperature, k, sample, ref_bias,
        base_key, 0, noise=noise, slot_offset=slot_offset,
    )
    return StepOutput(packed, state)


@torch.no_grad()
def advance(
    params,
    config: ModelConfig,
    state: SearchState,
    parents: Sequence[int],  # (B,) parent beam of every slot
    tokens: Sequence[int],  # (B,) chosen token id of every slot
    write_col: int,
    n_beams: int,
    n_roles: int,
    use_decode_kernel: bool = True,
) -> Tuple[torch.Tensor, SearchState]:
    """Advance every beam slot from its parent by one token -> (final-norm
    hidden (Rows, D), new state).  Only the per-row TAILS are gathered on a
    beam reorder, and not at all when every slot keeps its own row: then
    ``state``'s own tails are written in place."""
    device = state.cur_pos.device
    rows = n_beams * n_roles
    parent_rows = [parents[row // n_roles] * n_roles + row % n_roles for row in range(rows)]
    tail_k, tail_v = state.tail_k, state.tail_v
    tail_positions, cur_pos = state.tail_positions, state.cur_pos
    if parent_rows != list(range(rows)):
        index = torch.tensor(parent_rows, dtype=torch.long, device=device)
        tail_k, tail_v = tail_k[:, index], tail_v[:, index]
        tail_positions, cur_pos = tail_positions[index], cur_pos[index]
    cur_pos = cur_pos + 1
    row_tokens = torch.tensor(
        [tokens[row // n_roles] for row in range(rows)], dtype=torch.int32, device=device
    )
    tail_positions[:, write_col] = cur_pos
    hidden, tail_k, tail_v = forward_trunk_tail(
        params, config, row_tokens, cur_pos, state.trunk, tail_k, tail_v,
        tail_positions, write_col, n_beams, n_roles, use_decode_kernel=use_decode_kernel,
    )
    return hidden, SearchState(state.trunk, tail_k, tail_v, tail_positions, cur_pos)


@torch.no_grad()
def search_step(
    params,
    config: ModelConfig,
    state: SearchState,
    parents: Sequence[int],
    tokens: Sequence[int],
    write_col: int,
    n_beams: int,
    n_roles: int,
    temperature: float,
    k: int,
    sample: bool,
    ref_bias: Optional[torch.Tensor] = None,
    base_key: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    slot_offset: int = 0,
) -> StepOutput:
    """Advance every beam slot from its parent by one token; propose + score
    (noise of step ``write_col + 1``).  ``state`` is consumed: its tails may
    be updated in place."""
    hidden, new_state = advance(
        params, config, state, parents, tokens, write_col, n_beams, n_roles
    )
    packed = _propose_and_score(
        params, config, hidden, n_beams, n_roles, temperature, k, sample, ref_bias,
        base_key, write_col + 1, noise=noise, slot_offset=slot_offset,
    )
    return StepOutput(packed, new_state)


@torch.no_grad()
def suffix_propose(
    params,
    config: ModelConfig,
    state: SearchState,  # n_slots=1 trunk session (NOT consumed)
    t_filled: int,  # tail columns already generated
    suffix_tokens: torch.Tensor,  # (P, L) int -- one row per frontier path
    n_roles: int,
    temperature: float,
    k: int,
    sample: bool,
    ref_bias: Optional[torch.Tensor] = None,
    base_key: Optional[torch.Tensor] = None,
    salt: int = 0,  # folds into the per-path proposal keys (family 1)
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Propose + score k next tokens for every tree path over the SHARED
    trunk+tail cache (``transformer.forward_shared_trunk``).  Returns the
    packed (P, k, 2 + A) candidates; the session state is untouched, so a
    lookahead tree costs one call per LEVEL and no per-path cache."""
    n_paths = suffix_tokens.shape[0]
    cache, _ = _scratch_cache(state, t_filled)
    hidden = forward_shared_trunk(params, config, suffix_tokens, cache, state.cur_pos)
    return _propose_and_score(
        params, config, hidden.reshape(n_paths * n_roles, -1), n_paths, n_roles,
        temperature, k, sample, ref_bias, base_key, salt, key_family=1, noise=noise,
    )


# ---------------------------------------------------------------------------
# Scored rollouts (MCTS leaf values, finite lookahead's leaf horizons)
# ---------------------------------------------------------------------------
#
# A rollout continues ``depth`` reference-policy tokens past trunk + tail +
# a tree path's suffix and scores each sampled token under every agent from
# the same logits.  Each function returns packed (…, depth, 2 + A) float32
# rows [token_id, counted, agent_logprobs...]; ``counted`` is 0 from the
# first EOS on and the agent logprobs of uncounted rows are 0.  Path p's
# token at step t is drawn from the key ``fold_in(fold_in(fold_in(base_key,
# 2), salts[p]), t)`` by ``categorical`` on ``ref_lp / max(T, 1e-6)``, or
# the argmax at T <= 0; the reference rows carry no logit bias.  The JAX
# functions scan over ``depth``; these loop in Python and keep every value
# on the device, so a call makes no host sync until its caller fetches the
# rows.  The session state is never modified.


def _rollout_keys(base_key: torch.Tensor, salts) -> torch.Tensor:
    """(P, 2) per-path rollout keys of family 2 (``salts`` (P,))."""
    return threefry.fold_in(threefry.fold_in(base_key, 2), salts)


def _rollout_choice(ref_lp: torch.Tensor, keys: torch.Tensor, temperature: float) -> torch.Tensor:
    """Token ids from reference logprobs (..., V) and keys (..., 2)."""
    if temperature <= 0.0:
        return torch.argmax(ref_lp, dim=-1)
    return threefry.categorical(keys, ref_lp / max(float(temperature), 1e-6))


def _eos_mask(token: torch.Tensor, eos: torch.Tensor) -> torch.Tensor:
    """Whether each token is one of the (E,) ids ``eos`` (none when E=0)."""
    return (token[..., None] == eos).any(dim=-1)


def _eos_tensor(eos_ids: Sequence[int], device) -> torch.Tensor:
    return torch.tensor(list(eos_ids), dtype=torch.int64, device=device)


def _rollout_row(token, counted, agent_lps) -> torch.Tensor:
    """(..., 2 + A) packed rows for one rollout step."""
    return torch.cat(
        [
            token.to(torch.float32)[..., None],
            counted.to(torch.float32)[..., None],
            torch.where(counted[..., None], agent_lps, torch.zeros_like(agent_lps)),
        ],
        dim=-1,
    )


@torch.no_grad()
def rollout_scored(
    params,
    config: ModelConfig,
    state: SearchState,  # n_slots=1 trunk session (NOT modified)
    t_filled: int,  # tail columns already generated
    suffix_tokens: torch.Tensor,  # (L,) int -- the node's path
    n_roles: int,
    depth: int,
    temperature: float,
    eos_ids: Sequence[int],
    base_key: torch.Tensor,  # (2,) session key
    salt: int,
) -> torch.Tensor:
    """One MCTS rollout valued in one call (``stepper.py:324-405``):
    prefill the suffix into a widened scratch copy of [trunk | tail], then
    decode ``depth`` tokens, every role row attending its own scratch row
    (``forward`` with a cache, the einsum route).  A token after the first
    EOS is written invalid, as the reference writes it.  Returns (depth,
    2 + A) rows."""
    suffix_len = suffix_tokens.shape[0]
    device = suffix_tokens.device
    scratch, write_index = _scratch_cache(state, t_filled, extra=suffix_len + depth)
    tokens = suffix_tokens[None, :].expand(n_roles, suffix_len)
    positions = state.cur_pos[:, None] + 1 + torch.arange(
        suffix_len, dtype=torch.int32, device=device
    )[None, :]
    hidden, scratch = forward(
        params, config, tokens, positions,
        torch.ones((n_roles, suffix_len), dtype=torch.bool, device=device),
        scratch, write_index, return_hidden=True,
    )
    hidden_last = hidden[:, -1]
    key = _rollout_keys(base_key, salt)
    eos = _eos_tensor(eos_ids, device)
    pos = positions[:, -1]
    done = torch.zeros((), dtype=torch.bool, device=device)
    rows = []
    for t in range(depth):
        lp = torch.log_softmax(project_logits(params, config, hidden_last), dim=-1)
        token = _rollout_choice(lp[0], threefry.fold_in(key, t), temperature)
        is_eos = _eos_mask(token, eos)
        counted = ~done & ~is_eos
        rows.append(_rollout_row(token, counted, lp[1:, token]))
        if t == depth - 1:
            break  # the reference's last forward feeds nothing
        pos = pos + 1
        hidden, scratch = forward(
            params, config, token.reshape(1, 1).expand(n_roles, 1).to(torch.int32),
            pos[:, None], (~done).reshape(1, 1).expand(n_roles, 1),
            scratch, write_index + suffix_len + t, return_hidden=True,
        )
        hidden_last = hidden[:, -1]
        done = done | is_eos
    return torch.stack(rows)


@torch.no_grad()
def rollout_scored_many(
    params,
    config: ModelConfig,
    state: SearchState,  # n_slots=1 trunk session (NOT modified)
    t_filled: int,
    suffix_tokens: torch.Tensor,  # (P, L) int -- one row per path
    salts: torch.Tensor,  # (P,) int -- one rollout salt per path
    n_roles: int,
    depth: int,
    temperature: float,
    eos_ids: Sequence[int],
    base_key: torch.Tensor,
) -> torch.Tensor:
    """A whole wave of rollouts in one call (``stepper.py:408-534``): the P
    equal-length suffixes prefill over the SHARED scratch trunk in one
    ``forward_shared_trunk`` pass, whose roped suffix keys and values seed
    per-(path x role) decode tails of width L + depth; the loop then runs
    ``forward_trunk_tail`` with n_slots=P, so the trunk stays one copy per
    role.  Path p's stream equals a singleton ``rollout_scored`` with the
    same salt, except that a path past its EOS keeps writing uncounted
    tokens only its own uncounted steps attend.  Returns (P, depth, 2 + A)
    rows.

    The decode takes the einsum route (``use_decode_kernel=False``), as
    the reference forces it here: the scratch trunk has invalid columns in
    its interior (the tail's unfilled ones), which the decode kernel's
    start-only trunk mask cannot express."""
    c = config
    n_paths, suffix_len = suffix_tokens.shape
    rows = n_paths * n_roles
    device = suffix_tokens.device
    scratch, _ = _scratch_cache(state, t_filled)
    hidden, suf_k, suf_v = forward_shared_trunk(
        params, c, suffix_tokens, scratch, state.cur_pos, return_suffix_kv=True
    )  # hidden (P, R, D); suf_k/v (L, P, R, suffix_len, KV, hd)
    width = suffix_len + depth
    tail_shape = (c.n_layers, rows, width, c.n_kv_heads, c.head_dim)
    tail_k = torch.zeros(tail_shape, dtype=suf_k.dtype, device=device)
    tail_v = torch.zeros(tail_shape, dtype=suf_v.dtype, device=device)
    tail_k[:, :, :suffix_len] = suf_k.reshape(tail_shape[:2] + (suffix_len,) + tail_shape[3:])
    tail_v[:, :, :suffix_len] = suf_v.reshape(tail_shape[:2] + (suffix_len,) + tail_shape[3:])
    suffix_pos = state.cur_pos[:, None] + 1 + torch.arange(
        suffix_len, dtype=torch.int32, device=device
    )[None, :]
    tail_positions = torch.zeros((rows, width), dtype=torch.int32, device=device)
    tail_positions[:, :suffix_len] = suffix_pos.repeat(n_paths, 1)
    pos = state.cur_pos.repeat(n_paths) + suffix_len  # last written, (rows,)
    keys = _rollout_keys(base_key, salts)
    eos = _eos_tensor(eos_ids, device)
    done = torch.zeros((n_paths,), dtype=torch.bool, device=device)
    hidden_last = hidden.reshape(rows, -1)
    out = []
    for t in range(depth):
        logits = project_logits(params, c, hidden_last)
        lp = torch.log_softmax(logits.reshape(n_paths, n_roles, -1), dim=-1)
        token = _rollout_choice(lp[:, 0], threefry.fold_in(keys, t), temperature)
        is_eos = _eos_mask(token, eos)
        counted = ~done & ~is_eos
        agent_lps = torch.gather(
            lp[:, 1:], 2, token[:, None, None].expand(n_paths, n_roles - 1, 1)
        )[..., 0]
        out.append(_rollout_row(token, counted, agent_lps))
        if t == depth - 1:
            break
        done = done | is_eos
        pos = pos + 1
        write_col = suffix_len + t
        tail_positions[:, write_col] = pos
        hidden_last, tail_k, tail_v = forward_trunk_tail(
            params, c, token.to(torch.int32).repeat_interleave(n_roles), pos,
            scratch, tail_k, tail_v, tail_positions, write_col, n_paths, n_roles,
            use_decode_kernel=False,
        )
    return torch.stack(out, dim=1)


@torch.no_grad()
def rollout_verify_logprobs(
    params,
    config: ModelConfig,
    state: SearchState,
    t_filled: int,
    suffix_tokens: torch.Tensor,  # (P, L)
    draft_tokens: torch.Tensor,  # (P, depth)
) -> torch.Tensor:
    """(P, R, depth, V) float32 log-softmax of every role at the ``depth``
    decision points of teacher-forced drafts: column t is conditioned on
    the suffix and ``draft[:t]``."""
    n_paths, suffix_len = suffix_tokens.shape
    depth = draft_tokens.shape[1]
    scratch, _ = _scratch_cache(state, t_filled)
    ext = torch.cat([suffix_tokens, draft_tokens.to(suffix_tokens.dtype)], dim=1)
    hidden = forward_shared_trunk(
        params, config, ext, scratch, state.cur_pos, return_all_positions=True
    )  # (P, R, L + depth, D)
    h = hidden[:, :, suffix_len - 1 : suffix_len - 1 + depth]
    logits = project_logits(params, config, h)
    return torch.log_softmax(logits, dim=-1)


@torch.no_grad()
def rollout_verify_many(
    params,
    config: ModelConfig,
    state: SearchState,  # n_slots=1 trunk session (NOT modified)
    t_filled: int,
    suffix_tokens: torch.Tensor,  # (P, L) int
    draft_tokens: torch.Tensor,  # (P, depth) int -- teacher-forced drafts
    salts: torch.Tensor,  # (P,) -- the salts rollout_scored_many takes
    n_roles: int,
    temperature: float,
    eos_ids: Sequence[int],
    base_key: torch.Tensor,
) -> torch.Tensor:
    """Speculative verification of whole rollout drafts in one parallel
    forward (``stepper.py:537-646``): [suffix ++ draft] runs once through
    ``forward_shared_trunk`` and every decision point replays
    :func:`rollout_scored_many`'s draw (same family-2 key, same
    log-softmax and categorical).  Returns (P, depth, 2 + A) rows
    [chosen_token, is_eos, agent_logprobs_of_chosen...]; row t is valid
    while ``draft[:t]`` matches the chosen tokens before it, and the
    session accepts the matched prefix plus the first correction."""
    n_paths = suffix_tokens.shape[0]
    depth = draft_tokens.shape[1]
    lp = rollout_verify_logprobs(params, config, state, t_filled, suffix_tokens, draft_tokens)
    steps = torch.arange(depth, dtype=torch.int64, device=lp.device)
    keys = threefry.fold_in(_rollout_keys(base_key, salts)[:, None, :], steps[None, :])
    token = _rollout_choice(lp[:, 0], keys, temperature)  # (P, depth)
    is_eos = _eos_mask(token, _eos_tensor(eos_ids, lp.device))
    agent_lps = torch.gather(
        lp[:, 1:], 3, token[:, None, :, None].expand(n_paths, n_roles - 1, depth, 1)
    )[..., 0]  # (P, A, depth)
    return torch.cat(
        [
            token.to(torch.float32)[..., None],
            is_eos.to(torch.float32)[..., None],
            agent_lps.transpose(1, 2),
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Paged programs (the fused score matrix)
# ---------------------------------------------------------------------------
#
# A page pool holds every row's K/V in fixed-size pages that host-side block
# tables name; a row's length enters as data (tables, lengths, write
# cursors), never as a shape.  The pool has one extra SINK page at index
# num_pages: padding rows and columns write their K/V there, nothing reads
# it, and it is the only page that ever takes duplicate writes.


class PagedSlotState(NamedTuple):
    """Device page pool, (L, num_pages + 1, page_size, KV, hd) each; the
    last page is the write sink."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor


def make_page_state(
    config: ModelConfig,
    num_pages: int,
    page_size: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> PagedSlotState:
    c = config
    shape = (c.n_layers, num_pages + 1, page_size, c.n_kv_heads, c.head_dim)
    return PagedSlotState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _paged_forward(
    params,
    c: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor,  # (B, S) int
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    lengths: torch.Tensor,  # (B,) int -- INCLUDING this call's tokens
    write_pages: torch.Tensor,  # (B, S) int -- the sink for invalid columns
    write_offsets: torch.Tensor,  # (B, S) int
) -> Tuple[torch.Tensor, PagedSlotState]:
    """Write this call's K/V into the pages the cursors name (IN PLACE), then
    attend every query through its row's block table -> (final-norm hidden
    (B, S, D), state)."""
    b, s = tokens.shape
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    pages, offsets = write_pages.long(), write_offsets.long()
    x = _embed(params, c, tokens)
    cos, sin = _rope_angles(positions, hd, c.rope_theta, c.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    for layer, lp in enumerate(params["layers"]):
        attn_in = rms_norm(x, lp["attn_norm"], c.rms_eps, c.rmsnorm_style)
        q = _rotate(matmul(attn_in, lp["wq"]).reshape(b, s, h, hd), cos, sin)
        k = _rotate(matmul(attn_in, lp["wk"]).reshape(b, s, kv, hd), cos, sin)
        v = matmul(attn_in, lp["wv"]).reshape(b, s, kv, hd)
        k_pages, v_pages = state.k_pages[layer], state.v_pages[layer]
        k_pages[pages, offsets] = k
        v_pages[pages, offsets] = v
        attn = paged_attention(
            q, k_pages, v_pages, block_tables, lengths, positions, scale=c.q_scale,
            softcap=c.attn_softcap,
            window=c.sliding_window if c.layer_is_local(layer) else None,
        )
        x = _finish_layer(c, lp, x, attn.reshape(b, s, h * hd))
    return rms_norm(x, params["final_norm"], c.rms_eps, c.rmsnorm_style), state


def _chunk_positions(chunk_valid: torch.Tensor, lengths: torch.Tensor):
    """(valid count (B,), positions (B, S)): chunk column j of row b sits at
    stream position lengths[b] - valid_count[b] + j."""
    n_valid = chunk_valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    cols = torch.arange(chunk_valid.shape[1], dtype=torch.int32, device=lengths.device)
    return n_valid, (lengths - n_valid)[:, None] + cols[None, :]


@torch.no_grad()
def paged_prefill_chunk(
    params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B, C) int -- one prompt chunk per row
    chunk_valid: torch.Tensor,  # (B, C) bool -- real tokens of this chunk
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks)
    lengths: torch.Tensor,  # (B,) int -- stream length AFTER this chunk
    write_pages: torch.Tensor,  # (B, C)
    write_offsets: torch.Tensor,  # (B, C)
) -> Tuple[torch.Tensor, PagedSlotState]:
    """Ingest one prompt chunk per row into the page pool (``stepper.py:787-832``):
    each chunk token attends what the row already holds plus the chunk's
    earlier tokens.  Returns the final-norm hidden of each row's LAST valid
    chunk position (B, D) and the state, updated in place."""
    n_valid, positions = _chunk_positions(chunk_valid, lengths)
    hidden, state = _paged_forward(
        params, config, tokens, positions, state, block_tables, lengths,
        write_pages, write_offsets,
    )
    last = torch.clamp(n_valid - 1, min=0).long()
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last], state


@torch.no_grad()
def paged_score_chunk(
    params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B, S) int -- query block per matrix row
    targets: torch.Tensor,  # (B, S) int -- stream token AFTER each query position
    score_mask: torch.Tensor,  # (B, S) bool -- continuation positions only
    chunk_valid: torch.Tensor,  # (B, S) bool -- real columns of this chunk
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks) -- shared context + private pages
    lengths: torch.Tensor,  # (B,) int -- stream length AFTER this call
    write_pages: torch.Tensor,  # (B, S) int -- private pages / sink
    write_offsets: torch.Tensor,  # (B, S) int
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], PagedSlotState]:
    """Teacher-forced scoring of one (candidates x agents) row chunk over
    shared context pages, reduced on the device (``stepper.py:1225-1311``).

    A row's query block is the tail of its agent context past the last full
    shared page (at least one token, so the hidden state at the final
    context position exists) followed by all but the last candidate token.
    Its block table names the agent's READ-ONLY shared pages, then the row's
    private pages; writes land only there or in the sink.  The logprob of
    stream token p + 1 is taken at query position p one column at a time,
    so no (B, S, V) float32 tensor exists.  Returns the per-row reductions
    ``(sum_lp, last_lp, sum_exp_lp, count)``, enough for every statistic,
    and the state."""
    b, s = tokens.shape
    _, positions = _chunk_positions(chunk_valid, lengths)
    hidden, state = _paged_forward(
        params, config, tokens, positions, state, block_tables, lengths,
        write_pages, write_offsets,
    )
    mask = score_mask & chunk_valid
    device = hidden.device
    sum_lp = torch.zeros((b,), dtype=torch.float32, device=device)
    last_lp = torch.zeros((b,), dtype=torch.float32, device=device)
    sum_exp = torch.zeros((b,), dtype=torch.float32, device=device)
    counts = torch.zeros((b,), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for col in range(s):
        logprobs = torch.log_softmax(project_logits(params, config, hidden[:, col]), dim=-1)
        t_lp = torch.gather(logprobs, 1, targets[:, col, None].long())[:, 0]
        m = mask[:, col]
        sum_lp = sum_lp + torch.where(m, t_lp, zero)
        last_lp = torch.where(m, t_lp, last_lp)
        sum_exp = sum_exp + torch.where(m, torch.exp(t_lp), zero)
        counts = counts + m.to(torch.int32)
    return (sum_lp, last_lp, sum_exp, counts), state


@torch.no_grad()
def paged_decode_step(
    params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B,) int -- one token per slot
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks)
    lengths: torch.Tensor,  # (B,) int -- stream length INCLUDING this token
    write_pages: torch.Tensor,  # (B,) int -- the sink for inactive slots
    write_offsets: torch.Tensor,  # (B,) int
) -> Tuple[torch.Tensor, PagedSlotState]:
    """One decode position for the whole slot table (``stepper.py:835-868``):
    every slot advances one position through its own block table.  Returns
    (float32 logits (B, V), state updated in place)."""
    hidden, state = _paged_forward(
        params, config, tokens[:, None], (lengths - 1)[:, None], state,
        block_tables, lengths, write_pages[:, None], write_offsets[:, None],
    )
    return project_logits(params, config, hidden[:, 0, :]), state


@torch.no_grad()
def paged_decode_steps(
    params,
    config: ModelConfig,
    logits: torch.Tensor,  # (B, V) float32 -- sampling logits carried IN
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    lengths: torch.Tensor,  # (B,) int32 -- tokens WRITTEN so far
    keys: torch.Tensor,  # (B, 2) per-row threefry keys
    done: torch.Tensor,  # (B,) bool -- frozen rows (EOS / budget spent / pads)
    budgets: torch.Tensor,  # (B,) int32 -- remaining emit budget
    hit_eos: torch.Tensor,  # (B,) bool -- row sampled EOS
    temperature: torch.Tensor,  # (B,) float32
    eos_ids: Optional[torch.Tensor] = None,  # (E,) int
    num_steps: int = 1,
    top_k: int = 0,
    top_p: float = 1.0,
    logit_bias: Optional[torch.Tensor] = None,  # (V,) or (B, V) additive
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    presence: Optional[torch.Tensor] = None,  # (B, V) bool seen-token mask
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32
    sampling: bool = True,
):
    """Decode up to ``num_steps`` tokens per slot in ONE window
    (``stepper.py:871-1004``), with no host sync inside it.

    Each step samples from the carried logits with the per-row key-split
    schedule of the sequential loops (``generate._decode_segment``: every
    row's key splits once per step, done rows included, and a row's t-th
    emitted token is drawn from its t-th split), so the tokens do not
    depend on ``num_steps``; then it advances one position through the
    paged forward.  ``sampling`` says, from the host, whether any row
    samples: a window that is greedy throughout splits no keys, as the
    sequential loops do not (their keys are then never read).

    Early exit is a MASK: a row freezes when it samples EOS or when its
    budget was already spent at step start.  Frozen rows sample pad ids,
    write K/V only to the sink page (index ``num_pages``) and stop
    advancing ``lengths``.  The one extra sample at ``budgets == 0`` is the
    eos-check step that decides ``hit_eos``, as the sequential path's
    bucketed windows sample past the budget before the host truncates.
    Page cursors advance inside the window; every page a row can reach was
    reserved when the stream was built.

    Returns ``(tokens (B, K) int32, emitted (B, K) bool, logits, state,
    lengths, keys, done, budgets, hit_eos, presence)``; the trailing tensors
    re-enter the next window unchanged, the state updated in place."""
    batch = logits.shape[0]
    device = logits.device
    page_size = state.k_pages.shape[2]
    sink = state.k_pages.shape[1] - 1
    max_blocks = block_tables.shape[1]
    if bias_table is not None:
        logit_bias = bias_table[bias_index.long()]
    use_rp = presence is not None and rep_penalty is not None
    rows = torch.arange(batch, device=device)
    pad = torch.full((batch,), pad_id, dtype=torch.int32, device=device)
    tokens_out, emitted_out = [], []
    for _ in range(num_steps):
        sub = None
        if sampling:
            pairs = threefry.split(keys)
            keys, sub = pairs[:, 0], pairs[:, 1]
        token = sample_tokens(
            logits, temperature=temperature, top_k=top_k, top_p=top_p,
            logit_bias=logit_bias, presence=presence if use_rp else None,
            rep_penalty=rep_penalty if use_rp else None, keys=sub,
            all_greedy=not sampling,
        )
        token = torch.where(done, pad, token)
        if use_rp:
            presence[rows, token.long()] = True
        if eos_ids is None or eos_ids.numel() == 0:
            token_is_eos = torch.zeros_like(done)
        else:
            token_is_eos = (token[:, None] == eos_ids[None, :]).any(dim=-1) & ~done
        emitted = ~done & ~token_is_eos & (budgets > 0)
        new_done = done | token_is_eos | (budgets <= 0)
        hit_eos = hit_eos | token_is_eos
        budgets = budgets - emitted.to(budgets.dtype)

        page_idx = torch.clamp(lengths // page_size, max=max_blocks - 1).long()
        page = torch.gather(block_tables, 1, page_idx[:, None])[:, 0]
        write_pages = torch.where(new_done | (page < 0), torch.full_like(page, sink), page)
        write_offsets = torch.where(new_done, torch.zeros_like(lengths), lengths % page_size)
        attn_lengths = torch.where(new_done, lengths, lengths + 1)
        hidden, state = _paged_forward(
            params, config, token[:, None], lengths[:, None], state, block_tables,
            attn_lengths, write_pages[:, None], write_offsets[:, None],
        )
        logits = project_logits(params, config, hidden[:, 0, :])
        lengths, done = attn_lengths, new_done
        tokens_out.append(token)
        emitted_out.append(emitted)
    return (
        torch.stack(tokens_out, dim=1), torch.stack(emitted_out, dim=1),
        logits, state, lengths, keys, done, budgets, hit_eos, presence,
    )


@torch.no_grad()
def paged_verify_steps(
    params,
    config: ModelConfig,
    logits: Optional[torch.Tensor],  # (B, V) float32 -- first-decision logits
    #                                  (prefill out); read only without pending
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    lengths: torch.Tensor,  # (B,) int32 -- tokens whose K/V is WRITTEN (the
    #                         pending token, when present, is not counted)
    keys: torch.Tensor,  # (B, 2) per-row threefry keys
    done: torch.Tensor,  # (B,) bool
    budgets: torch.Tensor,  # (B,) int32 -- remaining emit budget
    hit_eos: torch.Tensor,  # (B,) bool
    temperature: torch.Tensor,  # (B,) float32
    draft_tokens: torch.Tensor,  # (B, K) int32 -- per-row self-draft proposal
    pending: torch.Tensor,  # (B,) int32 -- last emitted token, K/V unwritten
    eos_ids: Optional[torch.Tensor] = None,  # (E,) int
    num_steps: int = 1,
    top_k: int = 0,
    top_p: float = 1.0,
    logit_bias: Optional[torch.Tensor] = None,
    bias_table: Optional[torch.Tensor] = None,
    bias_index: Optional[torch.Tensor] = None,
    pad_id: int = 0,
    presence: Optional[torch.Tensor] = None,  # (B, V) bool seen-token mask
    rep_penalty: Optional[torch.Tensor] = None,  # (B,) float32
    has_pending: bool = False,
    sampling: bool = True,
):
    """Draft-and-verify variant of :func:`paged_decode_steps`
    (``stepper.py:1015-1227``): ONE window emits ``1 + accepted`` real
    tokens instead of one per step.

    The K per-row draft tokens are teacher-forced through ONE paged forward
    (K columns, or K+1 with the pending column), then K+1 sampling
    decisions replay the sequential per-row key-split schedule: decision t
    splits the row's key and samples from the logits the sequential window
    would have carried at that step, so the accepted prefix plus the first
    correction token are the sequential decisions.  A row stops deciding
    the moment it diverges from its draft; its key has then split exactly
    once per decision made, so the next window resumes the sequential
    schedule unchanged (keys advance only on real decisions).  With
    ``sampling`` False (greedy throughout, known on the host) no key splits,
    as in :func:`paged_decode_steps`.

    Pending-token protocol: a correction (or the bonus token sampled after
    a fully accepted draft) is emitted without its K/V being written; the
    next window forwards it as column 0 (``has_pending``) and derives the
    first decision's logits from its hidden, so ``lengths`` counts exactly
    the written tokens and the ``ceil((prompt + max_tokens) / page_size)``
    page reservation holds under variable emission.

    Draft columns write their K/V optimistically (later columns attend
    earlier ones); a column goes to the SINK when its row was done at entry
    or its position falls past the block table.  Rejected-tail writes sit
    past the row's final ``lengths``, masked out of every read and
    overwritten when those positions go live.

    Returns ``(tokens (B, K+1), emitted (B, K+1), accepted (B,) int32,
    pending, state, lengths, keys, done, budgets, hit_eos, presence)``;
    ``accepted`` counts emitted draft matches (not the correction or bonus
    token), and the trailing tensors re-enter the next window with
    ``has_pending=True``."""
    batch = draft_tokens.shape[0]
    if draft_tokens.shape[1] != num_steps:
        raise ValueError("draft_tokens must carry num_steps columns")
    device = draft_tokens.device
    page_size = state.k_pages.shape[2]
    sink = state.k_pages.shape[1] - 1
    max_blocks = block_tables.shape[1]
    if bias_table is not None:
        logit_bias = bias_table[bias_index.long()]
    use_rp = presence is not None and rep_penalty is not None
    done_entry = done

    # One teacher-forced forward over the window's columns.
    cols = torch.cat([pending[:, None], draft_tokens], dim=1) if has_pending else draft_tokens
    s = cols.shape[1]
    positions = lengths[:, None] + torch.arange(s, dtype=lengths.dtype, device=device)[None, :]
    page_idx = positions // page_size
    page = torch.gather(block_tables, 1, torch.clamp(page_idx, max=max_blocks - 1).long())
    write_pages = torch.where(
        done_entry[:, None] | (page_idx >= max_blocks) | (page < 0),
        torch.full_like(page, sink), page,
    )
    write_offsets = torch.where(done_entry[:, None], torch.zeros_like(positions), positions % page_size)
    attn_lengths = torch.where(
        done_entry, lengths, torch.clamp(lengths + s, max=max_blocks * page_size)
    )
    hidden, state = _paged_forward(
        params, config, cols, positions, state, block_tables, attn_lengths,
        write_pages, write_offsets,
    )

    # Decision t (t = 0..K) samples the token at new position t.  Its
    # context is the written stream plus [pending?, d_0..d_{t-1}]: with a
    # pending column that is hidden column t, without one column t-1
    # (decision 0 then samples from the CARRIED prefill logits).
    if has_pending:
        first_logits = project_logits(params, config, hidden[:, 0, :])
        dec_hidden = hidden[:, 1:, :]
    else:
        first_logits = logits
        dec_hidden = hidden
    # d_1..d_{K-1}, then the bonus sentinel -1 that never matches.
    drafts_next = torch.cat(
        [draft_tokens, torch.full((batch, 1), -1, dtype=draft_tokens.dtype, device=device)], dim=1
    )
    rows = torch.arange(batch, device=device)
    pad = torch.full((batch,), pad_id, dtype=torch.int32, device=device)
    ok = torch.ones((batch,), dtype=torch.bool, device=device)
    accepted = torch.zeros((batch,), dtype=torch.int32, device=device)
    tokens_out, emitted_out = [], []
    for t in range(num_steps + 1):
        logits_t = first_logits if t == 0 else project_logits(params, config, dec_hidden[:, t - 1, :])
        real = ok & ~done
        sub = None
        if sampling:
            pairs = threefry.split(keys)
            keys = torch.where(real[:, None], pairs[:, 0], keys)
            sub = pairs[:, 1]
        token = sample_tokens(
            logits_t, temperature=temperature, top_k=top_k, top_p=top_p,
            logit_bias=logit_bias, presence=presence if use_rp else None,
            rep_penalty=rep_penalty if use_rp else None, keys=sub,
            all_greedy=not sampling,
        )
        token = torch.where(real, token, pad)
        if use_rp:
            idx = token.long()
            presence[rows, idx] = presence[rows, idx] | real
        if eos_ids is None or eos_ids.numel() == 0:
            token_is_eos = torch.zeros_like(done)
        else:
            token_is_eos = (token[:, None] == eos_ids[None, :]).any(dim=-1) & real
        emit = real & ~token_is_eos & (budgets > 0)
        done = done | (real & (token_is_eos | (budgets <= 0)))
        hit_eos = hit_eos | token_is_eos
        budgets = budgets - emit.to(budgets.dtype)
        # A row keeps deciding only while every emitted token matched its
        # draft; the correction / bonus token ends its window, left pending.
        ok = emit & (token == drafts_next[:, t])
        accepted = accepted + ok.to(torch.int32)
        pending = torch.where(emit, token, pending)
        tokens_out.append(token)
        emitted_out.append(emit)
    written = accepted
    if has_pending:
        # The carried pending token's K/V went live this window (rows done
        # at entry wrote the sink and stay frozen).
        written = written + (~done_entry).to(torch.int32)
    lengths = lengths + written.to(lengths.dtype)
    return (
        torch.stack(tokens_out, dim=1), torch.stack(emitted_out, dim=1), accepted,
        pending, state, lengths, keys, done, budgets, hit_eos, presence,
    )


@torch.no_grad()
def paged_gather_step(
    params,
    config: ModelConfig,
    tokens: torch.Tensor,  # (B,) int -- each slot's LAST cached token
    state: PagedSlotState,
    block_tables: torch.Tensor,  # (B, max_blocks) -- may name SHARED pages
    lengths: torch.Tensor,  # (B,) int -- cached stream length
) -> Tuple[torch.Tensor, PagedSlotState]:
    """Read-only decode step over shared prefix pages (``stepper.py:1353-1391``):
    re-forward each slot's last cached token through its block table, with
    the recomputed K/V routed to the write SINK, so pages another slot (or
    the prefix cache) owns are read in place and never mutated.  Attention
    reads the stored page for the query's own position, so the logits match
    the owner's prefill logits at that position to float tolerance.
    Returns (float32 logits (B, V), state) -- only the sink page changed."""
    b = tokens.shape[0]
    sink = torch.full((b, 1), state.k_pages.shape[1] - 1, dtype=torch.int32, device=tokens.device)
    hidden, state = _paged_forward(
        params, config, tokens[:, None], (lengths - 1)[:, None], state, block_tables,
        lengths, sink, torch.zeros_like(sink),
    )
    return project_logits(params, config, hidden[:, 0, :]), state


def utility_matrix(
    stats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    n_candidates: int,
    n_agents: int,
    stat: str = "mean",
    rule: str = "egalitarian",
    default: float = DEFAULT_REWARD,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fold flattened (C*A,) per-row reductions into the (C, A) utility
    matrix and its welfare vector on the device (``stepper.py:1314-1350``):
    rows with no scored token take ``default``, then sanitize and the
    welfare rule over the agent axis.  Returns ``(utilities, welfare,
    aux)``, ``aux`` the per-cell mean probability for ``stat="moments"``
    and None otherwise.  The caller takes the welfare argmax on the host
    (``np.argmax``), so ties go to the first maximum."""
    sum_lp, last_lp, sum_exp, counts = stats
    counts_f = torch.clamp(counts, min=1).to(torch.float32)
    if stat in ("mean", "moments"):
        value = sum_lp / counts_f
    elif stat == "sum":
        value = sum_lp
    elif stat == "last":
        value = last_lp
    else:
        raise ValueError(f"unknown stat {stat!r}")
    scored = counts > 0
    value = torch.where(scored, value, torch.full_like(value, default))
    utilities = value.reshape(n_candidates, n_agents)
    welfare_vals = WELFARE_RULES[rule](sanitize_utilities(utilities), axis=1)
    aux = None
    if stat == "moments":
        aux = torch.where(scored, sum_exp / counts_f, torch.zeros_like(sum_exp)).reshape(
            n_candidates, n_agents
        )
    return utilities, welfare_vals, aux
