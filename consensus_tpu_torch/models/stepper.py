"""Incremental token-search stepper: shared trunk + per-(slot x role) tails
(PyTorch port of ``consensus_tpu/models/stepper.py:69-317``).

The token-level decoders (beam search, finite lookahead) need, at every
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

Gumbel noise per (family, step, slot) comes from one ``torch.Generator``
per slot (the session folds the seeds), or from an explicit ``noise``
tensor so tests can hand the port JAX's numbers; the generators do not
reproduce JAX's threefry bits (ROADMAP queue A3).  The JAX functions are
jitted and donate the tails; here ``search_step`` updates the tails of the
state it is given in place and ``search_prefill`` / ``suffix_propose`` run
eagerly.  The MCTS rollouts and the paged programs wait for queue A7/A4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.generate import left_pad_positions
from consensus_tpu_torch.models.sampling import gumbel_noise
from consensus_tpu_torch.models.transformer import (
    KVCache,
    forward,
    forward_shared_trunk,
    forward_trunk_tail,
    make_cache,
    params_dtype,
    project_logits,
)


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
    generators: Optional[Sequence[torch.Generator]] = None,  # one per slot
    noise: Optional[torch.Tensor] = None,  # (B, V) Gumbel noise
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
            if generators is None:
                raise ValueError("sample=True needs one generator per slot or noise")
            noise = gumbel_noise(ref_lp.shape, generators, ref_lp.device)
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


def _scratch_cache(state: SearchState, t_filled: int) -> KVCache:
    """Materialize [trunk | tail] as one KVCache for the n_slots=1
    (trunk-session) tree levels; tail columns >= ``t_filled`` are masked
    invalid."""
    trunk, tail_k = state.trunk, state.tail_k
    rows, t_tail = tail_k.shape[1:3]
    tail_valid = (torch.arange(t_tail, device=tail_k.device)[None, :] < t_filled).expand(
        rows, t_tail
    )
    return KVCache(
        k=torch.cat([trunk.k, tail_k], dim=2),
        v=torch.cat([trunk.v, state.tail_v], dim=2),
        key_positions=torch.cat([trunk.key_positions, state.tail_positions], dim=1),
        key_valid=torch.cat([trunk.key_valid, tail_valid], dim=1),
    )


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
    generators: Optional[Sequence[torch.Generator]] = None,
    noise: Optional[torch.Tensor] = None,
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
        generators, noise,
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
    generators: Optional[Sequence[torch.Generator]] = None,
    noise: Optional[torch.Tensor] = None,
) -> StepOutput:
    """Advance every beam slot from its parent by one token; propose + score.
    ``state`` is consumed: its tails may be updated in place."""
    hidden, new_state = advance(
        params, config, state, parents, tokens, write_col, n_beams, n_roles
    )
    packed = _propose_and_score(
        params, config, hidden, n_beams, n_roles, temperature, k, sample, ref_bias,
        generators, noise,
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
    generators: Optional[Sequence[torch.Generator]] = None,  # one per path
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Propose + score k next tokens for every tree path over the SHARED
    trunk+tail cache (``transformer.forward_shared_trunk``).  Returns the
    packed (P, k, 2 + A) candidates; the session state is untouched, so a
    lookahead tree costs one call per LEVEL and no per-path cache."""
    n_paths = suffix_tokens.shape[0]
    cache = _scratch_cache(state, t_filled)
    hidden = forward_shared_trunk(params, config, suffix_tokens, cache, state.cur_pos)
    return _propose_and_score(
        params, config, hidden.reshape(n_paths * n_roles, -1), n_paths, n_roles,
        temperature, k, sample, ref_bias, generators, noise,
    )
