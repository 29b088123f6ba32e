"""The port's token-search stepper against the JAX package, same weights.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  ``forward_trunk_tail`` runs with the decode kernel on
(the JAX Pallas kernel in interpret mode against the port's plain version
on the CPU) and off (the einsum path on both sides), on ``tiny-gemma2``
(softcaps, sliding-window local layers) and ``tiny-llama3``.  The search
runs ``search_prefill`` plus three ``search_step``s with reordering parents
and then ``suffix_propose``, at ``sample=False``; one case samples, fed
JAX's own Gumbel noise.  Tolerances: hidden states, tails and logprobs 1e-4
absolute (float32, different summation orders); proposal ids exactly, on
inputs whose proposals are checked to be tie-free (every gap between
consecutive top-k scores > 1e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models import stepper as jstep
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.models import stepper as tstep
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
TIE_MARGIN = 1e-3
MODELS = ("tiny-gemma2", "tiny-llama3")
N_ROLES, W0, MAX_STEPS = 3, 24, 5


@functools.lru_cache(maxsize=None)
def _models(name, decode):
    jcfg = dataclasses.replace(jax_config(name), use_decode_attention=decode)
    tcfg = dataclasses.replace(get_model_config(name), use_decode_attention=decode)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _prefix(vocab, seed, lengths=(W0, W0 - 5, W0 - 17)):
    rng = np.random.default_rng(seed)
    valid = np.arange(W0)[None, :] >= (W0 - np.asarray(lengths))[:, None]
    tokens = np.where(valid, rng.integers(0, vocab, (len(lengths), W0)), 0).astype(np.int32)
    return tokens, valid


def _assert_tie_free(packed, temperature=1.0):
    scores = packed[..., 1] / temperature
    gaps = scores[..., :-1] - scores[..., 1:]
    assert gaps.min() > TIE_MARGIN, f"near-tie proposals (gap {gaps.min():.2e})"


def _assert_packed(got, expect):
    got, expect = got.numpy(), np.asarray(expect)
    np.testing.assert_array_equal(got[..., 0], expect[..., 0])
    np.testing.assert_allclose(got[..., 1:], expect[..., 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [True, False], ids=["decode-kernel", "einsum"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_trunk_tail(name, kernel):
    """One step over a random left-padded trunk and tails holding two
    earlier tokens; write_col 2, three slots x three roles."""
    jcfg, jparams, tcfg, tparams = _models(name, True)
    n_slots, write_col, ts = 3, 2, 6
    rows = n_slots * N_ROLES
    rng = np.random.default_rng(7)
    starts = np.array([0, 5, 17])
    valid = np.arange(W0)[None, :] >= starts[:, None]
    key_pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    shape = (tcfg.n_layers, N_ROLES, W0, tcfg.n_kv_heads, tcfg.head_dim)
    trunk_k, trunk_v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    tail_shape = (tcfg.n_layers, rows, ts, tcfg.n_kv_heads, tcfg.head_dim)
    tail_k, tail_v = (rng.standard_normal(tail_shape, dtype=np.float32) for _ in range(2))
    qpos_r = (W0 - starts - 1) + write_col + 1
    positions = np.tile(qpos_r, n_slots).astype(np.int32)
    tail_pos = (positions[:, None] - write_col + np.arange(ts)[None, :]).astype(np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, rows).astype(np.int32)

    jtrunk = jtf.KVCache(
        jnp.asarray(trunk_k), jnp.asarray(trunk_v), jnp.asarray(key_pos), jnp.asarray(valid)
    )
    jh, jk, jv = jtf.forward_trunk_tail(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jtrunk,
        jnp.asarray(tail_k), jnp.asarray(tail_v), jnp.asarray(tail_pos),
        jnp.asarray(write_col, jnp.int32), n_slots, N_ROLES, use_decode_kernel=kernel,
    )
    ttrunk = ttf.KVCache(*(torch.from_numpy(a) for a in (trunk_k, trunk_v, key_pos, valid)))
    th, tk, tv = ttf.forward_trunk_tail(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), ttrunk,
        torch.from_numpy(tail_k.copy()), torch.from_numpy(tail_v.copy()),
        torch.from_numpy(tail_pos), write_col, n_slots, N_ROLES, use_decode_kernel=kernel,
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_decode_kernel_route_matches_einsum_route():
    """Within the port: the plain decode-attention route and the einsum
    route of forward_trunk_tail agree (the CPU stand-in for chip_smoke.py's
    check of the card's kernel route against the einsum route)."""
    _, _, tcfg, tparams = _models("tiny-gemma2", True)
    tokens, valid = _prefix(tcfg.vocab_size, seed=3)
    out = tstep.search_prefill(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), 2, N_ROLES,
        1.0, 3, False, MAX_STEPS,
    )
    hidden = {}
    for kernel in (True, False):
        state = out.state._replace(tail_k=out.state.tail_k.clone(), tail_v=out.state.tail_v.clone())
        hidden[kernel], _ = tstep.advance(
            tparams, tcfg, state, [1, 0], [5, 9], 0, 2, N_ROLES, use_decode_kernel=kernel
        )
    torch.testing.assert_close(hidden[True], hidden[False], atol=ATOL, rtol=0)


def _search_both(name, kernel, n_beams=2, k=4, sample=False, seed=1):
    """search_prefill + 3 search_steps (parents reorder) on both sides;
    yields (port packed, JAX packed) per call, then the two final states."""
    jcfg, jparams, tcfg, tparams = _models(name, kernel)
    tokens, valid = _prefix(tcfg.vocab_size, seed)
    base_key = jax.random.PRNGKey(11)
    temp = jnp.asarray(1.0, jnp.float32)

    def noise(family, index, n):
        if not sample:
            return None
        step_key = jax.random.fold_in(jax.random.fold_in(base_key, family), index)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(jax.random.fold_in(step_key, slot), (tcfg.vocab_size,)))
            for slot in range(n)
        ]))

    jout = jstep.search_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), n_beams, N_ROLES,
        base_key, temp, k, sample, MAX_STEPS,
    )
    tout = tstep.search_prefill(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), n_beams, N_ROLES,
        1.0, k, sample, MAX_STEPS, noise=noise(0, 0, n_beams),
    )
    calls = [(tout.packed, jout.packed)]
    parents_by_step = ([1, 0], [0, 0], [1, 0])
    for step, parents in enumerate(parents_by_step, start=1):
        chosen = [int(tout.packed[p, 0, 0]) for p in parents]
        advance = jnp.asarray(np.stack([parents, chosen]).astype(np.int32))
        meta = jnp.asarray([step, step - 1], jnp.int32)
        jout = jstep.search_step(
            jparams, jcfg, jout.state, advance, meta, n_beams, N_ROLES, base_key, temp, k, sample,
        )
        tout = tstep.search_step(
            tparams, tcfg, tout.state, parents, chosen, step - 1, n_beams, N_ROLES,
            1.0, k, sample, noise=noise(0, step, n_beams),
        )
        calls.append((tout.packed, jout.packed))
    return calls, (tout.state, jout.state)


@pytest.mark.parametrize("kernel", [True, False], ids=["decode-kernel", "einsum"])
@pytest.mark.parametrize("name", MODELS)
def test_search_prefill_and_steps(name, kernel):
    calls, (tstate, jstate) = _search_both(name, kernel)
    for got, expect in calls:
        _assert_tie_free(got.numpy())
        _assert_packed(got, expect)
    np.testing.assert_array_equal(tstate.cur_pos.numpy(), np.asarray(jstate.cur_pos))
    np.testing.assert_array_equal(tstate.tail_positions.numpy(), np.asarray(jstate.tail_positions))
    np.testing.assert_allclose(tstate.tail_k.numpy(), np.asarray(jstate.tail_k), atol=ATOL, rtol=0)


def test_search_sampled_with_jax_noise():
    """sample=True: the port's Gumbel-top-k fed JAX's per-(family, step,
    slot) noise proposes the same ids."""
    calls, _ = _search_both("tiny-gemma2", True, sample=True, seed=2)
    for got, expect in calls:
        _assert_packed(got, expect)


@pytest.mark.parametrize("name", MODELS)
def test_suffix_propose(name):
    """A trunk session (n_slots=1) two steps in, then one tree level of
    three two-token paths over the shared trunk+tail."""
    jcfg, jparams, tcfg, tparams = _models(name, True)
    tokens, valid = _prefix(tcfg.vocab_size, seed=4)
    base_key = jax.random.PRNGKey(5)
    temp = jnp.asarray(1.0, jnp.float32)
    jout = jstep.search_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), 1, N_ROLES, base_key, temp, 3,
        False, MAX_STEPS,
    )
    tout = tstep.search_prefill(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), 1, N_ROLES, 1.0, 3,
        False, MAX_STEPS,
    )
    for step in (1, 2):
        chosen = int(tout.packed[0, 0, 0])
        jout = jstep.search_step(
            jparams, jcfg, jout.state, jnp.asarray([[0], [chosen]], jnp.int32),
            jnp.asarray([step, step - 1], jnp.int32), 1, N_ROLES, base_key, temp, 3, False,
        )
        tout = tstep.search_step(
            tparams, tcfg, tout.state, [0], [chosen], step - 1, 1, N_ROLES, 1.0, 3, False
        )
        _assert_packed(tout.packed, jout.packed)
    suffixes = np.array([[7, 12], [3, 251], [101, 0]], np.int32)
    expect = jstep.suffix_propose(
        jparams, jcfg, jout.state, jnp.asarray(2, jnp.int32), jnp.asarray(suffixes),
        jnp.asarray(9, jnp.int32), N_ROLES, base_key, temp, 3, False,
    )
    got = tstep.suffix_propose(
        tparams, tcfg, tout.state, 2, torch.from_numpy(suffixes), N_ROLES, 1.0, 3, False
    )
    _assert_tie_free(got.numpy())
    _assert_packed(got, expect)
