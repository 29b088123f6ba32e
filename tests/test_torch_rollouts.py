"""Scored rollouts (MCTS's leaf values, finite lookahead's leaf horizons):
the port against the JAX package, same weights.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  Stepper level, on ``tiny-gemma2`` (softcaps,
sliding-window layers) and ``tiny-llama3``: ``forward_shared_trunk`` with
its suffix keys and values, then ``rollout_scored``, ``rollout_scored_many``
and ``rollout_verify_many`` over a trunk session two steps in, at
temperature 0 and 1, with an EOS set that holds a token the rollout draws
(so the ``counted`` column and the post-EOS writes are exercised).
Tolerances: hidden states, keys, values and packed rows 1e-4 absolute
(float32, different summation orders); token ids exactly wherever every
draw's margin (top score minus the runner-up, after the Gumbel noise) is
over 1e-3, which the tests check on the port's teacher-forced scores.

Session level (``TorchBackend`` against ``TPUBackend`` on tiny-llama3):
``rollout_many`` against the JAX session's and against the port's own
``rollout_from`` per path; speculative against sequential rollouts; the
full-prefix fallback session's rollouts against the JAX fallback's.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.session import PrefixTokenSearchSession as JaxPrefixSession
from consensus_tpu.backends.session import SearchSpec as JaxSearchSpec
from consensus_tpu.backends.tpu import TPUBackend, TPUTokenSearchSession
from consensus_tpu.models import stepper as jstep
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.backends.session import PrefixTokenSearchSession, SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend, TorchTokenSearchSession
from consensus_tpu_torch.models import stepper as tstep
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.utils import threefry

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
SPEC_ATOL = 1e-5
MARGIN = 1e-3
MODELS = ("tiny-gemma2", "tiny-llama3")
N_ROLES, W0, MAX_STEPS, DEPTH = 3, 24, 5, 4
KEY_SEED = 5


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg = jax_config(name)
    tcfg = get_model_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@functools.lru_cache(maxsize=None)
def _trunk_sessions(name):
    """A trunk session (n_slots=1) prefilled and advanced two steps on both
    sides -> (port state, JAX state, t_filled)."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(4)
    lengths = np.array([W0, W0 - 5, W0 - 17])
    valid = np.arange(W0)[None, :] >= (W0 - lengths)[:, None]
    tokens = np.where(valid, rng.integers(0, tcfg.vocab_size, (N_ROLES, W0)), 0).astype(np.int32)
    base_key = jax.random.PRNGKey(KEY_SEED)
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
        chosen = int(np.asarray(jout.packed)[0, 0, 0])
        jout = jstep.search_step(
            jparams, jcfg, jout.state, jnp.asarray([[0], [chosen]], jnp.int32),
            jnp.asarray([step, step - 1], jnp.int32), 1, N_ROLES, base_key, temp, 3, False,
        )
        tout = tstep.search_step(
            tparams, tcfg, tout.state, [0], [chosen], step - 1, 1, N_ROLES, 1.0, 3, False
        )
    return tout.state, jout.state, 2


SUFFIXES = np.array([[7, 12], [3, 251], [101, 0]], np.int32)
SALTS = np.array([9, 10, 11], np.int32)


def _margins(name, state, t_filled, suffixes, ids, salts, temperature):
    """(P, depth) margin of every draw of the rollouts whose tokens are
    ``ids``: the port's teacher-forced scores at each decision point, plus
    the draw's Gumbel noise at temperature > 0."""
    _, _, tcfg, tparams = _models(name)
    lp = tstep.rollout_verify_logprobs(
        tparams, tcfg, state, t_filled, torch.from_numpy(suffixes), torch.from_numpy(ids)
    )[:, 0]
    if temperature > 0:
        keys = threefry.fold_in(threefry.fold_in(threefry.prng_key(KEY_SEED), 2),
                                torch.from_numpy(salts.astype(np.int64)))
        keys = threefry.fold_in(keys[:, None, :], torch.arange(ids.shape[1])[None, :])
        scores = lp / temperature + threefry.gumbel(keys, (lp.shape[-1],))
    else:
        scores = lp
    top2 = torch.topk(scores, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _assert_rows(got, expect, margins):
    """Token ids exactly (after checking every draw's margin), the other
    columns within ATOL."""
    got, expect = np.asarray(got), np.asarray(expect)
    assert margins.min() > MARGIN, f"near-tie draw (margin {margins.min():.2e})"
    np.testing.assert_array_equal(got[..., 0], expect[..., 0])
    np.testing.assert_allclose(got[..., 1:], expect[..., 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_forward_shared_trunk_suffix_kv(name):
    """Hidden states and the roped per-layer suffix keys / plain values,
    three two-token paths over a random left-padded three-role trunk."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(7)
    starts = np.array([0, 5, 17])
    valid = np.arange(W0)[None, :] >= starts[:, None]
    key_pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    shape = (tcfg.n_layers, N_ROLES, W0, tcfg.n_kv_heads, tcfg.head_dim)
    trunk_k, trunk_v = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    cur_pos = key_pos[:, -1]
    jcache = jtf.KVCache(*(jnp.asarray(a) for a in (trunk_k, trunk_v, key_pos, valid)))
    tcache = ttf.KVCache(*(torch.from_numpy(a) for a in (trunk_k, trunk_v, key_pos, valid)))
    expect = jtf.forward_shared_trunk(
        jparams, jcfg, jnp.asarray(SUFFIXES), jcache, jnp.asarray(cur_pos), return_suffix_kv=True
    )
    got = ttf.forward_shared_trunk(
        tparams, tcfg, torch.from_numpy(SUFFIXES), tcache, torch.from_numpy(cur_pos),
        return_suffix_kv=True,
    )
    assert got[1].shape == (tcfg.n_layers, 3, N_ROLES, 2, tcfg.n_kv_heads, tcfg.head_dim)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=ATOL, rtol=0)


def _eos_from_first_draw(rows):
    """An EOS set that ends a path at its second draw: the pad-free id 2
    plus the token the reference drew there."""
    return (2, int(np.asarray(rows)[..., 1, 0].reshape(-1)[0]))


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["argmax", "sampled"])
@pytest.mark.parametrize("name", MODELS)
def test_rollout_scored(name, temperature):
    jcfg, jparams, tcfg, tparams = _models(name)
    tstate, jstate, t_filled = _trunk_sessions(name)
    suffix, salt = SUFFIXES[0], int(SALTS[0])

    def reference(eos_ids):
        return np.asarray(jstep.rollout_scored(
            jparams, jcfg, jstate, jnp.asarray(t_filled, jnp.int32), jnp.asarray(suffix),
            jnp.asarray(salt, jnp.int32), N_ROLES, len(suffix), DEPTH,
            jax.random.PRNGKey(KEY_SEED), jnp.asarray(temperature, jnp.float32),
            jnp.asarray(eos_ids, jnp.int32),
        ))

    eos_ids = _eos_from_first_draw(reference((2,)))
    expect = reference(eos_ids)
    assert expect[:, 1].tolist() == [1.0] + [0.0] * (DEPTH - 1)
    got = tstep.rollout_scored(
        tparams, tcfg, tstate, t_filled, torch.from_numpy(suffix), N_ROLES, DEPTH, temperature,
        eos_ids, threefry.prng_key(KEY_SEED), salt,
    )
    # A single rollout writes the tokens after its EOS invalid, so the
    # teacher-forced scores hold up to the EOS draw: ids are compared there.
    upto = 2
    margins = _margins(name, tstate, t_filled, suffix[None], expect[None, :upto, 0].astype(np.int32),
                       SALTS[:1], temperature)
    _assert_rows(got[:upto], expect[:upto], margins[0])
    np.testing.assert_allclose(got.numpy()[:, 1:], expect[:, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["argmax", "sampled"])
@pytest.mark.parametrize("name", MODELS)
def test_rollout_scored_many(name, temperature):
    """Three paths in one call; the first path's stream ends at its second
    draw, and the port's singleton rollouts give each path's rows."""
    jcfg, jparams, tcfg, tparams = _models(name)
    tstate, jstate, t_filled = _trunk_sessions(name)

    def reference(eos_ids):
        return np.asarray(jstep.rollout_scored_many(
            jparams, jcfg, jstate, jnp.asarray(t_filled, jnp.int32), jnp.asarray(SUFFIXES),
            jnp.asarray(SALTS), N_ROLES, SUFFIXES.shape[1], DEPTH,
            jax.random.PRNGKey(KEY_SEED), jnp.asarray(temperature, jnp.float32),
            jnp.asarray(eos_ids, jnp.int32),
        ))

    eos_ids = _eos_from_first_draw(reference((2,)))
    expect = reference(eos_ids)
    assert expect[0, :, 1].tolist() == [1.0] + [0.0] * (DEPTH - 1)
    got = tstep.rollout_scored_many(
        tparams, tcfg, tstate, t_filled, torch.from_numpy(SUFFIXES),
        torch.from_numpy(SALTS.astype(np.int64)), N_ROLES, DEPTH, temperature, eos_ids,
        threefry.prng_key(KEY_SEED),
    )
    ids = expect[..., 0].astype(np.int32)
    _assert_rows(got, expect, _margins(name, tstate, t_filled, SUFFIXES, ids, SALTS, temperature))
    for p in range(len(SUFFIXES)):
        single = tstep.rollout_scored(
            tparams, tcfg, tstate, t_filled, torch.from_numpy(SUFFIXES[p]), N_ROLES, DEPTH,
            temperature, eos_ids, threefry.prng_key(KEY_SEED), int(SALTS[p]),
        )
        counted = expect[p, :, 1] > 0.5
        np.testing.assert_array_equal(single.numpy()[counted, 0], ids[p, counted])
        np.testing.assert_allclose(single.numpy()[:, 1:], got.numpy()[p, :, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["argmax", "sampled"])
@pytest.mark.parametrize("name", MODELS)
def test_rollout_verify_many(name, temperature):
    """Drafts: path 0 the sequential rollout's own tokens (every row
    accepted), path 1 those tokens with the third one changed, path 2
    random."""
    jcfg, jparams, tcfg, tparams = _models(name)
    tstate, jstate, t_filled = _trunk_sessions(name)
    temp = jnp.asarray(temperature, jnp.float32)
    sequential = np.asarray(jstep.rollout_scored_many(
        jparams, jcfg, jstate, jnp.asarray(t_filled, jnp.int32), jnp.asarray(SUFFIXES),
        jnp.asarray(SALTS), N_ROLES, SUFFIXES.shape[1], DEPTH,
        jax.random.PRNGKey(KEY_SEED), temp, jnp.asarray((2,), jnp.int32),
    ))
    drafts = np.random.default_rng(3).integers(3, tcfg.vocab_size, (3, DEPTH)).astype(np.int32)
    drafts[0] = sequential[0, :, 0]
    drafts[1] = sequential[1, :, 0]
    drafts[1, 2] = (drafts[1, 2] + 1) % tcfg.vocab_size
    expect = np.asarray(jstep.rollout_verify_many(
        jparams, jcfg, jstate, jnp.asarray(t_filled, jnp.int32), jnp.asarray(SUFFIXES),
        jnp.asarray(drafts), jnp.asarray(SALTS), N_ROLES, SUFFIXES.shape[1], DEPTH,
        jax.random.PRNGKey(KEY_SEED), temp, jnp.asarray((2,), jnp.int32),
    ))
    np.testing.assert_array_equal(expect[0, :, 0], sequential[0, :, 0])
    got = tstep.rollout_verify_many(
        tparams, tcfg, tstate, t_filled, torch.from_numpy(SUFFIXES), torch.from_numpy(drafts),
        torch.from_numpy(SALTS.astype(np.int64)), N_ROLES, temperature, (2,),
        threefry.prng_key(KEY_SEED),
    )
    # The decision at column t is conditioned on draft[:t], so the margins
    # are those of the drafts teacher-forced.
    margins = _margins(name, tstate, t_filled, SUFFIXES, drafts, SALTS, temperature)
    _assert_rows(got, expect, margins)


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

MODEL = "tiny-llama3"
OPTIONS = dict(
    model=MODEL, dtype="float32", use_flash_attention=True, use_decode_attention=True,
    max_context=256, max_batch_rows=32, shared_context_scoring=False,
    shared_trunk_generation=False, segmented_decode=False, kv_quant=False,
)
SPEC = dict(
    ref_system="You draft consensus statements.",
    ref_user="Issue: taxes.\nOpinions: A wants more, B wants less.\nStatement:",
    agent_prompts=(
        ("Agent context.", "Opinion: A wants more.\nStatement:"),
        ("Agent context.", "Opinion: B wants less.\nStatement:"),
    ),
    n_slots=1, k=3, temperature=1.0, seed=11, sample=False, max_steps=8,
)
WAVE_SALTS = [21, 22, 23, 24, 25, 26, 27, 28]


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(**OPTIONS, params=params, device="cpu")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


def _wave(root, advanced):
    """Eight paths of spans 1-3, as an MCTS wave selects them."""
    a, b, c = root
    d, e, _ = advanced
    return [[a], [b], [a, d], [c], [b, e], [a, d, e], [c, a], [a, e]]


def _open_both(backends, **spec):
    ref, port = backends
    jax_session = TPUTokenSearchSession(ref, JaxSearchSpec(**dict(SPEC, **spec)))
    session = TorchTokenSearchSession(port, SearchSpec(**dict(SPEC, **spec)))
    jroot, root = jax_session.propose()[0], session.propose()[0]
    assert [c.token_id for c in root] == [c.token_id for c in jroot]
    # One trunk advance, so the rollouts read a tail column too.
    jnext = jax_session.advance_and_propose([0], [jroot[0]])[0]
    nxt = session.advance_and_propose([0], [root[0]])[0]
    assert [c.token_id for c in nxt] == [c.token_id for c in jnext]
    return (jax_session, _wave(jroot, jnext)), (session, _wave(root, nxt))


def _assert_results(got, expect, atol=ATOL):
    assert len(got) == len(expect)
    for i, (g, e) in enumerate(zip(got, expect)):
        assert g[0] == e[0], f"path {i}: token ids differ"
        assert g[1] == e[1] and g[3] == e[3]
        np.testing.assert_allclose(g[2], e[2], atol=atol, rtol=0)


@pytest.mark.parametrize("speculative", [False, True], ids=["sequential", "speculative"])
def test_session_rollout_many_matches_jax(backends, speculative):
    """A wave of 8 paths of mixed spans: ids and text equal, agent totals
    within 1e-4, the same dispatches and token accounting."""
    ref, port = backends
    (jax_session, jwave), (session, wave) = _open_both(backends, speculative=speculative)
    counts = (dict(ref.token_counts), dict(port.token_counts))
    try:
        expect = jax_session.rollout_many(jwave, 5, WAVE_SALTS)
        got = session.rollout_many(wave, 5, WAVE_SALTS)
        _assert_results(got, expect)
        assert session.dispatch_count == jax_session.dispatch_count
        assert {k: port.token_counts[k] - counts[1][k] for k in counts[1]} == {
            k: ref.token_counts[k] - counts[0][k] for k in counts[0]
        }
    finally:
        jax_session.close()
        session.close()
    if speculative:
        assert 0 <= session.draft_tokens["verified"] <= session.draft_tokens["proposed"]
        assert session.draft_tokens["proposed"] > 0
        assert session.draft_tokens["verify_dispatches"] > 0


def test_rollout_many_matches_rollout_from_per_path(backends):
    """The port's batched rollouts (spans grouped, paths bucketed) give
    each path what ``rollout_from`` gives it alone."""
    _, (session, wave) = _open_both(backends)
    try:
        batched = session.rollout_many(wave, 5, WAVE_SALTS)
        dispatches = session.dispatch_count
        singles = [session.rollout_from(path, 5, salt) for path, salt in zip(wave, WAVE_SALTS)]
        # Spans 1, 2 and 3: one call each.
        assert dispatches == 2 + 3
    finally:
        session.close()
    _assert_results(batched, singles)


def test_speculative_matches_sequential(backends):
    """Speculative rollouts replay the sequential ones: ids equal, totals
    within 1e-5; a repeated call (the proposer has grown) drafts the same
    ids; the proposer saw the prompt and the trunk advance."""
    _, port = backends
    spec = TorchTokenSearchSession(port, SearchSpec(**dict(SPEC, speculative=True)))
    plain = TorchTokenSearchSession(port, SearchSpec(**SPEC))
    try:
        root = plain.propose()[0]
        assert [c.token_id for c in spec.propose()[0]] == [c.token_id for c in root]
        nxt = plain.advance_and_propose([0], [root[0]])[0]
        spec.advance_and_propose([0], [root[0]])
        assert spec._trunk_ids[-1] == root[0].token_id
        wave = _wave(root, nxt)
        want = plain.rollout_many(wave, 6, WAVE_SALTS)
        got = spec.rollout_many(wave, 6, WAVE_SALTS)
        again = spec.rollout_many(wave, 6, WAVE_SALTS)
    finally:
        spec.close()
        plain.close()
    _assert_results(got, want, atol=SPEC_ATOL)
    assert [r[0] for r in again] == [r[0] for r in got]
    # Each verify round accepts at least one token of every active path.
    assert spec.draft_tokens["verify_dispatches"] <= 2 * 3 * 6


@contextlib.contextmanager
def _forced_budget(*backends):
    caps = [b._session_budget.cap for b in backends]
    for b in backends:
        b._session_budget.cap = 1024
    try:
        yield
    finally:
        for b, cap in zip(backends, caps):
            b._session_budget.cap = cap


@pytest.mark.parametrize("matrix_scoring", [True, False], ids=["matrix", "per-call"])
def test_fallback_rollouts_match_jax_fallback(backends, matrix_scoring):
    """The full-prefix fallback: one generate call over the paths (family-2
    seeds) and one score call; ids and text equal, totals within 1e-4, the
    same dispatches.  ``speculative`` is accepted and ignored."""
    ref, port = backends
    spec = dict(SPEC, matrix_scoring=matrix_scoring, speculative=True)
    with _forced_budget(ref, port):
        jax_session = JaxPrefixSession(ref, JaxSearchSpec(**spec))
        session = PrefixTokenSearchSession(port, SearchSpec(**spec))
        jroot, root = jax_session.propose()[0], session.propose()[0]
        assert [c.token_id for c in root] == [c.token_id for c in jroot]
        paths = [[root[0]], [root[1], root[2]], [root[2]]]
        jpaths = [[jroot[0]], [jroot[1], jroot[2]], [jroot[2]]]
        expect = jax_session.rollout_many(jpaths, 4, [5, 6, 7])
        got = session.rollout_many(paths, 4, [5, 6, 7])
        single = session.rollout_from(paths[1], 4, 6)
    _assert_results(got, expect)
    assert all(r[3] for r in got) and any(r[0] for r in got)
    _assert_results([single], [got[1]])
    assert session.dispatch_count == jax_session.dispatch_count + 2
