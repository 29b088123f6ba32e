"""The port's fused (candidates x agents) score matrix against the JAX
package, same weights.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  ``paged_attention`` runs on a random page pool with
padded block tables; ``paged_prefill_chunk`` + ``paged_score_chunk`` on one
shared context page and three private candidate rows (one of them padding
that writes the sink), and ``utility_matrix`` folds the result for every
stat and welfare rule.  ``TorchBackend.score_matrix`` is held against
``TPUBackend.score_matrix`` and against the port's own per-call fallback,
as the JAX package's ``TestFusedParity`` holds its fused path.  Tolerances:
1e-4 absolute against JAX (float32, different summation orders);
5e-5 absolute + 5e-5 relative against the fallback, the JAX test's bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.score_matrix import AgentContext as JaxAgentContext
from consensus_tpu.backends.score_matrix import ScoreMatrixRequest as JaxScoreMatrixRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import stepper as jstep
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu.ops.decode_attention import paged_attention as jax_paged_attention
from consensus_tpu_torch.backends.score_matrix import (
    AgentContext,
    ScoreMatrixRequest,
    fallback_score_matrix_many,
)
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import stepper as tstep
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.ops.decode_attention import paged_attention

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
FALLBACK_TOL = dict(atol=5e-5, rtol=5e-5)
MODELS = ("tiny-gemma2", "tiny-llama3")
STATS = ("mean", "sum", "last", "moments")
RULES = ("egalitarian", "utilitarian", "log_nash")
PS = 16


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, tcfg = jax_config(name), get_model_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("softcap, window", [(None, None), (50.0, 20)])
def test_paged_attention(softcap, window):
    rng = np.random.default_rng(0)
    b, s, h, kv, hd, n_pages, max_blocks = 3, 5, 4, 2, 16, 9, 4
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k_pages = rng.standard_normal((n_pages + 1, PS, kv, hd), dtype=np.float32)
    v_pages = rng.standard_normal((n_pages + 1, PS, kv, hd), dtype=np.float32)
    tables = np.array([[0, 3, 5, -1], [7, -1, -1, -1], [2, 1, 4, 6]], np.int32)
    lengths = np.array([40, 12, 61], np.int32)
    q_pos = (lengths[:, None] - s + np.arange(s)[None]).astype(np.int32)
    args = (q, k_pages, v_pages, tables, lengths, q_pos)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    expect = jax_paged_attention(*(jnp.asarray(a) for a in args), **kw)
    got = paged_attention(*(torch.from_numpy(a) for a in args), **kw)
    assert max_blocks * PS >= lengths.max()
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _score_chunk_both(name):
    """One 21-token context (one shared page, a 5-token tail) and two
    candidates of 6 and 3 tokens, plus a padding row that repeats row 0
    and writes the sink: prefill the shared page, then score the rows.
    Returns ((JAX hidden, stats), (port hidden, stats)) of the prefill and
    the chunk."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(2)
    ctx = rng.integers(1, tcfg.vocab_size, 21).tolist()
    conts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (6, 3)]
    n0, shared_pages, max_private = PS, 1, 2
    num_pages = shared_pages + 3 * max_private
    sink = num_pages
    # Prefill of the shared page: one row, padded to the 8-row bucket with
    # rows that write the sink.
    pre = dict(
        tokens=np.array([ctx[:n0]] * 8, np.int32),
        chunk_valid=np.ones((8, n0), bool),
        block_tables=np.zeros((8, 1), np.int32),
        lengths=np.full((8,), n0, np.int32),
        write_pages=np.full((8, n0), sink, np.int32),
        write_offsets=np.tile(np.arange(n0, dtype=np.int32), (8, 1)),
    )
    pre["write_pages"][0] = 0
    # Score chunk: query block = context tail + all but the last candidate token.
    width = 16
    rows = 3
    tokens = np.zeros((rows, width), np.int32)
    targets = np.zeros((rows, width), np.int32)
    score_mask = np.zeros((rows, width), bool)
    chunk_valid = np.zeros((rows, width), bool)
    tables = np.full((rows, shared_pages + max_private), -1, np.int32)
    lengths = np.zeros((rows,), np.int32)
    write_pages = np.full((rows, width), sink, np.int32)
    write_offsets = np.zeros((rows, width), np.int32)
    for r, cont in enumerate(conts + [conts[0]]):
        stream = ctx + cont
        q_len = len(ctx) - n0 + len(cont) - 1
        tokens[r, :q_len] = stream[n0 : n0 + q_len]
        targets[r, :q_len] = stream[n0 + 1 : n0 + q_len + 1]
        chunk_valid[r, :q_len] = True
        lengths[r] = n0 + q_len
        base = shared_pages + r * max_private
        tables[r] = [0, base, base + 1]
        if r < len(conts):  # the padding row writes the sink, scores nothing
            pos = np.arange(n0, n0 + q_len)
            write_pages[r, :q_len] = base + pos // PS - 1
            write_offsets[r, :q_len] = pos % PS
            lo = len(ctx) - 1 - n0
            score_mask[r, lo : lo + len(cont)] = True
    chunk = (tokens, targets, score_mask, chunk_valid)
    paging = (tables, lengths, write_pages, write_offsets)

    jstate = jstep.make_page_state(jcfg, num_pages, PS, dtype=jnp.float32)
    jh, jstate = jstep.paged_prefill_chunk(
        jparams, jcfg, *(jnp.asarray(pre[k]) for k in ("tokens", "chunk_valid")), jstate,
        *(jnp.asarray(pre[k]) for k in ("block_tables", "lengths", "write_pages", "write_offsets")),
    )
    jstats, _ = jstep.paged_score_chunk(
        jparams, jcfg, *map(jnp.asarray, chunk), jstate, *map(jnp.asarray, paging)
    )
    tstate = tstep.make_page_state(tcfg, num_pages, PS)
    th, tstate = tstep.paged_prefill_chunk(
        tparams, tcfg, *(torch.from_numpy(pre[k]) for k in ("tokens", "chunk_valid")), tstate,
        *(torch.from_numpy(pre[k])
          for k in ("block_tables", "lengths", "write_pages", "write_offsets")),
    )
    tstats, _ = tstep.paged_score_chunk(
        tparams, tcfg, *map(torch.from_numpy, chunk), tstate, *map(torch.from_numpy, paging)
    )
    return (np.asarray(jh), tuple(np.asarray(x) for x in jstats)), (th.numpy(), tstats)


@pytest.mark.parametrize("name", MODELS)
def test_paged_prefill_and_score_chunk(name):
    (jh, jstats), (th, tstats) = _score_chunk_both(name)
    np.testing.assert_allclose(th[0], jh[0], atol=ATOL, rtol=0)
    for got, expect in zip(tstats[:3], jstats[:3]):
        np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)
    assert tstats[3].tolist() == jstats[3].tolist() == [6, 3, 0]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("stat", STATS)
def test_utility_matrix(stat, rule):
    """Three rows as a (1 candidate x 3 agents) matrix; the padding row has
    no scored token and takes the default."""
    (_, jstats), (_, tstats) = _score_chunk_both("tiny-gemma2")
    expect = jstep.utility_matrix(
        tuple(jnp.asarray(x) for x in jstats), 1, 3, stat=stat, rule=rule
    )
    got = tstep.utility_matrix(tstats, 1, 3, stat=stat, rule=rule)
    for g, e in zip(got[:2], expect[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=ATOL, rtol=0)
    if stat == "moments":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(expect[2]), atol=ATOL, rtol=0)
    else:
        assert got[2] is None and expect[2] is None
    assert float(got[0][0, 2]) == -10.0


@pytest.fixture(scope="module")
def backends():
    out = {}
    for name in MODELS:
        ref = TPUBackend(model=name, dtype="float32", max_context=256)
        params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
        out[name] = (ref, TorchBackend(model=name, dtype="float32", max_context=256,
                                       params=params, device="cpu"))
    return out


def _request(n_agents=3, n_candidates=3, stat="mean", jax_types=False):
    agent_type = JaxAgentContext if jax_types else AgentContext
    request_type = JaxScoreMatrixRequest if jax_types else ScoreMatrixRequest
    return request_type(
        agents=tuple(
            agent_type(context=f"Opinion holder {i} wants more of option {i}.",
                       system_prompt="You are a panelist.", chat=True)
            for i in range(n_agents)
        ),
        candidates=tuple(f"Candidate statement {j} about the issue." for j in range(n_candidates)),
        stat=stat,
    )


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("name", MODELS)
def test_score_matrix_matches_jax_and_fallback(backends, name, stat):
    ref, port = backends[name]
    expect = ref.score_matrix([_request(stat=stat, jax_types=True)])[0]
    got = port.score_matrix([_request(stat=stat)])[0]
    fallback = fallback_score_matrix_many(port, [_request(stat=stat)])[0]
    assert got.path == expect.path == "fused"
    for field in ("utilities", "welfare", "aux"):
        g, e, f = getattr(got, field), getattr(expect, field), getattr(fallback, field)
        if stat != "moments" and field == "aux":
            assert g is None and e is None
            continue
        np.testing.assert_allclose(g, np.asarray(e), atol=ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(g, np.float64), f, **FALLBACK_TOL)
    assert got.best == expect.best == fallback.best
    n_cells = 9
    assert got.cells == n_cells
    assert got.d2h_bytes == n_cells * 4 * (2 if stat == "moments" else 1) + 3 * 4
    assert port.matrix_stats["fallbacks"] == 0


def test_overlong_rows_fall_back(backends):
    _, port = backends["tiny-gemma2"]
    request = ScoreMatrixRequest(
        agents=(AgentContext(context="word " * 60, chat=False),), candidates=("short tail.",)
    )
    before = dict(port.matrix_stats)
    result = port.score_matrix([request])[0]
    assert result.path == "fallback"
    assert port.matrix_stats["fallbacks"] == before["fallbacks"] + 1
    assert port.call_counts["score_matrix"] >= port.matrix_stats["calls"] == before["calls"] + 1


def test_64_agents_chunk_under_budget(backends):
    """A 64-agent matrix streams through a shrunken session budget in more
    than one chunk, with no fallback, and the chunked utilities equal the
    unchunked run's exactly."""
    _, port = backends["tiny-gemma2"]
    request = ScoreMatrixRequest(
        agents=tuple(
            AgentContext(context=f"Panel member {i} holds position variant {i}.", chat=True)
            for i in range(64)
        ),
        candidates=("Fund parks first.", "Parking is essential."),
    )
    full = port.score_matrix([request])[0]
    assert full.path == "fused"
    c = port.config
    page_bytes = c.n_layers * PS * c.n_kv_heads * c.head_dim * 4 * 2
    shared_pages = 0
    for agent in request.agents:
        ids = port.tokenizer.encode(port._score_prefix(agent.to_score_request("")), add_bos=True)
        shared_pages += (len(ids) - 1) // PS
    cap = port._session_budget.cap
    port._session_budget.cap = page_bytes * (shared_pages + 8 * 8 + 1)
    chunks, fallbacks = port.matrix_stats["chunks"], port.matrix_stats["fallbacks"]
    try:
        chunked = port.score_matrix([request])[0]
    finally:
        port._session_budget.cap = cap
    assert chunked.path == "fused"
    assert port.matrix_stats["fallbacks"] == fallbacks
    assert port.matrix_stats["chunks"] - chunks > 1
    np.testing.assert_array_equal(chunked.utilities, full.utilities)
    assert port._session_budget.used == 0
