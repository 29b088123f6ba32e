"""The port's paged decode programs (``models/stepper.py``:
``paged_decode_step``, ``paged_decode_steps``, ``paged_gather_step``) and
``TorchBackend.generate_stream`` against the JAX package's.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  Tolerances: paged logits within 1e-4 absolute of the
JAX package's paged logits (float32, different summation orders) and within
2e-4 of the dense forward (the reference's own paged-vs-dense bound,
``tests/test_engine.py``); tokens exactly.  Streams: K in {1, 4, 8} give the
same tokens as each other (exact by construction: the window replays the
sequential per-row key splits) and as ``TPUBackend.generate_stream``; against
the dense ``generate`` they are equal on a cohort whose every draw is
checked to have a margin over 1e-3 (paged and dense logits differ by about
2e-4).  tiny-llama3: tiny-gemma2's greedy picks are near-ties.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.base import GenerationRequest as JaxRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import stepper as jstep
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import stepper as tstep
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.utils import threefry

torch.set_num_threads(1)

ATOL = 1e-4
DENSE_ATOL = 2e-4
MARGIN = 1e-3
MODELS = ("tiny-gemma2", "tiny-llama3")


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg = jax_config(name)
    tcfg = get_model_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _t(a, dtype=None):
    out = torch.from_numpy(np.asarray(a))
    return out if dtype is None else out.to(dtype)


def _prefill_both(name, prompts, page_size=4, chunk=4):
    """Prefill ``prompts`` (one per row) into contiguous pages in both
    packages.  Returns (tables, lengths, jax state, port state, jax logits,
    port logits) with the logits at each row's last prompt position."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rows = len(prompts)
    max_blocks = 8
    pages_per = [-(-(len(p) + 16) // page_size) for p in prompts]
    num_pages = sum(pages_per) + 2
    tables = np.full((rows, max_blocks), -1, np.int32)
    off = 0
    for r, n in enumerate(pages_per):
        tables[r, :n] = np.arange(off, off + n)
        off += n
    jstate = jstep.make_page_state(jcfg, num_pages, page_size, jnp.float32)
    tstate = tstep.make_page_state(tcfg, num_pages, page_size, torch.float32)
    sink = num_pages
    lengths = np.zeros(rows, np.int32)
    jlast = tlast = None
    for start in range(0, max(len(p) for p in prompts), chunk):
        tok = np.zeros((rows, chunk), np.int32)
        val = np.zeros((rows, chunk), bool)
        wp = np.full((rows, chunk), sink, np.int32)
        wo = np.zeros((rows, chunk), np.int32)
        last = np.zeros(rows, bool)
        for r, ids in enumerate(prompts):
            piece = ids[start : start + chunk]
            if not len(piece):
                continue
            pos = start + np.arange(len(piece))
            tok[r, : len(piece)] = piece
            val[r, : len(piece)] = True
            wp[r, : len(piece)] = tables[r, pos // page_size]
            wo[r, : len(piece)] = pos % page_size
            lengths[r] = start + len(piece)
            last[r] = start + len(piece) >= len(ids)
        # ``lengths`` changes in place each chunk: hand JAX a copy (on the
        # CPU it may alias a NumPy buffer, read when the call runs).
        jh, jstate = jstep.paged_prefill_chunk(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(val), jstate, jnp.asarray(tables),
            jnp.asarray(lengths.copy()), jnp.asarray(wp), jnp.asarray(wo),
        )
        th, tstate = tstep.paged_prefill_chunk(
            tparams, tcfg, _t(tok), _t(val), tstate, _t(tables), _t(lengths.copy()), _t(wp), _t(wo),
        )
        jlast = jh if jlast is None else jnp.where(jnp.asarray(last)[:, None], jh, jlast)
        tlast = th if tlast is None else torch.where(_t(last)[:, None], th, tlast)
    jlogits = jtf.project_logits(jparams, jcfg, jlast.astype(jnp.float32))
    tlogits = ttf.project_logits(tparams, tcfg, tlast.to(torch.float32))
    return tables, lengths, jstate, tstate, jlogits, tlogits


def _dense_last_logits(name, ids):
    _, _, tcfg, tparams = _models(name)
    n = len(ids)
    logits, _ = ttf.forward(
        tparams, tcfg, _t(np.asarray([ids], np.int32)), _t(np.arange(n, dtype=np.int32)[None]),
        torch.ones((1, n), dtype=torch.bool),
    )
    return logits[0, -1].numpy()


@pytest.mark.parametrize("name", MODELS)
def test_paged_decode_step_matches_jax_and_dense(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, tcfg.vocab_size, size=(n,)).astype(np.int32) for n in (7, 11)]
    tables, lengths, jstate, tstate, jlogits, tlogits = _prefill_both(name, prompts)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    page_size = 4
    seqs = [list(p) for p in prompts]
    for _ in range(5):
        tokens = np.asarray(np.argmax(tlogits.numpy(), axis=-1), np.int32)
        for r in range(2):
            np.testing.assert_allclose(
                tlogits[r].numpy(), _dense_last_logits(name, seqs[r]), atol=DENSE_ATOL, rtol=0
            )
            seqs[r].append(int(tokens[r]))
        pos = lengths.copy()
        lengths = lengths + 1
        wp = tables[np.arange(2), pos // page_size]
        wo = pos % page_size
        jlogits, jstate = jstep.paged_decode_step(
            jparams, jcfg, jnp.asarray(tokens), jstate, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(wp), jnp.asarray(wo),
        )
        tlogits, tstate = tstep.paged_decode_step(
            tparams, tcfg, _t(tokens), tstate, _t(tables), _t(lengths.copy()), _t(wp), _t(wo),
        )
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_paged_gather_step_matches_jax_and_dense_without_writing_pages(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, tcfg.vocab_size, size=(8,)).astype(np.int32)
    tables, lengths, jstate, tstate, _, _ = _prefill_both(name, [prompt])
    # Row 1 adopts row 0's pages (the prefix cache's shared read path).
    g_tables = np.concatenate([tables, tables])
    before = tstate.k_pages[:, :-1].clone()
    jlog, _ = jstep.paged_gather_step(
        jparams, jcfg, jnp.asarray([prompt[-1]] * 2), jstate, jnp.asarray(g_tables),
        jnp.asarray([8, 8], np.int32),
    )
    tlog, tstate = tstep.paged_gather_step(
        tparams, tcfg, _t(np.asarray([prompt[-1]] * 2, np.int32)), tstate, _t(g_tables),
        _t(np.asarray([8, 8], np.int32)),
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    dense = _dense_last_logits(name, list(prompt))
    for r in range(2):
        np.testing.assert_allclose(tlog[r].numpy(), dense, atol=DENSE_ATOL, rtol=0)
    assert torch.equal(tstate.k_pages[:, :-1], before)


@pytest.mark.parametrize("num_steps", [1, 3, 8])
def test_paged_decode_steps_window_matches_jax(num_steps):
    name = "tiny-llama3"
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, tcfg.vocab_size, size=(n,)).astype(np.int32) for n in (5, 9, 6)]
    tables, lengths, jstate, tstate, jlogits, tlogits = _prefill_both(name, prompts)
    seeds = np.asarray([3, 4, 5])
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(7), s))(jnp.asarray(seeds))
    tkeys = threefry.fold_in(threefry.prng_key(7), _t(seeds.astype(np.int64)))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    temps = np.asarray([0.9, 0.0, 1.3], np.float32)
    budgets = np.asarray([6, 4, 9], np.int32)
    eos = np.asarray([tcfg.vocab_size - 1, 2], np.int32)
    jcarry = (jlogits, jstate, jnp.asarray(lengths), jkeys, jnp.zeros(3, bool),
              jnp.asarray(budgets), jnp.zeros(3, bool))
    tcarry = (tlogits, tstate, _t(lengths.copy()), tkeys, torch.zeros(3, dtype=torch.bool),
              _t(budgets.copy()), torch.zeros(3, dtype=torch.bool))
    jtok, ttok = [], []
    for _ in range(-(-11 // num_steps)):
        jout = jstep.paged_decode_steps(
            jparams, jcfg, *jcarry[:1], jcarry[1], jnp.asarray(tables), *jcarry[2:],
            temperature=jnp.asarray(temps), eos_ids=jnp.asarray(eos), num_steps=num_steps,
        )
        tout = tstep.paged_decode_steps(
            tparams, tcfg, tcarry[0], tcarry[1], _t(tables), *tcarry[2:],
            temperature=_t(temps), eos_ids=_t(eos), num_steps=num_steps, sampling=True,
        )
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=ATOL, rtol=0)
        for t_arr, j_arr in zip(tout[4:9], jout[4:9]):
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr).astype(t_arr.numpy().dtype))
        jtok.append(np.asarray(jout[0]))
        ttok.append(tout[0].numpy())
        jcarry = (jout[2], jout[3]) + tuple(jout[4:9])
        tcarry = (tout[2], tout[3]) + tuple(tout[4:9])
    assert bool(tcarry[4].all())  # every row froze within the budget + eos-check step


# ---------------------------------------------------------------------------
# TorchBackend.generate_stream against TPUBackend.generate_stream
# ---------------------------------------------------------------------------

COHORT = (
    ("Say something about apples.", 11, 12, 0.8),
    ("Hi", 22, 5, 0.0),
    ("A longer prompt that should span several pages of the stream pool for "
     "testing purposes.", 33, 20, 0.9),
    ("Bike lanes or bus lanes?", 44, 16, 0.7),
)
KW = dict(model="tiny-llama3", dtype="float32", max_context=128, base_seed=7)


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**KW)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **KW)


def _requests(cls):
    return [cls(user_prompt=p, seed=s, max_tokens=m, temperature=t) for p, s, m, t in COHORT]


def _drain(stream):
    results, windows = {}, 0
    while not stream.finished:
        stream.dispatch()
        _, finished = stream.collect()
        results.update(finished)
        windows += 1
        assert windows < 200
    stream.close()
    return [(results[i].text, results[i].token_ids, results[i].finish_reason)
            for i in range(len(results))], windows


def _with_settled_lengths(prefill_chunk):
    """``paged_prefill_chunk`` handed a NumPy copy of its ``lengths``
    argument.  ``TPUBackend.generate_stream`` rewrites one NumPy ``lengths``
    buffer chunk after chunk and passes ``jnp.asarray`` of it; on the CPU
    that array aliases the buffer whenever it is 64-byte aligned, and under
    async dispatch a chunk that has not run yet reads the NEXT chunk's
    lengths (the stream's tokens then follow the machine's load)."""
    def call(params, config, tokens, valid, state, tables, lengths, *args, **kwargs):
        lengths = jnp.asarray(np.array(lengths, copy=True))
        return prefill_chunk(params, config, tokens, valid, state, tables, lengths,
                             *args, **kwargs)
    return call


@pytest.fixture(scope="module")
def jax_stream(backends):
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jstep, "paged_prefill_chunk", _with_settled_lengths(jstep.paged_prefill_chunk))
        return _drain(backends[0].generate_stream(_requests(JaxRequest), decode_steps=4))[0]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_stream_k_family_equals_jax_stream(backends, jax_stream, k):
    port_out, windows = _drain(backends[1].generate_stream(_requests(GenerationRequest), decode_steps=k))
    assert port_out == jax_stream
    # 21 decisions at most (a 20-token budget plus the eos-check sample).
    assert windows <= -(-21 // k) + 1


def _draw_margins(port, request, token_ids):
    """Margin (top-1 minus top-2 of logits / T + Gumbel, or of the logits
    for greedy rows) of every draw the row made, recomputed densely."""
    tok = port.tokenizer
    ids = tok.encode(port._render_prompt(request), add_bos=True)
    full = ids + list(token_ids)
    n = len(full)
    logits, _ = ttf.forward(
        port.params, port.config, _t(np.asarray([full], np.int32)),
        _t(np.arange(n, dtype=np.int32)[None]), torch.ones((1, n), dtype=torch.bool),
    )
    key = port._row_keys("generate", [request.seed])
    margins = []
    for t in range(min(len(token_ids) + 1, request.max_tokens)):
        pairs = threefry.split(key)
        key, sub = pairs[:, 0], pairs[:, 1]
        scores = logits[0, len(ids) - 1 + t]
        if request.temperature > 0:
            scores = scores / request.temperature + threefry.gumbel(sub, (scores.shape[-1],))[0]
        top2 = torch.topk(scores, 2).values
        margins.append(float(top2[0] - top2[1]))
    return margins


def test_stream_equals_dense_generate_on_a_tie_free_cohort(backends, jax_stream):
    port = backends[1]
    dense = [(r.text, r.token_ids, r.finish_reason) for r in port.generate(_requests(GenerationRequest))]
    for request, (_, token_ids, _) in zip(_requests(GenerationRequest), dense):
        assert min(_draw_margins(port, request, token_ids)) > MARGIN
    assert dense == jax_stream


def test_stream_counts_tokens_and_generate_calls(backends):
    port = backends[1]
    before = dict(port.token_counts), dict(port.call_counts)
    out, _ = _drain(port.generate_stream(_requests(GenerationRequest), decode_steps=4))
    assert port.call_counts["generate"] - before[1]["generate"] == len(COHORT)
    assert port.token_counts["generated"] - before[0]["generated"] == sum(len(o[1]) for o in out)


def test_suggest_kv_page_pool_and_speculative_raise(backends, jax_stream):
    """The page-pool suggestion, and the speculative stream, which builds
    now: its tokens equal the plain stream's (exact on the CPU) and its
    draft accounting counts every live row's K drafts per window."""
    ref, port = backends
    c = port.config
    per_token = int(2 * c.n_layers * c.n_kv_heads * c.head_dim * 1.25)
    assert port.suggest_kv_page_pool(16) == max(64, (port._session_budget.cap // 2) // (per_token * 16))
    stream = port.generate_stream(_requests(GenerationRequest), decode_steps=4, speculative=True)
    out, windows = _drain(stream)
    assert out == jax_stream
    assert stream.spec_proposed >= 4 * windows and 0 <= stream.spec_accepted <= stream.spec_proposed
