"""The port's speculative decode windows (``models/stepper.py::
paged_verify_steps``, ``TorchBackend.generate_stream(speculative=True)``
and ``DecodeEngine(speculative=True)``) against the JAX package's.

tiny-llama3 in float32 on the CPU, JAX weights through ``params_from_jax``.
``paged_verify_steps`` starts from the same prefilled page state in both
packages, with drafts that partly match the plain window's tokens (so some
rows accept and some reject) and partly miss: the emitted tokens, emitted
masks, accepted counts, pending tokens, lengths, keys, done, budgets and
hit_eos are equal exactly, and the page state's K/V (the verify forward's
output) within 1e-4 absolute, window after window.  Three windows of
verify replay the plain ``paged_decode_steps`` tokens exactly.  The port's
engine with speculation on, off and at K=1 gives equal tokens, and equal
to the JAX engine's on a cohort whose every draw is checked to have a
margin over 1e-3.  Over the fake backends the speculative engine's stats
equal the JAX engine's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.base import GenerationRequest as JaxRequest
from consensus_tpu.backends.batching import BatchingBackend as JaxBatchingBackend
from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import stepper as jstep
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import stepper as tstep
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.utils import threefry

torch.set_num_threads(1)

ATOL = 1e-4
MARGIN = 1e-3
NAME = "tiny-llama3"
PAGE = 4


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, tcfg = jax_config(NAME), get_model_config(NAME)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prefill(prompts, budget=16):
    """Prefill one prompt per row into contiguous pages in both packages."""
    jcfg, jparams, tcfg, tparams = _models()
    rows, max_blocks = len(prompts), 12
    pages_per = [-(-(len(p) + budget + 2) // PAGE) for p in prompts]
    num_pages = sum(pages_per) + 2
    tables = np.full((rows, max_blocks), -1, np.int32)
    off = 0
    for r, n in enumerate(pages_per):
        tables[r, :n] = np.arange(off, off + n)
        off += n
    jstate = jstep.make_page_state(jcfg, num_pages, PAGE, jnp.float32)
    tstate = tstep.make_page_state(tcfg, num_pages, PAGE, torch.float32)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    width = int(lengths.max())
    tok = np.zeros((rows, width), np.int32)
    val = np.zeros((rows, width), bool)
    wp = np.full((rows, width), num_pages, np.int32)
    wo = np.zeros((rows, width), np.int32)
    for r, ids in enumerate(prompts):
        pos = np.arange(len(ids))
        tok[r, : len(ids)] = ids
        val[r, : len(ids)] = True
        wp[r, : len(ids)] = tables[r, pos // PAGE]
        wo[r, : len(ids)] = pos % PAGE
    jh, jstate = jstep.paged_prefill_chunk(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(val), jstate, jnp.asarray(tables),
        jnp.asarray(lengths.copy()), jnp.asarray(wp), jnp.asarray(wo))
    th, tstate = tstep.paged_prefill_chunk(
        tparams, tcfg, _t(tok), _t(val), tstate, _t(tables), _t(lengths.copy()), _t(wp), _t(wo))
    jlogits = jtf.project_logits(jparams, jcfg, jh.astype(jnp.float32))
    tlogits = ttf.project_logits(tparams, tcfg, th.to(torch.float32))
    return tables, lengths, jstate, tstate, jlogits, tlogits


def _keys(seeds):
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(7), s))(jnp.asarray(seeds))
    tkeys = threefry.fold_in(threefry.prng_key(7), _t(np.asarray(seeds, np.int64)))
    return jkeys, tkeys


def _plain_tokens(prompts, seeds, temps, budgets, steps=16):
    """The plain window's emitted tokens per row: the drafts' ground truth."""
    _, _, tcfg, tparams = _models()
    tables, lengths, _, tstate, _, tlogits = _prefill(prompts)
    _, tkeys = _keys(seeds)
    n = len(prompts)
    out = tstep.paged_decode_steps(
        tparams, tcfg, tlogits, tstate, _t(tables), _t(lengths.copy()), tkeys,
        torch.zeros(n, dtype=torch.bool), _t(np.asarray(budgets, np.int32)),
        torch.zeros(n, dtype=torch.bool), temperature=_t(np.asarray(temps, np.float32)),
        num_steps=steps, sampling=True,
    )
    return [[int(t) for t, e in zip(out[0][r], out[1][r]) if e] for r in range(n)]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_paged_verify_steps_matches_jax_and_replays_the_plain_window(k):
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.RandomState(k)
    prompts = [rng.randint(1, tcfg.vocab_size, size=(n,)).astype(np.int32) for n in (5, 9, 6, 7)]
    seeds, temps, budgets = [3, 4, 5, 6], [0.9, 0.0, 1.3, 0.0], [10, 8, 12, 9]
    truth = _plain_tokens(prompts, seeds, temps, budgets)
    tables, lengths, jstate, tstate, jlogits, tlogits = _prefill(prompts)
    jkeys, tkeys = _keys(seeds)
    n = len(prompts)
    jcarry = dict(lengths=jnp.asarray(lengths), keys=jkeys, done=jnp.zeros(n, bool),
                  budgets=jnp.asarray(budgets, jnp.int32), hit=jnp.zeros(n, bool),
                  pending=jnp.zeros(n, jnp.int32), state=jstate, logits=jlogits)
    tcarry = dict(lengths=_t(lengths.copy()), keys=tkeys, done=torch.zeros(n, dtype=torch.bool),
                  budgets=_t(np.asarray(budgets, np.int32)), hit=torch.zeros(n, dtype=torch.bool),
                  pending=torch.zeros(n, dtype=torch.int32), state=tstate, logits=tlogits)
    emitted = [[] for _ in range(n)]
    total_accepted = 0
    for window in range(40):
        # Rows 0 and 1 draft their true continuation (rows accept), row 2
        # drafts it with one wrong token, row 3 drafts garbage.
        drafts = np.zeros((n, k), np.int32)
        for r in range(n):
            true_next = (truth[r][len(emitted[r]):] + [1] * k)[:k]
            drafts[r] = true_next
            if r == 2:
                drafts[r, k // 2] = (drafts[r, k // 2] + 1) % tcfg.vocab_size
            if r == 3:
                drafts[r] = rng.randint(1, tcfg.vocab_size, size=k)
        has_pending = window > 0
        jout = jstep.paged_verify_steps(
            jparams, jcfg, jcarry["logits"], jcarry["state"], jnp.asarray(tables),
            jcarry["lengths"], jcarry["keys"], jcarry["done"], jcarry["budgets"], jcarry["hit"],
            temperature=jnp.asarray(temps, jnp.float32), draft_tokens=jnp.asarray(drafts),
            pending=jcarry["pending"], num_steps=k, has_pending=has_pending,
        )
        tout = tstep.paged_verify_steps(
            tparams, tcfg, tcarry["logits"], tcarry["state"], _t(tables),
            tcarry["lengths"], tcarry["keys"], tcarry["done"], tcarry["budgets"], tcarry["hit"],
            temperature=_t(np.asarray(temps, np.float32)), draft_tokens=_t(drafts),
            pending=tcarry["pending"], num_steps=k, has_pending=has_pending, sampling=True,
        )
        for i in (0, 1, 2, 3, 5, 6, 7, 8, 9):
            np.testing.assert_array_equal(
                tout[i].numpy(), np.asarray(jout[i]).astype(tout[i].numpy().dtype))
        for got, want in zip(tout[4], jout[4]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        for r in range(n):
            emitted[r] += [int(t) for t, e in zip(tout[0][r], tout[1][r]) if e]
        total_accepted += int(tout[2].sum())
        jcarry = dict(pending=jout[3], state=jout[4], lengths=jout[5], keys=jout[6],
                      done=jout[7], budgets=jout[8], hit=jout[9], logits=None)
        tcarry = dict(pending=tout[3], state=tout[4], lengths=tout[5], keys=tout[6],
                      done=tout[7], budgets=tout[8], hit=tout[9], logits=None)
        if bool(tcarry["done"].all()):
            break
    assert bool(tcarry["done"].all())
    assert emitted == truth
    assert total_accepted > 0


COHORT = (
    ("Say something about apples.", 11, 12, 0.8),
    ("Hi", 22, 5, 0.0),
    ("A longer prompt that should span several pages of the stream pool.", 33, 20, 0.9),
    ("Bike lanes or bus lanes?", 44, 16, 0.7),
)
KW = dict(model=NAME, dtype="float32", max_context=128, base_seed=7)


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**KW)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **KW)


def _requests(cls):
    return [cls(user_prompt=p, seed=s, max_tokens=m, temperature=t) for p, s, m, t in COHORT]


def _engine_run(backend, batching_cls, request_cls, **engine_options):
    batching = batching_cls(backend, engine=True,
                            engine_options={"slots": 4, "num_pages": 512, **engine_options})
    try:
        results = batching.generate(_requests(request_cls))
        stats = batching.engine.stats()
    finally:
        batching.close()
    return [(r.text, tuple(r.token_ids), r.finish_reason) for r in results], stats


def _min_margin(port, request, token_ids):
    tok = port.tokenizer
    ids = tok.encode(port._render_prompt(request), add_bos=True)
    full = ids + list(token_ids)
    n = len(full)
    logits, _ = ttf.forward(port.params, port.config, _t(np.asarray([full], np.int32)),
                            _t(np.arange(n, dtype=np.int32)[None]), torch.ones((1, n), dtype=torch.bool))
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
    return min(margins)


def test_engine_speculation_on_off_and_k1_agree_and_equal_jax(backends):
    ref, port = backends
    on, on_stats = _engine_run(port, BatchingBackend, GenerationRequest,
                               decode_steps=4, speculative=True)
    off, _ = _engine_run(port, BatchingBackend, GenerationRequest, decode_steps=4)
    k1, _ = _engine_run(port, BatchingBackend, GenerationRequest, decode_steps=1, speculative=True)
    implied, implied_stats = _engine_run(port, BatchingBackend, GenerationRequest, speculative=True)
    assert on == off == k1 == implied
    for request, (_, token_ids, _) in zip(_requests(GenerationRequest), on):
        assert _min_margin(port, request, token_ids) > MARGIN
    jax_on, jax_stats = _engine_run(ref, JaxBatchingBackend, JaxRequest,
                                    decode_steps=4, speculative=True)
    assert on == jax_on
    spec, jax_spec = on_stats["speculative"], jax_stats["speculative"]
    assert spec["enabled"] and spec["proposed_tokens"] > 0
    assert spec == jax_spec
    assert implied_stats["speculative"]["enabled"] and implied_stats["decode_windows"] > 0


def test_stream_speculative_counters_reach_the_registry(backends):
    port = backends[1]
    family = "spec_draft_proposed_tokens_total"

    def proposed():
        fam = port.instruments.registry.snapshot()["families"].get(family)
        return sum(s["value"] for s in fam["series"]) if fam else 0

    before = proposed()
    stream = port.generate_stream(_requests(GenerationRequest), decode_steps=4, speculative=True)
    while not stream.finished:
        stream.dispatch()
        stream.collect()
    stream.close()
    assert proposed() - before == stream.spec_proposed > 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_fake_engine_speculative_stats_equal_jax(k):
    reqs = [(f"prompt {i} about transit and taxes", 100 + i, 24) for i in range(5)]

    def run(backend, batching_cls, cls):
        batching = batching_cls(backend, engine=True, engine_options={
            "slots": 4, "num_pages": 512, "decode_steps": k, "speculative": True})
        try:
            out = batching.generate([cls(user_prompt=p, seed=s, max_tokens=m) for p, s, m in reqs])
            stats = batching.engine.stats()
        finally:
            batching.close()
        return [r.text for r in out], stats["speculative"], stats["decode_windows"]

    assert run(FakeBackend(), BatchingBackend, GenerationRequest) == run(
        JaxFakeBackend(), JaxBatchingBackend, JaxRequest)
