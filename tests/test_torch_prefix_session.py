"""The full-prefix fallback session: the port's ``PrefixTokenSearchSession``
against the JAX package's, and against the port's fused session.

Mirrors ``tests/test_session.py``.  Weights: ``TPUBackend(tiny-llama3,
float32)`` with flash and decode attention (the Pallas kernels in interpret
mode), converted with ``params_from_jax`` into ``TorchBackend(device="cpu")``
(the kernels' plain versions).  The session budget is forced to 1 KiB on
both sides, as ``tests/test_score_matrix.py`` forces it, so
``open_token_search`` falls back (and the fused score matrix takes its
per-call route on both sides).  Tolerances: ref and agent logprobs 1e-4
absolute; ids equal wherever the reference's neighbouring logprobs are more
than 1e-3 apart; search statements equal exactly, at temperature 0 on
proposals checked to be tie-free.  Against the fused session, agent
logprobs are compared only for tokens whose string re-encodes to their own
id (the fallback scores the re-encoded string, as the reference's does).
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.backends import session as jsession_mod
from consensus_tpu.backends.session import PrefixTokenSearchSession as JaxPrefixSession
from consensus_tpu.backends.session import SearchSpec as JaxSearchSpec
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.methods import beam_search as jbeam_mod
from consensus_tpu.methods import finite_lookahead as jlookahead_mod
from consensus_tpu.methods.beam_search import BeamSearchGenerator as JaxBeamSearch
from consensus_tpu.methods.finite_lookahead import FiniteLookaheadGenerator as JaxLookahead
from consensus_tpu_torch.backends.base import ScoreResult
from consensus_tpu_torch.backends.session import (
    PrefixTokenSearchSession,
    SearchSpec,
    open_token_search,
)
from consensus_tpu_torch.backends.torch_backend import TorchBackend, TorchTokenSearchSession
from consensus_tpu_torch.methods import beam_search as tbeam_mod
from consensus_tpu_torch.methods import finite_lookahead as tlookahead_mod
from consensus_tpu_torch.methods.beam_search import BeamSearchGenerator
from consensus_tpu_torch.methods.finite_lookahead import FiniteLookaheadGenerator
from consensus_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

MODEL = "tiny-llama3"
ATOL = 1e-4
TIE_MARGIN = 1e-3
FORCED_CAP = 1024
OPTIONS = dict(
    model=MODEL, dtype="float32", use_flash_attention=True, use_decode_attention=True,
    max_context=256, max_batch_rows=32, shared_context_scoring=False,
    shared_trunk_generation=False, segmented_decode=False, kv_quant=False,
)
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
ISSUE = "Should the town add bike paths?"
BEAM = {"beam_width": 3, "max_tokens": 6, "temperature": 0.0, "seed": 3}
LOOKAHEAD = {"branching_factor": 2, "max_depth": 2, "max_tokens": 4, "temperature": 0.0,
             "seed": 3}
SPEC = dict(
    ref_system="You draft consensus statements.",
    ref_user="Issue: taxes.\nOpinions: A wants more, B wants less.\nStatement:",
    agent_prompts=(
        ("Agent context.", "Opinion: A wants more.\nStatement:"),
        ("Agent context.", "Opinion: B wants less.\nStatement:"),
    ),
    n_slots=2, k=3, temperature=1.0, seed=11, sample=False, max_steps=8,
)


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(**OPTIONS, params=params, device="cpu")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


@contextlib.contextmanager
def forced_budget(*backends):
    caps = [b._session_budget.cap for b in backends]
    for b in backends:
        b._session_budget.cap = FORCED_CAP
    try:
        yield
    finally:
        for b, cap in zip(backends, caps):
            b._session_budget.cap = cap


def _roundtrips(backend, cand) -> bool:
    return backend.tokenizer.encode(cand.token) == [cand.token_id]


def _assert_rows_match(got_rows, expect_rows, agents=True, backend=None):
    assert len(got_rows) == len(expect_rows)
    for g_row, e_row in zip(got_rows, expect_rows):
        assert len(g_row) == len(e_row)
        lps = [c.ref_logprob for c in e_row]
        np.testing.assert_allclose([c.ref_logprob for c in g_row], lps, atol=ATOL, rtol=0)
        for j, (g, e) in enumerate(zip(g_row, e_row)):
            if any(abs(lps[j] - lps[i]) <= TIE_MARGIN for i in range(len(lps)) if i != j):
                continue
            assert g.token_id == e.token_id and g.token == e.token
            if agents and (backend is None or _roundtrips(backend, g)):
                np.testing.assert_allclose(g.agent_logprobs, e.agent_logprobs, atol=ATOL, rtol=0)


def test_factory_falls_back_over_cache_cap(backends):
    _, port = backends
    fused = open_token_search(port, SearchSpec(**SPEC))
    assert isinstance(fused, TorchTokenSearchSession)
    fused.close()
    huge = SearchSpec(**dict(SPEC, n_slots=10_000_000))
    assert isinstance(open_token_search(port, huge), PrefixTokenSearchSession)
    with forced_budget(port):
        session = open_token_search(port, SearchSpec(**SPEC))
    assert type(session) is PrefixTokenSearchSession
    assert port._session_budget.used == 0


def test_factory_without_fused_session_falls_back():
    class NoSession:
        name = "plain"

    session = open_token_search(NoSession(), SearchSpec(**SPEC))
    assert isinstance(session, PrefixTokenSearchSession)
    session.close()


@pytest.mark.parametrize("sample", [False, True], ids=["top-k", "gumbel-top-k"])
def test_fallback_matches_jax_fallback(backends, sample):
    """propose, two advances (one reordering), then a tree level over an
    n_slots=1 session: the same proposals and scores as the JAX fallback,
    over the same forced budget."""
    ref, port = backends
    fields = dict(SPEC, sample=sample)
    with forced_budget(ref, port):
        for n_slots in (2, 1):
            j = JaxPrefixSession(ref, JaxSearchSpec(**dict(fields, n_slots=n_slots)))
            t = open_token_search(port, SearchSpec(**dict(fields, n_slots=n_slots)))
            assert isinstance(t, PrefixTokenSearchSession)
            expect, got = [j.propose()], [t.propose()]
            _assert_rows_match(got[-1], expect[-1])
            for parents in ([0] * n_slots, [1, 0] if n_slots == 2 else [0]):
                chosen = [got[-1][p][0] for p in parents]
                expect.append(j.advance_and_propose(parents, chosen))
                got.append(t.advance_and_propose(parents, chosen))
                _assert_rows_match(got[-1], expect[-1])
            if n_slots == 1:
                suffixes = [[got[-1][0][0]], [got[-1][0][1], got[-1][0][0]]]
                _assert_rows_match(
                    t.propose_suffixes(suffixes, salt=5), j.propose_suffixes(suffixes, salt=5)
                )
            assert t.dispatch_count == j.dispatch_count > 0


def test_fallback_matches_fused_session(backends):
    """The port's two sessions on one spec: propose, then three advances
    taking each slot's best round-tripping candidate (k=8, so every slot
    has one: random weights propose many bytes that are no whole
    character)."""
    _, port = backends
    spec = SearchSpec(**dict(SPEC, k=8))
    fused = port.open_fused_token_search(spec)
    fallback = PrefixTokenSearchSession(port, spec)
    try:
        got, expect = fallback.propose(), fused.propose()
        for _ in range(3):
            _assert_rows_match(got, expect, backend=port)
            chosen = [next(c for c in row if _roundtrips(port, c)) for row in expect]
            parents = list(range(spec.n_slots))
            got = fallback.advance_and_propose(parents, chosen)
            expect = fused.advance_and_propose(parents, chosen)
        _assert_rows_match(got, expect, backend=port)
    finally:
        fused.close()


def test_propose_suffixes_matches_full_prefix(backends):
    """A tree level equals proposing from a trunk advanced by each path."""
    _, port = backends
    spec = SearchSpec(**dict(SPEC, n_slots=1))
    tree = PrefixTokenSearchSession(port, spec)
    root = tree.propose()[0]
    suffixes = [[root[0]], [root[1]], [root[0], root[2]]]
    level = tree.propose_suffixes(suffixes, salt=3)
    assert tree.propose_suffixes([], salt=3) == []
    for suffix, row in zip(suffixes, level):
        path = PrefixTokenSearchSession(port, spec)
        path.propose()
        for cand in suffix:
            expect = path.advance_and_propose([0], [cand])[0]
        assert [c.token_id for c in row] == [c.token_id for c in expect]
        np.testing.assert_allclose(
            [(c.ref_logprob,) + c.agent_logprobs for c in row],
            [(c.ref_logprob,) + c.agent_logprobs for c in expect], atol=1e-5, rtol=0,
        )
    with pytest.raises(ValueError, match="n_slots=1"):
        PrefixTokenSearchSession(port, SearchSpec(**SPEC)).propose_suffixes([[root[0]]], 0)


def test_matrix_scoring_on_and_off_agree(backends):
    """The utility-matrix seam (the fused matrix on TorchBackend) and flat
    per-cell score batches give the same scores in the same dispatches."""
    _, port = backends
    sessions = {
        flag: PrefixTokenSearchSession(port, SearchSpec(**dict(SPEC, matrix_scoring=flag)))
        for flag in (True, False)
    }
    rows = {flag: [s.propose()] for flag, s in sessions.items()}
    for flag, s in sessions.items():
        rows[flag].append(s.advance_and_propose([1, 0], [rows[True][0][1][0], rows[True][0][0][1]]))
    for on, off in zip(rows[True], rows[False]):
        for a, b in zip(on, off):
            assert [c.token_id for c in a] == [c.token_id for c in b]
            np.testing.assert_allclose(
                [c.agent_logprobs for c in a], [c.agent_logprobs for c in b], atol=ATOL, rtol=0
            )
    assert sessions[True].dispatch_count == sessions[False].dispatch_count == 4


class _FailingScores:
    """A backend whose scorer returns nothing for every cell."""

    name = "failing"

    def __init__(self, inner):
        self.inner = inner

    def next_token_logprobs(self, requests):
        return self.inner.next_token_logprobs(requests)

    def score(self, requests):
        return [ScoreResult(tokens=(), logprobs=()) for _ in requests]


@pytest.mark.parametrize("matrix_scoring", [True, False], ids=["matrix", "flat"])
def test_failure_logprob(backends, matrix_scoring):
    _, port = backends
    spec = SearchSpec(**dict(SPEC, failure_logprob=-7.5, matrix_scoring=matrix_scoring))
    session = open_token_search(_FailingScores(port), spec)
    assert isinstance(session, PrefixTokenSearchSession)
    for row in session.propose():
        assert len(row) == spec.k
        for cand in row:
            assert cand.agent_logprobs == (-7.5, -7.5)
            assert np.isfinite(cand.ref_logprob)


@contextlib.contextmanager
def _recording_sessions(*modules):
    """Record every session the methods' module-level factory opens, and
    every proposal row each session returns (``proposals[i]`` for
    ``sessions[i]``)."""
    sessions, proposals = [], []
    saved = [m.open_token_search for m in modules]

    def record(session, log):
        for name in ("propose", "advance_and_propose", "propose_suffixes"):
            method = getattr(session, name)

            def call(*args, _method=method, **kwargs):
                out = _method(*args, **kwargs)
                log.extend(out)
                return out

            setattr(session, name, call)

    def wrap(factory):
        def opened(backend, spec):
            session = factory(backend, spec)
            sessions.append(session)
            proposals.append([])
            record(session, proposals[-1])
            return session
        return opened

    for module, factory in zip(modules, saved):
        module.open_token_search = wrap(factory)
    try:
        yield sessions, proposals
    finally:
        for module, factory in zip(modules, saved):
            module.open_token_search = factory


@pytest.mark.parametrize("method", ["beam_search", "finite_lookahead"])
def test_search_methods_through_the_fallback_match_jax(backends, method):
    ref, port = backends
    generator, jax_generator, config, modules = {
        "beam_search": (BeamSearchGenerator, JaxBeamSearch, BEAM, (tbeam_mod, jbeam_mod)),
        "finite_lookahead": (FiniteLookaheadGenerator, JaxLookahead, LOOKAHEAD,
                             (tlookahead_mod, jlookahead_mod)),
    }[method]
    with forced_budget(ref, port), _recording_sessions(*modules) as (sessions, proposals):
        got = generator(port, config).generate_statement(ISSUE, OPINIONS)
        expect = jax_generator(ref, config).generate_statement(ISSUE, OPINIONS)
    assert [type(s) for s in sessions] == [PrefixTokenSearchSession, JaxPrefixSession]
    assert proposals[0]
    for row in proposals[0]:
        lps = [c.ref_logprob for c in row]
        assert (-np.diff(lps)).min() > TIE_MARGIN, f"near-tie proposals {lps}"
    for g_row, e_row in zip(*proposals):
        assert [c.token_id for c in g_row] == [c.token_id for c in e_row]
        np.testing.assert_allclose(
            [(c.ref_logprob,) + c.agent_logprobs for c in g_row],
            [(c.ref_logprob,) + c.agent_logprobs for c in e_row], atol=ATOL, rtol=0,
        )
    assert got == expect
    assert sessions[0].dispatch_count == sessions[1].dispatch_count > 0


def test_rollouts_raise_and_speculation_is_ignored(backends):
    """The fallback's rollouts run (one generate call and one score call
    over the paths) and equal the JAX fallback's; ``speculative`` is
    accepted and ignored, so the rollouts are those of a session without
    it."""
    ref, port = backends
    spec = dict(SPEC, n_slots=1, speculative=True)
    session = PrefixTokenSearchSession(port, SearchSpec(**spec))
    assert session.spec.spec_draft_len == 8
    plain = PrefixTokenSearchSession(port, SearchSpec(**dict(spec, speculative=False)))
    reference = JaxPrefixSession(ref, JaxSearchSpec(**spec))
    root, jroot = session.propose()[0], reference.propose()[0]
    plain.propose()
    got = session.rollout_many([[root[0]], [root[1]]], 3, [1, 2])
    assert plain.rollout_many([[root[0]], [root[1]]], 3, [1, 2]) == got
    expect = reference.rollout_many([[jroot[0]], [jroot[1]]], 3, [1, 2])
    for g, e in zip(got, expect):
        assert g[0] == e[0] and g[1] == e[1] and g[3] == e[3]
        np.testing.assert_allclose(g[2], e[2], atol=ATOL, rtol=0)
    assert session.rollout_from([root[1]], 3, 2) == got[1]
    # The JAX session module's fields, defaults included, are the port's.
    assert [(f.name, f.default) for f in dataclasses.fields(SearchSpec)] == [
        (f.name, f.default) for f in dataclasses.fields(jsession_mod.SearchSpec)
    ]
