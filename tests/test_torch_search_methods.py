"""Token-level search methods: TorchBackend against TPUBackend, same weights.

The reference is ``TPUBackend(..., dtype="float32", use_decode_attention=True)``
(the Pallas decode kernel in interpret mode) with every unported path
switched off; its random weights are converted with ``params_from_jax`` into
``TorchBackend(device="cpu", use_decode_attention=True)`` (the kernel's
plain version).  Beam search and finite lookahead run at temperature 0;
statements must match exactly, on prompts whose every proposal list is
checked to be tie-free (gaps > 1e-3 between consecutive reference
logprobs, against float32 differences ~1e-5).  Session-level proposals
match ids exactly and logprobs within 1e-4, deterministic and sampled: the
port's session keys fold (family, step, slot) into threefry keys that are
bit for bit ``jax.random``'s, so Gumbel-top-k draws the same proposals.
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from consensus_tpu.backends.session import SearchSpec as JaxSearchSpec
from consensus_tpu.backends.tpu import TPUBackend, TPUTokenSearchSession
from consensus_tpu.experiment import Experiment as JaxExperiment
from consensus_tpu.methods.beam_search import BeamSearchGenerator as JaxBeamSearch
from consensus_tpu.methods.finite_lookahead import FiniteLookaheadGenerator as JaxLookahead
from consensus_tpu_torch.backends import session as tsession
from consensus_tpu_torch.backends.session import (
    FusedSessionUnavailable,
    SearchSpec,
    open_token_search,
)
from consensus_tpu_torch.backends.torch_backend import TorchBackend, TorchTokenSearchSession
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.methods import GENERATOR_MAP, get_method_generator
from consensus_tpu_torch.methods import beam_search as tbeam
from consensus_tpu_torch.methods.beam_search import BeamSearchGenerator
from consensus_tpu_torch.methods.finite_lookahead import FiniteLookaheadGenerator
from consensus_tpu_torch.methods.mcts import MCTSGenerator
from consensus_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

MODEL = "tiny-llama3"
ATOL = 1e-4
TIE_MARGIN = 1e-3
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
BEAM = {"beam_width": 3, "max_tokens": 8, "temperature": 0.0, "seed": 3}
LOOKAHEAD = {"branching_factor": 2, "max_depth": 3, "max_tokens": 6, "temperature": 0.0,
             "seed": 3}


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(**OPTIONS, params=params, device="cpu")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


class _Recording:
    """Wraps the port's session factory to record every proposal list."""

    def __init__(self, port):
        self.port = port
        self.proposals = []
        self.sessions = []

    def __enter__(self):
        original = self.port.open_fused_token_search

        def opened(spec):
            session = original(spec)
            self.sessions.append(session)
            for name in ("propose", "advance_and_propose", "propose_suffixes"):
                self._wrap(session, name)
            return session

        self.port.open_fused_token_search = opened
        return self

    def _wrap(self, session, name):
        method = getattr(session, name)

        def call(*args, **kwargs):
            out = method(*args, **kwargs)
            self.proposals.extend(out)
            return out

        setattr(session, name, call)

    def __exit__(self, *exc):
        del self.port.open_fused_token_search

    def assert_tie_free(self):
        assert self.proposals
        for candidates in self.proposals:
            lps = [c.ref_logprob for c in candidates]
            gaps = np.diff(lps)
            assert (-gaps).min() > TIE_MARGIN, f"near-tie proposals {lps}"


def test_beam_search_statement(backends):
    ref, port = backends
    with _Recording(port) as rec:
        got = BeamSearchGenerator(port, BEAM).generate_statement(ISSUE, OPINIONS)
    rec.assert_tie_free()
    expect = JaxBeamSearch(ref, BEAM).generate_statement(ISSUE, OPINIONS)
    assert got == expect
    assert got


def test_finite_lookahead_statement(backends):
    ref, port = backends
    with _Recording(port) as rec:
        got = FiniteLookaheadGenerator(port, LOOKAHEAD).generate_statement(ISSUE, OPINIONS)
    rec.assert_tie_free()
    expect = JaxLookahead(ref, LOOKAHEAD).generate_statement(ISSUE, OPINIONS)
    assert got == expect


@pytest.mark.parametrize("seed, stops_at_once", [(5, False), (152, True)])
def test_finite_lookahead_sampled_statement(backends, seed, stops_at_once):
    """Temperature 1, the method's default: every tree level draws
    Gumbel-top-k proposals from the session's threefry keys, so both sides
    see the same proposals (ids exactly, logprobs within ATOL) and write the
    same statement.  At seed 152 the first pick is a terminator: the
    session never advances and both write the empty statement."""
    ref, port = backends
    config = dict(LOOKAHEAD, temperature=1.0, seed=seed)
    with _Recording(port) as got_rec:
        got = FiniteLookaheadGenerator(port, config).generate_statement(ISSUE, OPINIONS)
    with _Recording(ref) as expect_rec:
        expect = JaxLookahead(ref, config).generate_statement(ISSUE, OPINIONS)
    assert len(got_rec.proposals) == len(expect_rec.proposals) > 0
    for g_row, e_row in zip(got_rec.proposals, expect_rec.proposals):
        assert [c.token_id for c in g_row] == [c.token_id for c in e_row]
        np.testing.assert_allclose(
            [(c.ref_logprob,) + c.agent_logprobs for c in g_row],
            [(c.ref_logprob,) + c.agent_logprobs for c in e_row], atol=ATOL,
        )
    assert got == expect
    assert (got == "") == stops_at_once
    assert [session._step == 0 for session in got_rec.sessions] == [stops_at_once]


@pytest.mark.parametrize("sample", [False, True], ids=["top-k", "gumbel-top-k"])
def test_session_proposals(backends, sample):
    """Session level: propose, one reordering advance, then a tree level over
    the trunk session."""
    ref, port = backends
    fields = dict(
        ref_system="You draft consensus statements.", ref_user="Issue: trees.\nStatement:",
        agent_prompts=(("Agent context.", "Opinion: plant more.\nStatement:"),
                       ("Agent context.", "Opinion: too costly.\nStatement:")),
        k=3, temperature=1.0, seed=11, sample=sample, max_steps=4,
    )
    for n_slots in (2, 1):
        jsession = TPUTokenSearchSession(ref, JaxSearchSpec(n_slots=n_slots, **fields))
        tsession_ = port.open_fused_token_search(SearchSpec(n_slots=n_slots, **fields))
        try:
            expect, got = [jsession.propose()], [tsession_.propose()]
            parents = [1, 0] if n_slots == 2 else [0]
            chosen = [got[0][p][0] for p in parents]
            expect.append(jsession.advance_and_propose(parents, chosen))
            got.append(tsession_.advance_and_propose(parents, chosen))
            if n_slots == 1:
                suffixes = [[got[-1][0][0]], [got[-1][0][1]]]
                expect.append(jsession.propose_suffixes(suffixes, salt=5))
                got.append(tsession_.propose_suffixes(suffixes, salt=5))
            for e_rows, g_rows in zip(expect, got):
                for e_row, g_row in zip(e_rows, g_rows):
                    assert [c.token_id for c in g_row] == [c.token_id for c in e_row]
                    assert [c.token for c in g_row] == [c.token for c in e_row]
                    np.testing.assert_allclose(
                        [(c.ref_logprob,) + c.agent_logprobs for c in g_row],
                        [(c.ref_logprob,) + c.agent_logprobs for c in e_row], atol=ATOL,
                    )
            assert tsession_.dispatch_count == jsession.dispatch_count
        finally:
            jsession.close()
            tsession_.close()
    assert port._session_budget.used == 0


def test_experiment_results_csv(backends, tmp_path):
    ref, port = backends
    config = {
        "experiment_name": "search_parity",
        "seed": 5,
        "num_seeds": 1,
        "scenario": {"issue": ISSUE, "agent_opinions": OPINIONS},
        "deterministic_artifacts": True,
        "methods_to_run": ["beam_search", "finite_lookahead"],
        "beam_search": dict(BEAM, max_tokens=5),
        "finite_lookahead": dict(LOOKAHEAD, max_tokens=4),
    }
    jax_frame = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=ref).run()
    advances = port.call_counts["search_advances"]
    experiment = Experiment(dict(config, output_dir=str(tmp_path / "torch")), backend=port)
    frame = experiment.run()
    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    assert list(on_disk.columns) == list(jax_frame.columns)
    assert list(on_disk["method"]) == ["beam_search", "finite_lookahead"]
    assert (on_disk["error_message"] == "").all()
    assert list(frame["statement"]) == list(jax_frame["statement"])
    # Beam: max_tokens - 1 advances unless every beam completes early;
    # lookahead: one per emitted token but the last.
    assert 0 < port.call_counts["search_advances"] - advances <= 4 + 3


def test_methods_registered():
    """Every method of the JAX package is registered, MCTS included."""
    from consensus_tpu.methods import GENERATOR_MAP as JAX_GENERATOR_MAP

    assert set(GENERATOR_MAP) == set(JAX_GENERATOR_MAP)
    assert isinstance(get_method_generator("mcts", backend=None), MCTSGenerator)
    with pytest.raises(ValueError, match="Unknown method"):
        get_method_generator("no_such_method", backend=None)


def test_use_decode_attention_is_accepted():
    backend = TorchBackend(model=MODEL, device="cpu", use_decode_attention=True)
    assert backend.config.use_decode_attention


def _spec(**kw):
    fields = dict(ref_system=None, ref_user="Issue: x", agent_prompts=((None, "Opinion: y"),),
                  n_slots=2, k=2, max_steps=4)
    fields.update(kw)
    return SearchSpec(**fields)


def test_open_token_search_raises_when_budget_declines():
    """The fused session raises FusedSessionUnavailable over the session
    budget, and the factory then falls back to the full-prefix session, as
    the JAX factory does (``tests/test_torch_prefix_session.py`` holds that
    session against the JAX one)."""
    backend = TorchBackend(model=MODEL, device="cpu", max_context=128)
    backend._session_budget.cap = 1024
    with pytest.raises(FusedSessionUnavailable):
        backend.open_fused_token_search(_spec())
    session = open_token_search(backend, _spec())
    assert isinstance(session, tsession.PrefixTokenSearchSession)
    assert [len(row) for row in session.propose()] == [2, 2]
    assert backend._session_budget.used == 0


def test_open_token_search_without_fused_session_raises():
    """A backend without a fused session gets the full-prefix fallback; its
    first call goes to the backend's ``next_token_logprobs``."""

    class NoSession:
        name = "plain"

    session = tsession.open_token_search(NoSession(), _spec())
    assert isinstance(session, tsession.PrefixTokenSearchSession)
    with pytest.raises(AttributeError, match="next_token_logprobs"):
        session.propose()


@pytest.mark.parametrize("method", ["beam_search", "finite_lookahead"])
def test_pin_budget_runs_the_whole_budget(backends, method):
    """``pin_budget`` (the timing mode): no EOS completes a beam and no
    terminator ends a lookahead path or the statement, as in the JAX
    methods.  Finite lookahead at seed 152 picks a terminator first
    (``test_finite_lookahead_sampled_statement``); pinned, both sides run
    every token instead."""
    ref, port = backends
    generator, jax_generator, config = {
        "beam_search": (BeamSearchGenerator, JaxBeamSearch, dict(BEAM, max_tokens=5)),
        "finite_lookahead": (FiniteLookaheadGenerator, JaxLookahead,
                             dict(LOOKAHEAD, temperature=1.0, seed=152)),
    }[method]
    config = dict(config, pin_budget=True)
    with _Recording(port) as rec:
        got = generator(port, config).generate_statement(ISSUE, OPINIONS)
    expect = jax_generator(ref, config).generate_statement(ISSUE, OPINIONS)
    assert got == expect
    (session,) = rec.sessions
    assert session._step == config["max_tokens"] - 1
    if method == "finite_lookahead":
        assert got and not FiniteLookaheadGenerator(port, dict(config, pin_budget=False)) \
            .generate_statement(ISSUE, OPINIONS)


def test_pin_budget_empties_the_stop_sets(monkeypatch):
    """The sets each method passes on under ``pin_budget``."""
    seen = []
    original = BeamSearchGenerator._prune

    def prune(candidates, completed, beam_width, eos_tokens=None):
        seen.append(eos_tokens)
        return original(candidates, completed, beam_width, eos_tokens)

    monkeypatch.setattr(BeamSearchGenerator, "_prune", staticmethod(prune))
    backend = TorchBackend(model=MODEL, device="cpu", max_context=128)
    for pin in (False, True):
        BeamSearchGenerator(backend, dict(BEAM, max_tokens=2, pin_budget=pin)) \
            .generate_statement(ISSUE, OPINIONS)
    assert seen[0] == tbeam.EOS_TOKENS and seen[-1] == frozenset()


def test_rollouts_and_speculation_raise():
    """The fused session's rollouts and ``SearchSpec.speculative`` work
    (no ``NotImplementedError`` is left): a wave of rollouts, speculative
    and not, gives the same ids; finite lookahead takes ``rollout_depth``
    and ``speculative_rollouts``; a closed session raises."""
    backend = TorchBackend(model=MODEL, device="cpu", max_context=128)
    results = {}
    for speculative in (False, True):
        session = open_token_search(backend, _spec(n_slots=1, seed=7, speculative=speculative))
        assert isinstance(session, TorchTokenSearchSession)
        try:
            root = session.propose()[0]
            with pytest.raises(ValueError, match="non-empty"):
                session.rollout_many([[]], 2, [0])
            results[speculative] = session.rollout_many([[root[0]], [root[1]]], 3, [4, 5])
            assert session.rollout_from([root[0]], 3, 4)[0] == results[speculative][0][0]
        finally:
            session.close()
        with pytest.raises(ValueError, match="closed"):
            session.propose()
    assert [r[0] for r in results[True]] == [r[0] for r in results[False]]
    assert all(len(r[2]) == 1 and r[3] for r in results[True])
    for option in ({"rollout_depth": 2}, {"speculative_rollouts": True, "rollout_depth": 2}):
        generator = FiniteLookaheadGenerator(backend, dict(LOOKAHEAD, max_tokens=3, **option))
        assert isinstance(generator.generate_statement(ISSUE, OPINIONS), str)
    assert backend._session_budget.used == 0


@pytest.mark.parametrize("speculative", [False, True], ids=["sequential", "speculative"])
@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["argmax", "sampled"])
def test_finite_lookahead_rollout_depth(backends, temperature, speculative):
    """Leaf rollouts: every open leaf continues ``rollout_depth`` tokens in
    one ``rollout_many`` call per emitted token and ranks by the max-min
    mean over path + rollout; the statement is the JAX method's."""
    ref, port = backends
    config = dict(LOOKAHEAD, temperature=temperature, rollout_depth=3, max_tokens=5,
                  speculative_rollouts=speculative)
    with _Recording(port) as rec:
        got = FiniteLookaheadGenerator(port, config).generate_statement(ISSUE, OPINIONS)
    expect = JaxLookahead(ref, config).generate_statement(ISSUE, OPINIONS)
    if temperature == 0.0:
        rec.assert_tie_free()
    assert got == expect
    (session,) = rec.sessions
    assert session._step > 0
