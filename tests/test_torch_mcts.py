"""MCTS: the port's ``MCTSGenerator`` against the JAX package's.

Model level: ``TorchBackend`` against ``TPUBackend`` on tiny-llama3 in
float32, the JAX weights converted with ``params_from_jax`` (flash and
decode attention on: the Pallas kernels in interpret mode against the
port's plain versions).  At waves 1 and 8, deterministic (temperature 0,
on proposals checked to be tie-free: gaps > 1e-3 between consecutive
reference logprobs) and sampled (temperature 1, the session keys bit for
bit ``jax.random``'s), the statement, the per-step root visit log and the
search counters (device dispatches, waves, selections, collisions) must be
equal.  Also: speculative rollouts on and off give the same search, and
MCTS over the forced full-prefix fallback session matches the JAX
fallback's.

Host level: one scripted session (deterministic candidates and rollouts
from a hash of the call) drives both generators, so the tree logic -- UCB1,
virtual loss and its exact revert, the salt sequence, terminals, failed
rollouts, ``pin_budget`` -- is compared free of float noise.
"""

import contextlib
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.methods import mcts as jmcts_mod
from consensus_tpu.methods.mcts import MCTSGenerator as JaxMCTS
from consensus_tpu_torch.backends.session import PrefixTokenSearchSession, ScoredCandidate
from consensus_tpu_torch.backends.torch_backend import TorchBackend, TorchTokenSearchSession
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.methods import mcts as tmcts_mod
from consensus_tpu_torch.methods.mcts import MCTSGenerator
from consensus_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

MODEL = "tiny-llama3"
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
MCTS = {"num_simulations": 8, "expansion_sample_width": 3, "max_tokens": 4, "rollout_depth": 3,
        "gamma": 0.99, "seed": 3}
STAT_KEYS = ("device_dispatches", "waves", "selections", "collisions", "wave_size")


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(**OPTIONS, params=params, device="cpu")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


def _stats(generator):
    stats = generator.search_stats
    log = [[tuple(pair) for pair in step] for step in stats["visit_log"]]
    return {key: stats[key] for key in STAT_KEYS}, log


@contextlib.contextmanager
def _recording(module):
    """Record the session and every proposal list of the method's
    sessions (``module.open_token_search`` wrapped)."""
    original = module.open_token_search
    sessions, proposals = [], []

    def opened(backend, spec):
        session = original(backend, spec)
        sessions.append(session)
        for name in ("propose", "advance_and_propose", "propose_suffixes"):
            method = getattr(session, name)

            def call(*args, _method=method, **kwargs):
                out = _method(*args, **kwargs)
                proposals.extend(out)
                return out

            setattr(session, name, call)
        return session

    module.open_token_search = opened
    try:
        yield sessions, proposals
    finally:
        module.open_token_search = original


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["argmax", "sampled"])
@pytest.mark.parametrize("wave", [1, 8])
def test_mcts_matches_jax(backends, wave, temperature):
    ref, port = backends
    config = dict(MCTS, mcts_wave_size=wave, temperature=temperature)
    with _recording(tmcts_mod) as (sessions, proposals):
        generator = get_method_generator("mcts", port, config)
        got = generator.generate_statement(ISSUE, OPINIONS)
    expected = JaxMCTS(ref, config)
    expect = expected.generate_statement(ISSUE, OPINIONS)
    assert isinstance(generator, MCTSGenerator)
    assert [type(s) for s in sessions] == [TorchTokenSearchSession]
    if temperature == 0.0:
        for candidates in proposals:
            gaps = -np.diff([c.ref_logprob for c in candidates])
            assert gaps.min() > TIE_MARGIN, f"near-tie proposals {candidates}"
    assert got == expect
    assert _stats(generator) == _stats(expected)
    assert generator.search_stats["device_dispatches"] > 0
    assert generator.pre_brushup_statement == expected.pre_brushup_statement
    assert port._session_budget.used == 0


def test_speculative_rollouts_do_not_change_the_search(backends):
    """``speculative_rollouts`` verifies n-gram drafts instead of decoding
    step by step: the same statement and visit log, more dispatches (one
    per verify round) on these random weights, as the JAX method gives."""
    ref, port = backends
    config = dict(MCTS, mcts_wave_size=8, temperature=1.0)
    plain = MCTSGenerator(port, config)
    statement = plain.generate_statement(ISSUE, OPINIONS)
    with _recording(tmcts_mod) as (sessions, _):
        spec = MCTSGenerator(port, dict(config, speculative_rollouts=True))
        assert spec.generate_statement(ISSUE, OPINIONS) == statement
    assert _stats(spec)[1] == _stats(plain)[1]
    (session,) = sessions
    assert session.draft_tokens["verify_dispatches"] > 0
    expected = JaxMCTS(ref, dict(config, speculative_rollouts=True))
    assert expected.generate_statement(ISSUE, OPINIONS) == statement
    assert _stats(spec) == _stats(expected)


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


@pytest.mark.parametrize("wave", [1, 8])
def test_mcts_over_the_fallback_session(backends, wave):
    """Session budget forced to 1 KiB on both sides: MCTS runs over the
    full-prefix sessions (rollouts are one generate + one score call)."""
    ref, port = backends
    config = dict(MCTS, num_simulations=4, max_tokens=3, mcts_wave_size=wave, temperature=1.0)
    with _forced_budget(ref, port), _recording(tmcts_mod) as (sessions, _):
        generator = MCTSGenerator(port, config)
        got = generator.generate_statement(ISSUE, OPINIONS)
        expected = JaxMCTS(ref, config)
        expect = expected.generate_statement(ISSUE, OPINIONS)
    assert [type(s) for s in sessions] == [PrefixTokenSearchSession]
    assert got == expect
    assert _stats(generator) == _stats(expected)


# ---------------------------------------------------------------------------
# Scripted session: the host logic of both generators, free of float noise
# ---------------------------------------------------------------------------

VOCAB = ["a", " b", "c", " d", "e", ".\n\n", " f", "<eos>", "g", " h"]


class ScriptedSession:
    """Candidates and rollouts drawn from a hash of each call's arguments
    (the trunk so far, the path, the salt), with terminal tokens and failed
    rollouts among them.  Every call counts one dispatch."""

    def __init__(self, spec):
        self.spec = spec
        self.trunk = []
        self.dispatch_count = 0
        self.calls = []

    def _candidates(self, *key):
        rng = random.Random(repr((self.trunk, key)))
        ids = rng.sample(range(len(VOCAB)), self.spec.k)
        n_agents = len(self.spec.agent_prompts)
        return [
            ScoredCandidate(VOCAB[i], i, rng.uniform(-4, 0),
                            tuple(rng.uniform(-6, 0) for _ in range(n_agents)))
            for i in ids
        ]

    def propose(self):
        self.dispatch_count += 1
        self.calls.append(("propose",))
        return [self._candidates("root")]

    def advance_and_propose(self, parents, chosen):
        self.dispatch_count += 1
        self.trunk.append(chosen[0].token_id)
        self.calls.append(("advance", tuple(parents), chosen[0].token_id))
        return [self._candidates("advance")]

    def propose_suffixes(self, suffixes, salt):
        self.dispatch_count += 1
        paths = [tuple(c.token_id for c in s) for s in suffixes]
        self.calls.append(("suffixes", tuple(paths), salt))
        return [self._candidates(path, salt) for path in paths]

    def rollout_many(self, suffixes, depth, salts):
        self.dispatch_count += 1
        paths = [tuple(c.token_id for c in s) for s in suffixes]
        self.calls.append(("rollouts", tuple(paths), depth, tuple(salts)))
        out = []
        for path, salt in zip(paths, salts):
            rng = random.Random(repr((self.trunk, path, salt, depth)))
            if rng.random() < 0.15:
                out.append(([], "", [], False))
                continue
            ids = [rng.randrange(len(VOCAB)) for _ in range(rng.randint(0, depth))]
            totals = [rng.uniform(-20, 0) for _ in self.spec.agent_prompts]
            out.append((ids, "".join(VOCAB[i] for i in ids), totals, True))
        return out

    def close(self):
        pass


class _Backend:
    name = "scripted"


@contextlib.contextmanager
def _scripted():
    sessions = []

    def opened(backend, spec):
        sessions.append(ScriptedSession(spec))
        return sessions[-1]

    originals = (tmcts_mod.open_token_search, jmcts_mod.open_token_search)
    tmcts_mod.open_token_search = jmcts_mod.open_token_search = opened
    try:
        yield sessions
    finally:
        tmcts_mod.open_token_search, jmcts_mod.open_token_search = originals


SCRIPTED = {
    "wave1": dict(num_simulations=12, expansion_sample_width=3, max_tokens=6, seed=1),
    "wave3": dict(num_simulations=12, expansion_sample_width=3, max_tokens=6, seed=1,
                  mcts_wave_size=3),
    "wave8-wide": dict(num_simulations=20, expansion_sample_width=5, max_tokens=6, seed=2,
                       mcts_wave_size=8, virtual_loss=0.5, exploration_constant=2.0),
    "wave8-pinned": dict(num_simulations=16, expansion_sample_width=4, max_tokens=5, seed=4,
                         mcts_wave_size=8, pin_budget=True, gamma=0.9),
    "scaled": dict(num_simulations=10, expansion_sample_width=2, max_tokens=4, seed=5,
                   mcts_wave_size=4, budget_scale=0.5),
}


@pytest.mark.parametrize("case", sorted(SCRIPTED))
def test_scripted_session_drives_both_generators_alike(case):
    """Statement, visit log, counters, the calls made on the session (paths
    and salts) and the degraded flags are the JAX generator's."""
    config = SCRIPTED[case]
    with _scripted() as sessions:
        port = MCTSGenerator(_Backend(), config)
        got = port.generate_statement(ISSUE, OPINIONS)
        ref = JaxMCTS(_Backend(), config)
        expect = ref.generate_statement(ISSUE, OPINIONS)
    assert got == expect
    assert _stats(port) == _stats(ref)
    assert sessions[0].calls == sessions[1].calls
    assert (port.degraded, port.degraded_reason, port.budget_spent) == (
        ref.degraded, ref.degraded_reason, ref.budget_spent)
    assert any(call[0] == "rollouts" for call in sessions[0].calls)


def test_virtual_loss_reverts_exactly():
    """After every wave the transient virtual-loss visits are unwound
    exactly: the root's visit count grows by exactly ``num_simulations``
    per emitted token (the chosen child keeps its earlier visits), as
    ``tests/test_mcts_wave.py`` pins for the JAX method."""
    deltas, snapshot = [], {}

    class Capturing(MCTSGenerator):
        def _most_visited_child(self, root):
            deltas.append(root.visits - snapshot.get(id(root), 0))
            snapshot.clear()
            snapshot.update((id(ch), ch.visits) for ch in root.children.values())
            return MCTSGenerator._most_visited_child(root)

    config = dict(SCRIPTED["wave8-wide"], pin_budget=True)
    with _scripted():
        generator = Capturing(_Backend(), config)
        generator.generate_statement(ISSUE, OPINIONS)
    assert deltas and generator.search_stats["collisions"] > 0
    assert deltas == [config["num_simulations"]] * len(deltas)
