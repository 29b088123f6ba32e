"""``TorchBackend`` at tp=2 against the JAX package's ``TPUBackend`` at
tp=1 on the same weights: generation on the classic, shared-trunk,
segmented and int8 paths (equal where every draw's top-two margin is above
1e-3), scoring and the utility matrix (fused, fallback, shared-context)
within 2e-4, ``next_token_logprobs`` ids, the streamed route against the
materialised one; then a beam session and an MCTS rollout wave at tp=2
step by step against tp=1, and every protocol call, a session and a paged
engine request at dp=2 x tp=2.  The port's tp ranks are ``cpu`` entries of
the plan."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.backends.base import GenerationRequest as JaxGenerationRequest
from consensus_tpu.backends.base import NextTokenRequest as JaxNextTokenRequest
from consensus_tpu.backends.base import ScoreRequest as JaxScoreRequest
from consensus_tpu.backends.score_matrix import AgentContext as JaxAgentContext
from consensus_tpu.backends.score_matrix import ScoreMatrixRequest as JaxScoreMatrixRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu_torch.backends import torch_backend
from consensus_tpu_torch.backends.base import (
    GenerationRequest,
    NextTokenRequest,
    ScoreRequest,
)
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.score_matrix import (
    AgentContext,
    ScoreMatrixRequest,
    fallback_score_matrix_many,
)
from consensus_tpu_torch.backends.session import SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import forward
from consensus_tpu_torch.parallel import TPParams, make_mesh
from consensus_tpu_torch.utils import threefry

torch.set_num_threads(1)

MODEL = "tiny-llama3"
ATOL = 2e-4
TIE_MARGIN = 1e-3
OPTIONS = dict(model=MODEL, dtype="float32", max_context=256, decode_segment_len=16)
PROMPTS = ("Write one sentence about rivers.", "Summarize: taxes.", "Hello")


@pytest.fixture(scope="module")
def backends():
    """(JAX tp=1, port tp=1, port tp=2) on the JAX backend's weights."""
    ref = TPUBackend(**OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    one = TorchBackend(**OPTIONS, params=params, device="cpu")
    two = TorchBackend(**OPTIONS, params=params, mesh=make_mesh(["cpu"] * 2, tp=2))
    assert isinstance(two.params, TPParams) and two._tp == 2 and two.mesh_plan is None
    assert dataclasses.asdict(two.config) == dataclasses.asdict(ref.config)
    return ref, one, two


def _margins(one, request, result):
    """Top-1 minus top-2 of every draw's scores (logits at temperature 0,
    logits / T + the row's Gumbel noise otherwise), on the tp=1 model."""
    prompt = one.tokenizer.encode(one._render_prompt(request), add_bos=True)
    ids = prompt + list(result.token_ids)
    tokens = torch.tensor([ids], dtype=torch.int32)
    positions = torch.arange(len(ids), dtype=torch.int32)[None]
    logits, _ = forward(one.params, one.config, tokens, positions, torch.ones_like(tokens, dtype=torch.bool))
    steps = logits[0, len(prompt) - 1 : len(ids) - (result.finish_reason != "stop")]
    key = one._fold_seed("generate", request.seed)
    margins = []
    for row in steps:
        if request.temperature > 0:
            key, sub = threefry.split(key)
            row = row / request.temperature + threefry.gumbel(sub, row.shape)
        top2 = torch.topk(row, 2).values
        margins.append(float(top2[0] - top2[1]))
    return np.asarray(margins)


def _requests(cls, max_tokens, temperature, same_prompt=False):
    prompts = ["Say one thing about parks."] * 6 if same_prompt else PROMPTS
    return [cls(user_prompt=p, max_tokens=max_tokens, temperature=temperature, seed=seed)
            for seed, p in enumerate(prompts)]


@pytest.mark.parametrize("path, options", [
    ("classic", dict(shared_trunk_generation=False, segmented_decode=False, kv_quant=False)),
    ("shared_trunk", dict(segmented_decode=False, kv_quant=False)),
    ("segmented_int8_kv", dict(shared_trunk_generation=False)),
])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_matches_jax(backends, path, options, temperature):
    ref, one, two = backends
    saved = [(backend, key, getattr(backend, key)) for backend in (ref, one, two)
             for key in options]
    for backend, key, _ in saved:
        setattr(backend, key, options[key])
    try:
        max_tokens = 32 if path.startswith("segmented") else 12
        same = path == "shared_trunk"
        got = two.generate(_requests(GenerationRequest, max_tokens, temperature, same))
        tp1 = one.generate(_requests(GenerationRequest, max_tokens, temperature, same))
        expect = ref.generate(_requests(JaxGenerationRequest, max_tokens, temperature, same))
        checked = 0
        for request, g, e, o in zip(_requests(GenerationRequest, max_tokens, temperature, same),
                                    got, expect, tp1):
            if _margins(one, request, o).min() > TIE_MARGIN:
                assert g.token_ids == e.token_ids == o.token_ids
                assert g.finish_reason == e.finish_reason
                checked += 1
        assert checked >= 1, "every request holds a near-tie draw"
    finally:
        for backend, key, value in saved:
            setattr(backend, key, value)


def test_int8_generation_matches_jax_tp1():
    """``test_quant.py``'s int8 tp case: quantize, then shard; tp=2
    generation equals the JAX package's tp=1."""
    kw = dict(model="tiny-gemma2", dtype="float32", max_context=128, base_seed=0,
              quantization="int8")
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    two = TorchBackend(**kw, params=params, device="cpu", tp=2)
    reqs = [GenerationRequest(user_prompt="Shard me", max_tokens=6, seed=3)]
    assert two.generate(reqs)[0].text == ref.generate(
        [JaxGenerationRequest(user_prompt="Shard me", max_tokens=6, seed=3)])[0].text


def _scores(cls):
    return [
        cls(context="Issue: bikes", continuation="Yes, build them."),
        cls(context="Q", continuation="no", system_prompt="Be brief."),
        cls(context="eval", continuation="A statement.", role="user"),
        cls(context="raw", continuation=" text", chat=False),
    ]


@pytest.mark.parametrize("shared_context", [False, True])
def test_score_matches_jax(backends, shared_context):
    ref, _, two = backends
    two.shared_context_scoring = shared_context
    try:
        for g, e in zip(two.score(_scores(ScoreRequest)), ref.score(_scores(JaxScoreRequest))):
            assert g.tokens == e.tokens
            np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)
    finally:
        two.shared_context_scoring = False


def test_streamed_scoring_matches_materialised(backends, monkeypatch):
    _, _, two = backends
    full = two.score(_scores(ScoreRequest))
    monkeypatch.setattr(torch_backend, "_STREAMED_VOCAB_THRESHOLD", 0)
    streamed = two.score(_scores(ScoreRequest))
    for s, f in zip(streamed, full):
        np.testing.assert_allclose(s.logprobs, f.logprobs, atol=1e-5)


def _matrix(agent_cls, request_cls):
    return request_cls(
        agents=tuple(agent_cls(context=f"Panelist {i} wants option {i}.") for i in range(3)),
        candidates=tuple(f"Candidate statement {j}." for j in range(3)),
    )


def test_score_matrix_fused_and_fallback_match_jax(backends):
    ref, _, two = backends
    expect = ref.score_matrix([_matrix(JaxAgentContext, JaxScoreMatrixRequest)])[0]
    got = two.score_matrix([_matrix(AgentContext, ScoreMatrixRequest)])[0]
    fallback = fallback_score_matrix_many(two, [_matrix(AgentContext, ScoreMatrixRequest)])[0]
    assert got.path == expect.path == "fused"
    np.testing.assert_allclose(got.utilities, np.asarray(expect.utilities), atol=ATOL)
    np.testing.assert_allclose(fallback.utilities, np.asarray(expect.utilities), atol=ATOL)
    assert got.best == expect.best == fallback.best


def test_next_token_ids_match_jax(backends):
    ref, _, two = backends
    args = [dict(user_prompt="Should the city add bike lanes?", k=4, seed=11),
            dict(user_prompt="Roads are for cars.", k=6, mode="topk"),
            dict(user_prompt="We agree that", k=5, seed=14, temperature=0.0)]
    got = two.next_token_logprobs([NextTokenRequest(**a) for a in args])
    expect = ref.next_token_logprobs([JaxNextTokenRequest(**a) for a in args])
    for g_row, e_row in zip(got, expect):
        lps = [c.logprob for c in e_row]
        np.testing.assert_allclose([c.logprob for c in g_row], lps, atol=ATOL)
        for j, (g, e) in enumerate(zip(g_row, e_row)):
            if all(abs(lps[j] - lps[i]) > TIE_MARGIN for i in range(len(lps)) if i != j):
                assert g.token_id == e.token_id


SPEC = dict(ref_system=None, ref_user="Write a joint statement.",
            agent_prompts=((None, "I want more trains."), (None, "I want cheaper cars.")),
            k=3, seed=5)


def _ids(rows):
    return [[c.token_id for c in row] for row in rows]


def test_beam_session_matches_tp1_step_by_step(backends):
    _, one, two = backends
    spec = SearchSpec(**SPEC, n_slots=2, max_steps=8)
    a, b = one.open_fused_token_search(spec), two.open_fused_token_search(spec)
    try:
        pa, pb = a.propose(), b.propose()
        for _ in range(5):
            assert _ids(pa) == _ids(pb)
            for ra, rb in zip(pa, pb):
                np.testing.assert_allclose([c.ref_logprob for c in rb],
                                           [c.ref_logprob for c in ra], atol=ATOL)
                np.testing.assert_allclose([c.agent_logprobs for c in rb],
                                           [c.agent_logprobs for c in ra], atol=ATOL)
            parents, chosen = [1, 0], [pa[1][0], pa[0][1]]
            pa, pb = a.advance_and_propose(parents, chosen), b.advance_and_propose(parents, chosen)
    finally:
        a.close()
        b.close()


def test_mcts_rollout_wave_matches_tp1(backends):
    _, one, two = backends
    spec = SearchSpec(**SPEC, n_slots=1, max_steps=16)
    a, b = one.open_fused_token_search(spec), two.open_fused_token_search(spec)
    try:
        pa, pb = a.propose(), b.propose()
        assert _ids(pa) == _ids(pb)
        suffixes = [[c] for c in pa[0]]
        wave_a = a.rollout_many(suffixes, 6, [1, 2, 3])
        wave_b = b.rollout_many(suffixes, 6, [1, 2, 3])
        for ra, rb in zip(wave_a, wave_b):
            assert ra[0] == rb[0] and ra[3] == rb[3]
            np.testing.assert_allclose(rb[2], ra[2], atol=ATOL)
        assert _ids(a.propose_suffixes(suffixes, 3)) == _ids(b.propose_suffixes(suffixes, 3))
    finally:
        a.close()
        b.close()


def test_every_protocol_call_at_dp2_tp2(backends):
    """``TorchBackend(mesh=make_mesh(["cpu"] * 4, tp=2))``: generate, score,
    score_matrix, embed, next-token, a beam session and a paged engine
    request, each equal to tp=1's."""
    _, one, _ = backends
    wide = TorchBackend(**OPTIONS, params=one.params, mesh=make_mesh(["cpu"] * 4, tp=2))
    assert wide._dp == 2 and wide._tp == 2 and all(isinstance(p, TPParams)
                                                   for p in wide._shard_params)
    gens = [GenerationRequest(user_prompt=f"Say {i}", max_tokens=8, seed=i) for i in range(4)]
    assert [r.token_ids for r in wide.generate(gens)] == [r.token_ids for r in one.generate(gens)]
    for g, e in zip(wide.score(_scores(ScoreRequest)), one.score(_scores(ScoreRequest))):
        np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)
    matrix = _matrix(AgentContext, ScoreMatrixRequest)
    np.testing.assert_allclose(wide.score_matrix([matrix])[0].utilities,
                               one.score_matrix([matrix])[0].utilities, atol=ATOL)
    np.testing.assert_allclose(np.asarray(wide.embed(["a b", "c"])),
                               np.asarray(one.embed(["a b", "c"])), atol=1e-5)
    nxt = [NextTokenRequest(user_prompt="Hello", k=4, mode="topk")]
    assert _ids(wide.next_token_logprobs(nxt)) == _ids(one.next_token_logprobs(nxt))
    spec = SearchSpec(**SPEC, n_slots=2, max_steps=8)
    session = wide.open_fused_token_search(spec)
    reference = one.open_fused_token_search(spec)
    try:
        pa, pb = reference.propose(), session.propose()
        assert _ids(pa) == _ids(pb)
        parents, chosen = [1, 1], [pa[1][0], pa[1][1]]
        assert _ids(reference.advance_and_propose(parents, chosen)) == _ids(
            session.advance_and_propose(parents, chosen))
    finally:
        session.close()
        reference.close()
    batching = BatchingBackend(wide, engine=True, engine_options={"decode_steps": 4})
    try:
        assert batching.engine.mesh_dp == 2 and batching.engine.mesh_tp == 2
        out = batching.generate(gens[:2])
        assert [r.token_ids for r in out] == [r.token_ids for r in one.generate(gens[:2])]
    finally:
        batching.close()
