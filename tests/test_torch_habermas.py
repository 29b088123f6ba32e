"""The port's Habermas Machine against the JAX package's.

* ``aggregate_schulze`` and the Schulze stages on seeded random ballots
  with ties and failed agents: exactly equal arrays (tolerance 0).
* The response parsers on the strings of ``tests/test_social_choice.py``
  and the reference-style prompt builders: exactly equal outputs.
* The whole method on tiny-llama3 (JAX weights through ``params_from_jax``,
  float32) against ``TPUBackend`` with the same seeds and 32-token
  budgets: every phase's generated text and the winner equal.  Random
  weights cannot emit the ``<answer>`` envelope, so one case runs with the
  method's ``pin_budget`` fallbacks (raw text as candidate and critique,
  identity ranking) to drive every phase, and one with the verbatim
  scenario-1 keys, where the draft phase retries and returns the error
  sentinel.  Every draw of the port's decodes (sampled: logits /
  temperature + Gumbel noise; greedy: logits) is checked for a margin
  > 1e-3 between its top two scores, so no comparison rests on a near-tie.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.methods import prompts_reference as jprompts
from consensus_tpu.methods.habermas import HabermasMachineGenerator as JaxHabermas
from consensus_tpu.social_choice import parsing as jparsing
from consensus_tpu.social_choice import schulze as jschulze
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.methods import prompts_reference as tprompts
from consensus_tpu_torch.methods.habermas import HabermasMachineGenerator
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import forward
from consensus_tpu_torch.social_choice import parsing as tparsing
from consensus_tpu_torch.social_choice import schulze as tschulze
from consensus_tpu_torch.utils import threefry

torch.set_num_threads(1)

TIE_MARGIN = 1e-3
MODEL = "tiny-llama3"
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
ISSUE = "Should the city add bike lanes?"


# ---------------------------------------------------------------------------
# Schulze
# ---------------------------------------------------------------------------


def _ballots(rng, n_agents, n_candidates):
    ballots = {}
    for a in range(n_agents):
        if rng.random() < 0.15:
            ballots[f"a{a}"] = None  # a failed ranking
        else:
            # Few distinct levels -> frequent ties.
            ballots[f"a{a}"] = rng.integers(0, max(1, n_candidates - 1), n_candidates).astype(np.int32)
    return ballots


@pytest.mark.parametrize("method", ["random", "none"])
def test_aggregate_schulze_matches_jax(method):
    for seed in range(120):
        rng = np.random.default_rng(seed)
        n_agents, n_candidates = int(rng.integers(1, 8)), int(rng.integers(1, 7))
        ballots = _ballots(rng, n_agents, n_candidates)
        kwargs = dict(num_candidates=n_candidates, seed=seed, tie_breaking_method=method)
        expect = jschulze.aggregate_schulze(ballots, **kwargs)
        got = tschulze.aggregate_schulze(ballots, **kwargs)
        if expect is None:
            assert got is None, seed
        else:
            np.testing.assert_array_equal(got, expect)
        rows = [b for b in ballots.values() if b is not None]
        if rows:
            matrix = np.stack(rows)
            np.testing.assert_array_equal(
                tschulze.compute_pairwise_defeats(matrix), jschulze.compute_pairwise_defeats(matrix)
            )
            defeats = jschulze.compute_pairwise_defeats(matrix)
            np.testing.assert_array_equal(
                tschulze.compute_strongest_paths(defeats), jschulze.compute_strongest_paths(defeats)
            )


# ---------------------------------------------------------------------------
# Parsing and prompts
# ---------------------------------------------------------------------------

_RESPONSES = [
    "<answer>Explanation\n<sep>\nA > B > C</answer>",
    "Explanation\nA > B > C",
    "<answer>Explanation\n<sep>\nB>A=D>C</answer>",
    "Explanation\nB>A=D>C",
    "<answer>Explanation\n<sep>\nB<A=D>C</answer>",
    "Final ranking: B>A=D>C",
    "<answer>Explanation\n<sep>\nA=B=C=D</answer>",
    "<answer>Explanation\n<sep>\nB>A>B</answer>",
    "<answer>Explanation\n<sep>\nA>C</answer>",
    "<answer>reasoning here\n<sep>\nWe should invest.</answer>",
    "<answer>reasoning\n<sep>\nWe should invest more.",
    "<answer>r<sep>short</answer>",
    "Explanation\n  A  =  B  >  C",
    "Explanation\nA > B < C > D",
    "",
]
_ARROWS = [
    "A>B>C", "A=B>C>D", "A>B=C=D>E", "A=B=C", "A<B>C", "A>>B>C", "A>B>A", "A>B=B>C",
    "A>B>C>B", "A>>B", "A>B>>C", "A=>B", "A>B>", ">A>B", "A=B=>C", "A>B=", "A=>B>C",
    "A>C", "A>B>C>D", "", "B>A=D>C", "A=B=C=D", "A",
]


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a is not None and b is not None and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("text", _RESPONSES)
def test_response_parsers_match_jax(text):
    assert tparsing.check_response_format(text) == jparsing.check_response_format(text)
    assert tparsing.extract_statement(text) == jparsing.extract_statement(text)
    assert tparsing.extract_arrow_ranking(text) == jparsing.extract_arrow_ranking(text)
    for n in (2, 3, 4, 5):
        assert _same(
            tparsing.process_ranking_response(text, n), jparsing.process_ranking_response(text, n)
        )


@pytest.mark.parametrize("arrow", _ARROWS)
def test_arrow_parsers_match_jax(arrow):
    for n in range(0, 6):
        assert tparsing.check_arrow_format(arrow, n) == jparsing.check_arrow_format(arrow, n)
        assert _same(tparsing.parse_arrow_ranking(arrow, n), jparsing.parse_arrow_ranking(arrow, n))


def test_reference_prompts_match_jax():
    statements = ["Build lanes.", '"Cars first."', "Only wide streets."]
    opinions = list(OPINIONS.values())
    assert tprompts.initial_prompt(ISSUE, opinions) == jprompts.initial_prompt(ISSUE, opinions)
    assert tprompts.ranking_prompt(ISSUE, opinions[0], statements) == jprompts.ranking_prompt(
        ISSUE, opinions[0], statements
    )
    assert tprompts.critique_prompt(ISSUE, opinions[1], statements[0]) == jprompts.critique_prompt(
        ISSUE, opinions[1], statements[0]
    )
    ops = {str(i): op for i, op in enumerate(opinions)}
    crits = {"0": "Too vague.", "1": None, "2": "Fine."}
    assert tprompts.revision_prompt(ISSUE, ops, statements[0], crits) == jprompts.revision_prompt(
        ISSUE, ops, statements[0], crits
    )


# ---------------------------------------------------------------------------
# The whole method
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _backends():
    kw = dict(model=MODEL, dtype="float32", max_context=256)
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(params=params, device="cpu", **kw)
    return ref, port


class _Recorder:
    """Records every ``_generate_batch`` call of a generator instance:
    (prompts, seeds, temperature, responses)."""

    def __init__(self, generator):
        self.calls = []
        original = generator._generate_batch

        def recording(prompts, seeds, temperature):
            responses = original(prompts, seeds, temperature)
            self.calls.append((list(prompts), list(seeds), temperature, list(responses)))
            return responses

        generator._generate_batch = recording


def _draw_margins(port, prompt, seed, temperature, max_tokens):
    """Top-1 minus top-2 score at every draw the port made for one request,
    re-run as one full forward over prompt + output: logits (greedy) or
    logits / temperature + the row's Gumbel noise (key = fold of
    ("generate", seed), split once a step)."""
    from consensus_tpu_torch.backends.base import GenerationRequest

    request = GenerationRequest(
        user_prompt=prompt, max_tokens=max_tokens, temperature=temperature, seed=seed, chat=True
    )
    result = port.generate([request])[0]
    ids = port.tokenizer.encode(port._render_prompt(request), add_bos=True)[-port.max_context :]
    n_draws = min(len(result.token_ids) + 1, max_tokens)
    stream = ids + list(result.token_ids)
    tokens = torch.tensor([stream], dtype=torch.int32)
    valid = torch.ones_like(tokens, dtype=torch.bool)
    positions = torch.arange(len(stream), dtype=torch.int32)[None]
    logits, _ = forward(port.params, port.config, tokens, positions, valid)
    key = port._fold_seed("generate", seed)
    margins = []
    for step in range(n_draws):
        row = logits[0, len(ids) - 1 + step]
        key, sub = threefry.split(key)
        scores = row if temperature <= 0 else row / temperature + threefry.gumbel(sub, row.shape)
        top2 = torch.topk(scores, 2).values
        margins.append(float(top2[0] - top2[1]))
    return result.text, np.asarray(margins)


@pytest.mark.parametrize(
    "config",
    [
        {"num_candidates": 3, "num_rounds": 1, "num_retries_on_error": 1, "pin_budget": True, "seed": 7},
        {"num_candidates": 4, "num_rounds": 1, "num_retries": 2, "seed": 3},
    ],
    ids=["every-phase", "scenario-1-keys"],
)
def test_habermas_matches_jax(config):
    ref, port = _backends()
    config = dict(config, max_tokens=32)
    jax_gen = JaxHabermas(ref, dict(config))
    port_gen = get_method_generator("habermas_machine", port, dict(config))
    assert isinstance(port_gen, HabermasMachineGenerator)
    jrec, trec = _Recorder(jax_gen), _Recorder(port_gen)
    expect = jax_gen.generate_statement(ISSUE, OPINIONS)
    got = port_gen.generate_statement(ISSUE, OPINIONS)

    # Every draw of the port's decodes is clear of a near-tie, and the
    # batched decode gave each request the text it gives alone.
    for prompts, seeds, temperature, responses in trec.calls:
        for prompt, seed, response in zip(prompts, seeds, responses):
            text, margins = _draw_margins(port, prompt, seed, temperature, 32)
            assert text == response
            assert margins.min() > TIE_MARGIN, ("near-tie draw", seed, margins.min())
    assert [c[:3] for c in trec.calls] == [c[:3] for c in jrec.calls]
    for (_, _, _, t_resp), (_, _, _, j_resp) in zip(trec.calls, jrec.calls):
        assert t_resp == j_resp
    assert got == expect
    assert port_gen.candidate_statements == jax_gen.candidate_statements
    if config.get("pin_budget"):
        # Drafts, rankings, critiques, revisions, re-ranking: every phase ran.
        assert len(trec.calls) == 5
        assert [round_data.get("winner_after") for round_data in port_gen.all_round_data] == [got]
    else:
        # No draft parses: two attempts (num_retries_on_error's default 1),
        # then the error sentinel.
        assert len(trec.calls) == 2
        assert got.startswith("[ERROR")
