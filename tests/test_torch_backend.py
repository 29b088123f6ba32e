"""The slice as a whole: TorchBackend against TPUBackend on the same weights.

The reference is ``TPUBackend(..., dtype="float32", use_flash_attention=True)``
with every unported path switched off; its random weights are converted
with ``params_from_jax`` into ``TorchBackend(device="cpu")``.  Tolerances:
score logprobs and best-of-N utilities 1e-4 absolute (float32 forwards
summed in different orders; the JAX side scores best-of-N through its fused
paged path).  Greedy text must match exactly, on prompts whose greedy picks
are checked to be free of near-ties (margin > 1e-3 at every step).
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.experiment import Experiment as JaxExperiment
from consensus_tpu.methods.best_of_n import BestOfNGenerator as JaxBestOfN
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.methods.best_of_n import BestOfNGenerator
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import forward

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

MODEL = "tiny-llama3"
ATOL = 1e-4
UNPORTED_OFF = dict(
    shared_context_scoring=False, shared_trunk_generation=False,
    segmented_decode=False, kv_quant=False,
)
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
ISSUE = "Should the city add bike lanes?"


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(
        model=MODEL, dtype="float32", use_flash_attention=True, max_context=256,
        max_batch_rows=32, **UNPORTED_OFF,
    )
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(
        model=MODEL, dtype="float32", use_flash_attention=True, max_context=256,
        max_batch_rows=32, params=params, device="cpu", **UNPORTED_OFF,
    )
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


def test_score_logprobs(backends):
    ref, port = backends
    requests = [
        ScoreRequest(context="Issue: bikes", continuation="Yes, build them."),
        ScoreRequest(context="Q", continuation="no", system_prompt="Be brief."),
        ScoreRequest(context="eval", continuation="A statement.", role="user"),
        ScoreRequest(context="x" * 300, continuation="Truncated context keeps this."),
        ScoreRequest(context="raw", continuation=" text", chat=False),
    ]
    expect = ref.score(requests)
    got = port.score(requests)
    for e, g in zip(expect, got):
        assert g.tokens == e.tokens
        np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)
    assert port.call_counts["score_batches"] == 1


def _greedy_margins(port, request, result):
    """Top-1 minus top-2 logit at every emitted greedy step (port model)."""
    prompt = port.tokenizer.encode(port._render_prompt(request), add_bos=True)
    ids = prompt + list(result.token_ids)
    tokens = torch.tensor([ids], dtype=torch.int32)
    valid = torch.ones_like(tokens, dtype=torch.bool)
    positions = torch.arange(len(ids), dtype=torch.int32)[None]
    logits, _ = forward(port.params, port.config, tokens, positions, valid)
    steps = logits[0, len(prompt) - 1 : len(ids) - 1]
    top2 = torch.topk(steps, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def test_greedy_generate_same_text(backends):
    ref, port = backends
    requests = [
        GenerationRequest(user_prompt=p, max_tokens=12, temperature=0.0, seed=3)
        for p in ("Write one sentence about rivers.", "Summarize: taxes.", "Hello")
    ]
    got = port.generate(requests)
    for request, result in zip(requests, got):
        assert _greedy_margins(port, request, result).min() > 1e-3, "near-tie prompt"
    expect = ref.generate(requests)
    assert [g.text for g in got] == [e.text for e in expect]
    assert [g.finish_reason for g in got] == [e.finish_reason for e in expect]


def test_best_of_n_utility_matrix(backends):
    ref, port = backends
    candidates = ["We agree on safe streets.", "Bikes everywhere!", "Roads first, then lanes."]
    expect = JaxBestOfN(ref, {"n": 3}).score_candidates(ISSUE, OPINIONS, candidates)
    got = BestOfNGenerator(port, {"n": 3}).score_candidates(ISSUE, OPINIONS, candidates)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, expect, atol=ATOL)
    assert int(np.argmax(got.min(axis=1))) == int(np.argmax(np.asarray(expect).min(axis=1)))


def test_experiment_results_csv(backends, tmp_path):
    ref, port = backends
    config = {
        "experiment_name": "parity",
        "seed": 7,
        "num_seeds": 1,
        "scenario": {"issue": ISSUE, "agent_opinions": OPINIONS},
        "concurrent_execution": False,
        "deterministic_artifacts": True,
        "methods_to_run": ["best_of_n", "zero_shot", "predefined"],
        "best_of_n": {"n": 2, "max_tokens": 6, "temperature": 0.0},
        "zero_shot": {"max_tokens": 6, "temperature": 0.0},
        "predefined": {"predefined_statement": "A fixed statement."},
    }
    jax_frame = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=ref).run()
    port_config = dict(config, output_dir=str(tmp_path / "torch"))
    port_config.pop("concurrent_execution")
    experiment = Experiment(port_config, backend=port)
    frame = experiment.run()
    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    assert list(on_disk.columns) == list(jax_frame.columns)
    assert list(frame["method"]) == list(jax_frame["method"])
    assert list(frame["seed"]) == list(jax_frame["seed"])
    assert (frame["error_message"] == "").all()
    assert frame.loc[frame.method == "predefined", "statement"].item() == "A fixed statement."
    assert list(frame["statement"]) == list(jax_frame["statement"])


@pytest.mark.parametrize(
    "option",
    ["shared_context_scoring", "shared_trunk_generation", "segmented_decode", "kv_quant"],
)
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend(model=MODEL, device="cpu", **{option: True})


def test_unported_mesh_and_default_device():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TorchBackend(model=MODEL, device="cpu", tp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchBackend(model=MODEL)


def test_experiment_refuses_unported_keys(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Experiment({"concurrent_execution": True, "output_dir": str(tmp_path)}, device="cpu")
