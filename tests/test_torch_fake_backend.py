"""The port's FakeBackend against the JAX package's, and
``configs/examples/fake_smoke.yaml`` through both ``Experiment`` engines.

The fake backend is pure host code (blake2b hashes and numpy draws), so
the port must give the JAX package's outputs exactly: texts, logprobs,
candidate lists, embeddings and the padding/launch metrics it records.
``fake_smoke.yaml`` (every method, two seeds) with
``deterministic_artifacts`` must give byte-identical ``results.csv`` in
both packages, concurrent and sequential.
"""

import json
import pathlib

import numpy as np
import pytest
import yaml

from consensus_tpu.backends import base as jax_base
from consensus_tpu.backends.fake import FakeBackend as JaxFake
from consensus_tpu.experiment import Experiment as JaxExperiment
from consensus_tpu.obs import Registry as JaxRegistry
from consensus_tpu_torch.backends import base, get_backend
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.obs import Registry

FAKE_SMOKE = pathlib.Path(__file__).resolve().parent.parent / "configs/examples/fake_smoke.yaml"
RANKING_PROMPT = (
    "Rank the statements in Arrow notation.\nA. One view.\nB. Another.\nC. A third."
)
JUDGE_PROMPT = "Return JSON with method_ranking.\n1. [best_of_n] x\n2. [zero_shot] y"


def _generation_requests(module):
    return [
        module.GenerationRequest("Plain prompt", seed=3, max_tokens=12),
        module.GenerationRequest("Unseeded", max_tokens=40, stop=("e",)),
        module.GenerationRequest("Say <answer> please", system_prompt="Sys", seed=5),
        module.GenerationRequest(RANKING_PROMPT, seed=9, chat=False),
        module.GenerationRequest(JUDGE_PROMPT, seed=1),
        module.GenerationRequest("Give a representation score.", seed=2),
    ]


def test_generate_score_next_token_embed_match_jax():
    registry, jax_registry = Registry(), JaxRegistry()
    ours, theirs = FakeBackend(registry=registry), JaxFake(registry=jax_registry)
    got = ours.generate(_generation_requests(base))
    expect = theirs.generate(_generation_requests(jax_base))
    assert [(g.text, g.finish_reason) for g in got] == [
        (e.text, e.finish_reason) for e in expect
    ]
    scores = [("ctx", " a b c", None, True, "assistant"), ("q", "x", "sys", False, "user")]
    got = ours.score([base.ScoreRequest(*s) for s in scores])
    expect = theirs.score([jax_base.ScoreRequest(*s) for s in scores])
    assert [(g.tokens, g.logprobs) for g in got] == [(e.tokens, e.logprobs) for e in expect]
    steps = [("p", None, 4, 1.0, 7, "sample", (" we",)), ("p", "s", 3, 0.0, None, "topk", ())]
    got = ours.next_token_logprobs([base.NextTokenRequest(*s) for s in steps])
    expect = theirs.next_token_logprobs([jax_base.NextTokenRequest(*s) for s in steps])
    assert [[(c.token, c.token_id, c.logprob) for c in row] for row in got] == [
        [(c.token, c.token_id, c.logprob) for c in row] for row in expect
    ]
    texts = ["one", "two", "three"]
    np.testing.assert_array_equal(ours.embed(texts), theirs.embed(texts))
    assert ours.call_counts == theirs.call_counts
    assert ours.token_counts == theirs.token_counts
    assert registry.snapshot() == jax_registry.snapshot()
    assert get_backend("fake").deterministic_greedy is False


@pytest.mark.parametrize("concurrent", [True, False], ids=["concurrent", "sequential"])
def test_fake_smoke_results_csv_matches_jax(tmp_path, concurrent):
    config = yaml.safe_load(open(FAKE_SMOKE).read())
    config.update(deterministic_artifacts=True, concurrent_execution=concurrent)
    jax_run = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")))
    jax_run.run()
    run = Experiment(dict(config, output_dir=str(tmp_path / "torch")))
    frame = run.run()
    assert type(run.backend).__name__ == "FakeBackend"
    got = (run.run_dir / "results.csv").read_text()
    assert got == (jax_run.run_dir / "results.csv").read_text()
    assert len(frame) == 2 * 8 and (frame["error_message"] == "").all()
    # The same runs journaled, one record per row, keyed as the JAX engine keys them.
    journal = [json.loads(line) for line in (run.run_dir / "journal.jsonl").read_text().splitlines()]
    jax_journal = [
        json.loads(line) for line in (jax_run.run_dir / "journal.jsonl").read_text().splitlines()
    ]
    key = lambda r: (r["run_index"], json.dumps(r["key"], sort_keys=True))  # noqa: E731
    assert sorted(map(key, journal)) == sorted(map(key, jax_journal))
    assert len(journal) == len(frame)
    metrics = json.loads((run.run_dir / "metrics.json").read_text())
    assert metrics["schema"] == "consensus_tpu.metrics.v1"
    assert metrics["mesh"] == {"dp": 1, "tp": 1}
    families = metrics["metrics"]["families"]
    assert ("batching_flushes_total" in families) == concurrent
    assert metrics["derived"]["bucket_recompiles"] > 0
    (experiment,) = metrics["spans"]
    assert experiment["name"] == "experiment"
    assert {c["name"] for c in experiment["children"]} == {
        f"generate/{m}" for m in config["methods_to_run"]
    }
    assert "batching_" in (run.run_dir / "metrics.prom").read_text() or not concurrent
    assert set(json.loads((run.run_dir / "timing.json").read_text())) >= {"experiment"}
