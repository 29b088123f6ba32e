"""The port's evaluation layer against the JAX package's, same weights.

``TPUBackend`` and ``TorchBackend(device="cpu")`` share tiny-model weights
(float32, JAX's ``init_params`` through ``params_from_jax``), with the
flash-attention path on (the JAX Pallas kernel in interpret mode, the
port's plain version on the CPU).  Tolerances: ``embed`` 1e-5 absolute;
``StatementEvaluator`` utilities and welfare columns 1e-4 absolute, and
the perplexity family, exp(-logprob) of logprobs near -5.6 (values ~270,
sums ~550), 1e-4 absolute plus 1e-5 relative;
aggregation frames identical (run on one shared set of evaluation files);
comparative rankings identical given the same judge responses.
"""

import functools
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from consensus_tpu.aggregation import aggregate_run_dir as jax_aggregate
from consensus_tpu.aggregation import aggregate_run_dir_basic as jax_aggregate_basic
from consensus_tpu.backends.base import GenerationResult as JaxResult
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.embedding import get_embedder as jax_get_embedder
from consensus_tpu.evaluation import StatementEvaluator as JaxEvaluator
from consensus_tpu.utils import identifiers as jids
from consensus_tpu_torch import aggregation, evaluation
from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.backends.base import GenerationResult
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.cli import evaluate as evaluate_cli
from consensus_tpu_torch.cli import run_experiment_with_eval
from consensus_tpu_torch.embedding import LMPoolEmbedder, get_embedder
from consensus_tpu_torch.evaluation import StatementEvaluator
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.utils import identifiers as tids

torch.set_num_threads(1)

ATOL = 1e-4
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
ISSUE = "Should the city add bike lanes?"
RESULTS = pd.DataFrame(
    {
        "method": ["best_of_n", "habermas_machine", "predefined", "zero_shot", "best_of_n"],
        "statement": [
            "We agree on safe streets for everyone.",
            "Build lanes where the streets are wide.",
            "Bike lanes where streets are wide enough.",
            "[ERROR: failed]",
            "Roads first, then lanes.",
        ],
        "generation_time_s": [1.0, 2.0, 0.0, 0.5, 1.0],
        "seed": [42, 42, 42, 42, 43],
        "error_message": ["", "", "", "", ""],
        "evaluation_status": ["pending"] * 5,
        "param_n": [4.0, None, None, None, 4.0],
        "param_num_candidates": [None, 4.0, None, None, None],
    }
)


@functools.lru_cache(maxsize=None)
def _backends(model):
    kw = dict(model=model, dtype="float32", max_context=128, use_flash_attention=True, max_batch_rows=8)
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **kw)


@pytest.mark.parametrize("model", ["tiny-llama3", "tiny-gemma2"])
def test_embed_matches_jax(model):
    ref, port = _backends(model)
    texts = [f"statement {i} " * (i % 7 + 1) for i in range(11)] + ["", "x" * 300]
    expect = ref.embed(texts)
    got = port.embed(texts)
    assert got.shape == (len(texts), port.config.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:-2], axis=1), 1.0, atol=1e-5)
    assert port.call_counts["embed"] >= len(texts)
    assert port.embed([]).shape == (0, port.config.d_model)


def _write_run(tmp_path, name="run"):
    run_dir = tmp_path / name
    run_dir.mkdir()
    RESULTS.to_csv(run_dir / "results.csv", index=False)
    config = {"scenario": {"issue": ISSUE, "agent_opinions": OPINIONS}}
    (run_dir / "config.yaml").write_text(yaml.safe_dump(config))
    return run_dir


_UTILITY_PREFIXES = (
    "cosine_similarity_", "utility_", "avg_logprob_", "egalitarian_", "utilitarian_", "log_nash_",
)


@pytest.mark.parametrize("matrix_scoring", [True, False], ids=["matrix", "per-call"])
def test_evaluate_results_file_matches_jax(tmp_path, matrix_scoring):
    ref, port = _backends("tiny-llama3")
    jdir, tdir = _write_run(tmp_path, "jax"), _write_run(tmp_path, "torch")
    expect = JaxEvaluator(
        ref, evaluation_model="tiny-llama3", judge_backend=ref, matrix_scoring=matrix_scoring
    ).evaluate_results_file(str(jdir / "results.csv"), include_llm_judge=True)
    got = StatementEvaluator(
        port, evaluation_model="tiny-llama3", judge_backend=port, matrix_scoring=matrix_scoring
    ).evaluate_results_file(str(tdir / "results.csv"), include_llm_judge=True)
    assert sorted(got) == sorted(expect) == [42, 43]
    for seed in got:
        g, e = got[seed], expect[seed]
        assert list(g.columns) == list(e.columns)
        assert len(g) == len(e) == (3 if seed == 42 else 1)  # the [ERROR row is skipped
        for column in g.columns:
            if column == "evaluation_time_s":
                continue
            if column.startswith(_UTILITY_PREFIXES) or "perplexity" in column or "judge" in column:
                rtol = 1e-5 if "perplexity" in column else 0
                np.testing.assert_allclose(
                    g[column].astype(float), e[column].astype(float), atol=ATOL, rtol=rtol,
                    err_msg=column,
                )
            else:
                pd.testing.assert_series_equal(g[column], e[column], check_dtype=False)
    for seed_index in (0, 1):
        a = pd.read_csv(tdir / "evaluation" / "tiny-llama3" / f"seed_{seed_index}" / "evaluation_results.csv")
        b = pd.read_csv(jdir / "evaluation" / "tiny-llama3" / f"seed_{seed_index}" / "evaluation_results.csv")
        assert list(a.columns) == list(b.columns)
        assert np.isfinite(a["egalitarian_welfare_perplexity"]).all()
        assert (tdir / "evaluation" / "tiny-llama3" / f"seed_{seed_index}" / "evaluation_config.yaml").exists()


def test_welfare_triplet_conventions():
    utilities = np.asarray([0.5, 2.0, 0.0])
    assert evaluation._welfare_triplet(utilities) == (
        0.0, 2.5, float(np.log(0.5) + np.log(2.0) + np.log(1e-9))
    )
    metrics = StatementEvaluator(None, embedder=object())._assemble_metrics(
        [("a", ""), ("b", "")], np.asarray([1.0, 0.0]), np.eye(2),
        [(-1.0, 0.4), (-3.0, 0.1)], [5.0, None],
    )
    # Egalitarian perplexity is the MAX (the worst-off agent).
    assert metrics["egalitarian_welfare_perplexity"] == pytest.approx(np.exp(3.0))
    assert metrics["egalitarian_welfare_judge_score"] == 5.0


class _CannedJudge:
    """A judge backend that answers from a fixed list (both packages)."""

    name = "canned"

    def __init__(self, texts, result_cls):
        self.texts, self.result_cls = texts, result_cls

    def generate(self, requests):
        return [self.result_cls(text=t, token_ids=(), finish_reason="stop") for t in self.texts[: len(requests)]]


def test_comparative_rankings_match_jax():
    statements = {
        "best_of_n (n=4)": "We agree on safe streets.",
        "habermas_machine (num_candidates=4)": "Lanes on wide streets.",
        "predefined": "Bike lanes where streets are wide enough.",
    }
    texts = [
        '{"reasoning": "r1", "method_ranking": {"best_of_n (n=4)": 2, '
        '"habermas_machine (num_candidates=4)": 1, "predefined": 3}}',
        'noise {"reasoning": "r2", "ranking": [3, 1, 2]} tail',  # reconstructed
        "not json at all",
    ]
    expect = JaxEvaluator(None, judge_backend=_CannedJudge(texts, JaxResult), embedder=object())
    got = StatementEvaluator(None, judge_backend=_CannedJudge(texts, GenerationResult), embedder=object())
    e_frame, e_reason, e_matrix = expect.evaluate_comparative_rankings(statements, ISSUE, OPINIONS, seed=42)
    g_frame, g_reason, g_matrix = got.evaluate_comparative_rankings(statements, ISSUE, OPINIONS, seed=42)
    pd.testing.assert_frame_equal(g_frame, e_frame)
    pd.testing.assert_frame_equal(g_reason, e_reason)
    e_matrix.pop("comparative_ranking_time_s")
    g_matrix.pop("comparative_ranking_time_s")
    assert g_matrix == e_matrix
    assert list(g_frame["rank_Agent 1"]) == [2, 1, 3]
    assert list(g_frame["rank_Agent 2"]) == [2, 3, 1]  # from the raw ranking array
    assert list(g_frame["is_maximin_best"]) == [1, 0, 0]


def test_aggregate_run_dir_matches_jax(tmp_path):
    """Both aggregators over one run directory's evaluation files (two
    models, two seeds, judge rankings): identical frames and files."""
    run_dir = tmp_path / "run"
    rng = np.random.default_rng(0)
    for model in ("gemma2-9b", "llama3-8b"):
        for seed_index, seed in enumerate((42, 43)):
            rows = []
            for method, key in (("best_of_n", "best_of_n (n=4)"), ("predefined", "predefined")):
                row = {
                    "method": method, "statement": "s", "method_with_params": f"{key} [seed={seed}]",
                    "seed": seed, "param_n": 4 if method == "best_of_n" else None,
                }
                for name in OPINIONS:
                    row[f"cosine_similarity_{name}"] = rng.random()
                    row[f"perplexity_{name}"] = 100 + rng.random()
                row["egalitarian_welfare_perplexity"] = max(row[f"perplexity_{n}"] for n in OPINIONS)
                row["utilitarian_welfare_cosine"] = rng.random()
                rows.append(row)
            out = run_dir / "evaluation" / model / f"seed_{seed_index}"
            out.mkdir(parents=True)
            pd.DataFrame(rows).to_csv(out / "evaluation_results.csv", index=False)
    for seed_index, seed in enumerate((42, 43)):
        out = run_dir / "evaluation" / "llm_judge" / f"seed_{seed_index}"
        out.mkdir(parents=True)
        pd.DataFrame(
            {
                "method": ["best_of_n", "predefined"], "seed": [seed, seed],
                "method_with_params": ["best_of_n (n=4)", "predefined"],
                "min_rank": [1, 1], "max_rank": [2, 2], "avg_rank": [1.4, 1.6],
                "rank_Agent 1": [1, 2],
            }
        ).to_csv(out / "ranking_results.csv", index=False)
    copy = tmp_path / "copy"
    shutil.copytree(run_dir, copy)
    expect = jax_aggregate(str(run_dir))
    got = aggregation.aggregate_run_dir(str(copy))
    pd.testing.assert_frame_equal(got, expect)
    assert "gemma2-9b_egalitarian_welfare_perplexity_mean" in got.columns
    assert "avg_rank_mean" in got.columns
    for name in ("aggregated_metrics.csv", "aggregated_metrics_raw.csv"):
        a = (copy / "evaluation" / "improved_aggregate" / name).read_text()
        assert a == (run_dir / "evaluation" / "improved_aggregate" / name).read_text()
    pd.testing.assert_frame_equal(
        aggregation.aggregate_run_dir_basic(str(copy)), jax_aggregate_basic(str(run_dir))
    )
    assert aggregation.aggregate_run_dir(str(tmp_path / "missing")) is None


@pytest.mark.parametrize(
    "key",
    ["best_of_n (n=10) [seed=42]", "habermas_machine (num_candidates=4, num_rounds=1)", "predefined", ""],
)
def test_identifiers_match_jax(key):
    assert tids.parse_method_identifier(key) == jids.parse_method_identifier(key)
    assert tids.normalize_method_name(key) == jids.normalize_method_name(key)
    params = {"param_n": 4.0, "param_beta": 1.0, "num_rounds": 2, "temperature": None}
    assert tids.create_method_identifier("m", params, True, 7) == jids.create_method_identifier("m", params, True, 7)


def test_embedder_selection(tmp_path):
    ref, port = _backends("tiny-llama3")
    assert isinstance(get_embedder(None, port), LMPoolEmbedder)
    assert get_embedder("lm", port).name == "lm-pool:tiny-llama3"
    with pytest.raises(ValueError, match="not a directory"):
        get_embedder(str(tmp_path / "absent"), port)
    with pytest.raises(ValueError, match="not a directory") as jax_error:
        jax_get_embedder(str(tmp_path / "absent"), ref)
    assert "sentence-transformers" in str(jax_error.value)


def test_unported_judges_raise():
    """The API judges are ported: ``openai`` (o3 -> gpt-4.1) and ``api``
    build with no client here, and the comparative ranking through them
    degrades to the same frames and matrix as through the JAX package's."""
    from consensus_tpu.backends import get_backend as jax_get_backend

    statements = {"best_of_n (n=4)": "We agree on safe streets.", "predefined": "Bike lanes."}
    for spec in ({"name": "openai", "model": "o3"}, {"name": "api"}):
        judge, jax_judge = get_backend(dict(spec)), jax_get_backend(dict(spec))
        assert type(judge).__name__ == type(jax_judge).__name__
        assert getattr(judge, "model") == getattr(jax_judge, "model")
        got = StatementEvaluator(None, judge_backend=judge, embedder=object())
        expect = JaxEvaluator(None, judge_backend=jax_judge, embedder=object())
        g_frame, g_reason, g_matrix = got.evaluate_comparative_rankings(
            statements, ISSUE, OPINIONS, seed=42)
        e_frame, e_reason, e_matrix = expect.evaluate_comparative_rankings(
            statements, ISSUE, OPINIONS, seed=42)
        pd.testing.assert_frame_equal(g_frame, e_frame)
        pd.testing.assert_frame_equal(g_reason, e_reason)
        g_matrix.pop("comparative_ranking_time_s")
        e_matrix.pop("comparative_ranking_time_s")
        assert g_matrix == e_matrix


_PIPELINE_CONFIG = {
    "experiment_name": "tiny_eval",
    "seed": 42,
    "num_seeds": 1,
    "backend": "torch",
    "backend_options": {
        "model": "tiny-llama3", "dtype": "float32", "max_context": 256,
        "use_flash_attention": True, "max_batch_rows": 32, "shared_context_scoring": True,
    },
    "models": {"generation_model": "tiny-llama3", "evaluation_models": ["tiny-gemma2", "tiny-llama3"]},
    "evaluation_backends": {
        "tiny-gemma2": {"name": "torch", "model": "tiny-gemma2", "dtype": "float32", "max_context": 256},
    },
    "judge_backend": "resident",
    "scenario": {"issue": ISSUE, "agent_opinions": OPINIONS},
    "methods_to_run": ["best_of_n", "habermas_machine", "predefined"],
    "best_of_n": {"n": 2, "max_tokens": 16, "temperature": 1.0},
    "habermas_machine": {"num_candidates": 2, "num_rounds": 1, "num_retries": 2, "max_tokens": 16},
    "predefined": {"predefined_statement": "Bike lanes where streets are wide enough."},
}


def test_run_pipeline_on_cpu_writes_the_file_tree(tmp_path):
    config = dict(_PIPELINE_CONFIG, output_dir=str(tmp_path / "runs"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    assert run_experiment_with_eval.main(["-c", str(path), "--device", "cpu", "--quiet"]) == 0
    (run_dir,) = list((tmp_path / "runs").iterdir())
    results = pd.read_csv(run_dir / "results.csv", keep_default_na=False)
    assert list(results["method"]) == ["best_of_n", "habermas_machine", "predefined"]
    assert (results["error_message"] == "").all()
    for model in ("tiny-gemma2", "tiny-llama3"):
        frame = pd.read_csv(run_dir / "evaluation" / model / "seed_0" / "evaluation_results.csv")
        assert "judge_score_Agent 1" in frame.columns
        assert np.isfinite(frame["egalitarian_welfare_perplexity"]).all()
    judge = run_dir / "evaluation" / "llm_judge" / "seed_0"
    for name in ("ranking_results.csv", "ranking_reasoning.csv", "comparative_ranking_matrix.json"):
        assert (judge / name).exists(), name
    assert (run_dir / "evaluation" / "improved_aggregate" / "aggregated_metrics.csv").exists()
    # The evaluation CLI on the same run, the resident backend judging.
    out = tmp_path / "cli_eval"
    assert evaluate_cli.main([
        "--results-file", str(run_dir / "results.csv"), "--model", "tiny-llama3",
        "--device", "cpu", "--output-dir", str(out), "--quiet",
    ]) == 0
    assert (out / "tiny-llama3" / "seed_0" / "evaluation_results.csv").exists()
