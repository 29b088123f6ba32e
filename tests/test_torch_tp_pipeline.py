"""tp=2 full-pipeline pin for the port: the port of ``tests/
test_tp_pipeline.py::test_tp2_pipeline_artifacts_match_tp1``.  One
north-star config (habermas + best_of_n Cartesian grids, shared scoring)
at test scale on tiny-gemma2 runs through ``run_pipeline`` at tp=2 and at
dp=2 x tp=2 (CPU entries of the plan) and every artifact CSV must agree
with the tp=1 run: results.csv statements byte-identical, metric columns
to 1e-4 relative (tp sums each layer's partials in another order than one
device's matmul, as the JAX test's psum does)."""

import pathlib

import pandas as pd
import pytest
import torch
import yaml

NORTH_STAR = pathlib.Path("configs/north_star/gemma/scenario_1/habermas_vs_best_of_n.yaml")
TP_ATOL = 1e-5
TP_RTOL = 1e-4

torch.set_num_threads(1)


def _run(tmp_path, tag: str, tp: int, dp: int) -> pathlib.Path:
    from consensus_tpu_torch.cli.run_experiment_with_eval import run_pipeline

    config = yaml.safe_load(NORTH_STAR.read_text())
    config["num_seeds"] = 2
    config["backend_options"].update(
        {"model": "tiny-gemma2", "dtype": "float32", "max_context": 256,
         "quantization": None, "tp": tp, "dp": dp}
    )
    config["models"] = {"generation_model": "tiny-gemma2",
                        "evaluation_models": ["tiny-gemma2"]}
    config["best_of_n"].update({"n": [1, 3], "max_tokens": 24})
    config["habermas_machine"].update({"num_candidates": [1, 2], "max_tokens": 48})
    config["experiment_name"] = f"tp_pipeline_{tag}"
    config["output_dir"] = str(tmp_path / tag)
    cfg_path = tmp_path / f"{tag}.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    return pathlib.Path(run_pipeline(str(cfg_path), skip_comparative_ranking=True, device="cpu"))


def _assert_artifacts_equal(run_a: pathlib.Path, run_b: pathlib.Path) -> None:
    a = pd.read_csv(run_a / "results.csv")
    b = pd.read_csv(run_b / "results.csv")
    assert a["statement"].fillna("").tolist() == b["statement"].fillna("").tolist()
    pd.testing.assert_frame_equal(a.drop(columns=["generation_time_s"]),
                                  b.drop(columns=["generation_time_s"]))
    seeds = sorted((run_a / "evaluation" / "tiny-gemma2").iterdir())
    assert seeds
    for seed_dir in seeds:
        eval_a = pd.read_csv(seed_dir / "evaluation_results.csv")
        eval_b = pd.read_csv(run_b / "evaluation" / "tiny-gemma2" / seed_dir.name
                             / "evaluation_results.csv")
        drop = [c for c in eval_a.columns if c.endswith("_time_s")]
        pd.testing.assert_frame_equal(eval_a.drop(columns=drop), eval_b.drop(columns=drop),
                                      check_exact=False, atol=TP_ATOL, rtol=TP_RTOL)
    agg = pathlib.Path("evaluation") / "improved_aggregate" / "aggregated_metrics.csv"
    agg_a, agg_b = pd.read_csv(run_a / agg), pd.read_csv(run_b / agg)
    drop = [c for c in agg_a.columns if "time" in c]
    pd.testing.assert_frame_equal(agg_a.drop(columns=drop), agg_b.drop(columns=drop),
                                  check_exact=False, atol=TP_ATOL, rtol=TP_RTOL)


@pytest.fixture(scope="module")
def tp1_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("tp1"), "tp1", tp=1, dp=1)


@pytest.mark.parametrize("tp, dp", [(2, 1), (2, 2)], ids=["tp2", "tp2_dp2"])
def test_tp2_pipeline_artifacts_match_tp1(tp1_run, tmp_path, tp, dp):
    run = _run(tmp_path, f"tp{tp}dp{dp}", tp=tp, dp=dp)
    metrics = (run / "metrics.json").read_text()
    assert f'"tp": {tp}' in metrics and f'"dp": {dp}' in metrics
    _assert_artifacts_equal(tp1_run, run)
