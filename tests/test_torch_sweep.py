"""The port's sweep runner and re-scoring CLI against the JAX package's.

``find_config_files`` must list the same configs as the JAX runner over
the repo's trees.  ``run_sweep.main --device cpu`` runs a tmp tree holding
``configs/main_body/scenario_1.yaml`` and
``configs/appendix/llama/scenario_1/beam_search.yaml``, each left with
``backend: tpu`` and changed only by the tiny-model override (tiny-llama3,
float32, no quantization: the precision of the CPU parity tests),
``num_seeds: 1`` and short token budgets.  The port builds its backend from
the config; its random weights are JAX's (``init_params`` at
``PRNGKey(0)`` through ``params_from_jax``, patched in where the port would
draw its own).  Its rows must equal the JAX ``Experiment``'s on the same
configs (run sequentially: the JAX engine's co-batching is not ported);
``post_hoc_evaluate`` on copies of the port's run dir must give the JAX
CLI's evaluation files, utilities within 1e-4 absolute (the perplexity
family also 1e-5 relative), as ``tests/test_torch_evaluation.py`` holds
the evaluator.
"""

import functools
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.cli import post_hoc_evaluate as jax_post_hoc
from consensus_tpu.cli import run_sweep as jax_sweep
from consensus_tpu.experiment import Experiment as JaxExperiment
from consensus_tpu_torch.backends import torch_backend
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.cli import post_hoc_evaluate, run_sweep
from consensus_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ROOT = run_sweep.__file__.rsplit("/consensus_tpu_torch/", 1)[0]
MAIN_BODY = f"{ROOT}/configs/main_body/scenario_1.yaml"
APPENDIX = f"{ROOT}/configs/appendix/llama/scenario_1/beam_search.yaml"
TINY = {"model": "tiny-llama3", "dtype": "float32", "quantization": None}
BUDGETS = {"best_of_n": 8, "beam_search": 6, "finite_lookahead": 4, "habermas_machine": 8}


@functools.lru_cache(maxsize=None)
def _jax_backend(options):
    return TPUBackend(**dict(options))


def _tiny_config(path, output_dir):
    config = yaml.safe_load(open(path).read())
    config["backend_options"].update(TINY)
    config["num_seeds"] = 1
    config["output_dir"] = str(output_dir)
    for method, budget in BUDGETS.items():
        if method in config:
            config[method]["max_tokens"] = budget
    if "finite_lookahead" in config:
        config["finite_lookahead"]["max_depth"] = 2
    return config


@pytest.mark.parametrize("root", ["configs/appendix", "configs/north_star"])
@pytest.mark.parametrize(
    "filters",
    [
        (None, None, None), (["llama"], None, None), (["gemma"], [2, 5], None),
        (None, [1], ["beam_search"]), (None, None, ["habermas_only", "mcts"]),
        (["llama"], [1], ["beam_search"]), (["nope"], None, None),
    ],
    ids=["all", "llama", "gemma-2-5", "s1-beam", "methods", "one", "none"],
)
def test_find_config_files_matches_jax(root, filters):
    got = run_sweep.find_config_files(f"{ROOT}/{root}", *filters)
    assert got == jax_sweep.find_config_files(f"{ROOT}/{root}", *filters)
    if filters == (None, None, None):
        assert len(got) == (40 if root.endswith("appendix") else 25)
        assert all(yaml.safe_load(p.read_text())["backend"] == "tpu" for p in got)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's sweep over the tmp tree: (tree, run dirs by config name,
    the JAX backend, the options it was built with)."""
    tmp = tmp_path_factory.mktemp("sweep")
    tree = tmp / "tree"
    out = tmp / "runs"
    layout = {
        "main_body/scenario_1/full_comparison.yaml": MAIN_BODY,
        "llama/scenario_1/beam_search.yaml": APPENDIX,
    }
    for rel, src in layout.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        config = _tiny_config(src, out / rel.split("/")[0])
        assert config["backend"] == "tpu"
        (tree / rel).write_text(yaml.safe_dump(config, sort_keys=False))
    options = tuple(sorted(config["backend_options"].items()))
    ref = _jax_backend(options)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    built = []
    mp = pytest.MonkeyPatch()
    mp.setattr(torch_backend, "init_params", lambda *a, **k: params)
    original = TorchBackend.__init__

    def init(self, *args, **kwargs):
        original(self, *args, **kwargs)
        built.append(self)

    mp.setattr(TorchBackend, "__init__", init)
    try:
        rc = run_sweep.main([
            "--configs-root", str(tree), "--device", "cpu", "--skip-comparative-ranking",
            "--quiet",
        ])
    finally:
        mp.undo()
    assert rc == 0
    # One resident backend for both configs: they name the same options.
    assert len(built) == 1 and built[0].device.type == "cpu"
    runs = {name: next((out / name).iterdir()) for name in ("main_body", "llama")}
    return tree, runs, ref, built[0]


def test_run_sweep_rows_match_jax_experiment(sweep, tmp_path):
    tree, runs, ref, _ = sweep
    for name, rel in (("main_body", "main_body/scenario_1/full_comparison.yaml"),
                      ("llama", "llama/scenario_1/beam_search.yaml")):
        config = yaml.safe_load((tree / rel).read_text())
        got = pd.read_csv(runs[name] / "results.csv", keep_default_na=False)
        jax_config = dict(config, output_dir=str(tmp_path / name), concurrent_execution=False)
        jax_run = JaxExperiment(jax_config, backend=ref)
        jax_run.run()
        expect = pd.read_csv(jax_run.run_dir / "results.csv", keep_default_na=False)
        assert list(got["method"]) == list(expect["method"]) == (
            config["methods_to_run"] if name == "main_body" else ["beam_search"] * 4
        )
        assert (got["error_message"] == "").all()
        # The same CSV but for the wall-clock column.
        assert list(got.columns) == list(expect.columns)
        pd.testing.assert_frame_equal(
            got.drop(columns="generation_time_s"), expect.drop(columns="generation_time_s")
        )
        for model in config["models"]["evaluation_models"]:
            frame = pd.read_csv(runs[name] / "evaluation" / model / "seed_0" / "evaluation_results.csv")
            # The evaluator skips empty statements and error sentinels.
            text = got["statement"].str.strip()
            scored = got[(text != "") & ~text.str.startswith("[ERROR")]
            assert list(frame["method"]) == list(scored["method"]) and len(frame) > 0
            assert np.isfinite(frame["egalitarian_welfare_perplexity"]).all()
        assert (runs[name] / "evaluation" / "improved_aggregate" / "aggregated_metrics.csv").exists()


def _copy_run(run_dir, dest):
    dest.mkdir()
    for name in ("results.csv", "config.yaml"):
        shutil.copy(run_dir / name, dest / name)
    return dest


def test_post_hoc_evaluate_matches_jax(sweep, tmp_path):
    _, runs, ref, port = sweep
    jdir = _copy_run(runs["llama"], tmp_path / "jax")
    tdir = _copy_run(runs["llama"], tmp_path / "torch")
    jax_post_hoc.evaluate_run_dir(str(jdir), ["tiny-llama3"], backend_name=ref)
    post_hoc_evaluate.evaluate_run_dir(str(tdir), ["tiny-llama3"], backend_name=port)
    rel = "evaluation/tiny-llama3/seed_0/evaluation_results.csv"
    got, expect = pd.read_csv(tdir / rel), pd.read_csv(jdir / rel)
    assert list(got.columns) == list(expect.columns) and len(got) == 4
    for column in got.columns:
        if column == "evaluation_time_s":
            continue
        if pd.api.types.is_float_dtype(expect[column]):
            rtol = 1e-5 if "perplexity" in column else 0
            np.testing.assert_allclose(got[column], expect[column], atol=1e-4, rtol=rtol,
                                       err_msg=column)
        else:
            pd.testing.assert_series_equal(got[column], expect[column], check_dtype=False)
    assert (tdir / "evaluation" / "improved_aggregate" / "aggregated_metrics.csv").exists()


def test_post_hoc_statements_text_mode(tmp_path, monkeypatch, capsys):
    statements = tmp_path / "statements.txt"
    statements.write_text("We agree on safe streets.\n\nBuild lanes where wide.\n")
    opinions = tmp_path / "opinions.yaml"
    opinions.write_text(yaml.safe_dump({"Agent 1": "More lanes.", "Agent 2": "Fewer lanes."}))
    assert post_hoc_evaluate.main([
        "--statements-text", str(statements), "--opinions", str(opinions),
        "--issue", "Bike lanes?", "--evaluation-models", "tiny-llama3", "--device", "cpu",
        "--quiet",
    ]) == 0
    assert "Build lanes where wide." in capsys.readouterr().out


@pytest.mark.parametrize(
    "flag", [["--timing-pin-budget"], ["--profile-dir", "p"], ["--resume"], ["--metrics-out", "m"]]
)
def test_unported_sweep_flags_raise(flag, tmp_path, monkeypatch):
    """The four flags are ported: on a tree with no configs each is accepted
    and the sweep reports that nothing matched (exit 1), writing nothing."""
    monkeypatch.chdir(tmp_path)
    assert run_sweep.main(["--configs-root", str(tmp_path), "--device", "cpu", "--quiet", *flag]) == 1
    assert not (tmp_path / "m").exists() and not (tmp_path / "p").exists()


def test_fake_backend_raises(tmp_path):
    """``--backend fake`` re-scores a run dir with the hardware-free fake
    backend, whatever backend the run's config names."""
    from consensus_tpu_torch.experiment import Experiment

    config = yaml.safe_load(open(f"{ROOT}/configs/examples/fake_smoke.yaml").read())
    config.update(num_seeds=1, methods_to_run=["zero_shot", "predefined"],
                  output_dir=str(tmp_path), backend="fake")
    experiment = Experiment(config)
    experiment.run()
    run = experiment.run_dir
    (run / "config.yaml").write_text(yaml.safe_dump(dict(config, backend="tpu")))
    assert post_hoc_evaluate.main(["--results-dir", str(run), "--backend", "fake",
                                   "--evaluation-models", "fake-lm", "--quiet"]) == 0
    frame = pd.read_csv(run / "evaluation" / "fake-lm" / "seed_0" / "evaluation_results.csv")
    assert list(frame["method"]) == ["zero_shot", "predefined"]
    assert run_sweep.main(["--configs-root", str(tmp_path / "none"), "--device", "cpu",
                           "--quiet"]) == 1


NORTH_STAR_MCTS = f"{ROOT}/configs/north_star/gemma/scenario_1/mcts.yaml"
TINY_GEMMA = {"model": "tiny-gemma2", "dtype": "float32", "quantization": None}
#: The north_star MCTS config's depth, cut for the CPU (the config: 50
#: simulations, 100 tokens, width 5, depth 10, wave 8, five seeds).
MCTS_CUTS = {"num_simulations": 10, "max_tokens": 3, "rollout_depth": 4}


def test_north_star_mcts_config_through_run_sweep(tmp_path):
    """``configs/north_star/gemma/scenario_1/mcts.yaml`` as ``run_sweep
    --model gemma --scenario 1 --method mcts`` finds it in a tmp tree,
    changed only by the tiny-gemma2 override, one seed and the cuts above
    (width 5 and wave 8 kept): one error-free MCTS row equal to the JAX
    ``Experiment``'s on the same config, its evaluation files and the
    aggregate."""
    config = yaml.safe_load(open(NORTH_STAR_MCTS).read())
    assert config["backend"] == "tpu" and config["methods_to_run"] == ["mcts"]
    config["backend_options"].update(TINY_GEMMA)
    config["num_seeds"] = 1
    config["output_dir"] = str(tmp_path / "runs")
    config["mcts"].update(MCTS_CUTS)
    tree = tmp_path / "tree"
    (tree / "gemma" / "scenario_1").mkdir(parents=True)
    (tree / "gemma" / "scenario_1" / "mcts.yaml").write_text(yaml.safe_dump(config, sort_keys=False))
    assert run_sweep.find_config_files(str(tree), ["gemma"], [1], ["mcts"]) == [
        tree / "gemma" / "scenario_1" / "mcts.yaml"
    ]
    ref = _jax_backend(tuple(sorted(config["backend_options"].items())))
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_backend, "init_params", lambda *a, **k: params)
        rc = run_sweep.main([
            "--configs-root", str(tree), "--model", "gemma", "--scenario", "1",
            "--method", "mcts", "--device", "cpu", "--skip-comparative-ranking", "--quiet",
        ])
    assert rc == 0
    run_dir = next((tmp_path / "runs").iterdir())
    got = pd.read_csv(run_dir / "results.csv", keep_default_na=False)
    jax_run = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=ref)
    jax_run.run()
    expect = pd.read_csv(jax_run.run_dir / "results.csv", keep_default_na=False)
    assert list(got["method"]) == ["mcts"] and (got["error_message"] == "").all()
    pd.testing.assert_frame_equal(
        got.drop(columns="generation_time_s"), expect.drop(columns="generation_time_s")
    )
    assert got["statement"].str.len().iloc[0] > 0
    frame = pd.read_csv(run_dir / "evaluation" / "gemma2-2b" / "seed_0" / "evaluation_results.csv")
    assert list(frame["method"]) == ["mcts"]
    assert np.isfinite(frame["egalitarian_welfare_perplexity"]).all()
    assert (run_dir / "evaluation" / "improved_aggregate" / "aggregated_metrics.csv").exists()
