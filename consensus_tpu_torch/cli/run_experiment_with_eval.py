"""Full pipeline CLI: generate -> judge -> evaluate -> aggregate (PyTorch
port of ``consensus_tpu/cli/run_experiment_with_eval.py``).

Phase 1 generation (``Experiment``), Phase 2a per-seed LLM-judge
comparative ranking (``evaluation/llm_judge/seed_N/{ranking_results.csv,
ranking_reasoning.csv, comparative_ranking_matrix.json}``), Phase 2b
per-(model x seed) standard evaluation (``evaluation/<model>/seed_N/``),
Phase 3 aggregation (``evaluation/improved_aggregate/``, with the basic
layout as the fallback).

The judge: ``judge_backend: resident`` (or no ``judge_backend`` key) judges
with the generation backend's own model; any other name goes through
``get_backend`` (``openai`` is the API judge of ``backends/api.py``).
``evaluation_backends: {model: {name: torch, ...options}}`` routes an
evaluation model to a backend of its own, built for its phase and freed
after it, so a second 9B model never shares the card with a third.

Every backend runs on the card unless ``--device`` names another device.
With the config's ``profile_dir`` (``run_sweep --profile-dir``) the
evaluation phases write their own ``torch.profiler`` trace under
``{profile_dir}/{run_dir name}_eval``, beside the generation phase's.

Usage: ``python -m consensus_tpu_torch.cli.run_experiment_with_eval -c config.yaml``
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import pathlib
import sys
from typing import List, Optional

import pandas as pd
import torch
import yaml

from consensus_tpu_torch.aggregation import aggregate_run_dir
from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.backends.base import Backend
from consensus_tpu_torch.cli.run_experiment import configure_logging
from consensus_tpu_torch.embedding import get_embedder
from consensus_tpu_torch.evaluation import StatementEvaluator, sanitize_model_name
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.utils.identifiers import create_method_identifier
from consensus_tpu_torch.utils.tracing import device_trace

logger = logging.getLogger(__name__)


def _free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_pipeline(
    config_path: str,
    skip_comparative_ranking: bool = False,
    skip_llm_judge: bool = False,
    llm_judge_model: str = "",
    evaluation_models: Optional[List[str]] = None,
    config_overrides: Optional[dict] = None,
    device: Optional[str] = None,
    backend: Optional[Backend] = None,
) -> str:
    """Run the four phases on ``config_path``; returns the run dir.  A
    ``backend`` given here generates (and judges, when the config says
    resident) instead of one built from the config: ``run_sweep`` shares
    one resident backend across configs that name the same options."""
    with open(config_path) as fh:
        config = yaml.safe_load(fh)
    if config_overrides:
        config.update(config_overrides)

    # ---- Phase 1: generation ------------------------------------------
    logger.info("=== Phase 1: generation ===")
    experiment = Experiment(config, backend=backend, device=device)
    results = experiment.run()
    run_dir = pathlib.Path(experiment.run_dir)
    backend = experiment.backend

    scenario = config.get("scenario", {})
    issue = scenario.get("issue", "")
    agent_opinions = dict(scenario.get("agent_opinions", {}))

    # Judge construction stays LAZY: with both judge phases skipped, a
    # configured judge backend must not pay a model load.
    _judge_cache: List = []

    def judge_backend_lazy():
        if _judge_cache:
            return _judge_cache[0]
        judge_options = dict(config.get("judge_backend_options") or {})
        if llm_judge_model:
            judge_options.setdefault("model", llm_judge_model)
        if config.get("judge_backend") == "resident":
            # The generation backend judges with its own resident model: no
            # second model load, and it still counts as a CONFIGURED judge
            # (per-agent judge scores activate in Phase 2b).
            if judge_options:
                logger.warning(
                    "judge_backend: resident ignores judge_backend_options/"
                    "--llm-judge-model (%s): the generation backend judges "
                    "with its own model",
                    judge_options,
                )
            judge = backend
        elif config.get("judge_backend"):
            if device is not None:
                judge_options.setdefault("device", device)
            judge = get_backend(config["judge_backend"], **judge_options)
        else:
            if llm_judge_model:
                logger.warning(
                    "--llm-judge-model=%s ignored: config has no judge_backend "
                    "key, so the generation backend judges with its own model",
                    llm_judge_model,
                )
            judge = backend
        _judge_cache.append(judge)
        return judge

    # A dedicated evaluation embedder when configured (models.embedding_model_path
    # or EVAL_EMBEDDER), else the LM-pooled hiddens of each evaluation backend.
    embedding_path = (config.get("models") or {}).get("embedding_model_path")
    embedder = get_embedder(embedding_path, backend)

    # --profile-dir (the config's profile_dir): Phase 1 traced its own
    # window inside Experiment.run; the scoring/evaluation phases get a
    # separate trace window so the two profiles load side by side.
    profile_dir = config.get("profile_dir") or None
    eval_profile_dir = (
        str(pathlib.Path(profile_dir) / f"{run_dir.name}_eval") if profile_dir else None
    )
    with device_trace(eval_profile_dir):
        # ---- Phase 2a: per-seed comparative ranking -----------------------
        if not skip_comparative_ranking:
            logger.info("=== Phase 2a: LLM-judge comparative ranking ===")
            evaluator = StatementEvaluator(
                backend,
                judge_backend=judge_backend_lazy(),
                llm_judge_model=llm_judge_model,
                embedder=embedder,
            )
            for seed_index, seed in enumerate(sorted(results["seed"].unique())):
                subset = results[
                    (results["seed"] == seed)
                    & (results["statement"].astype(str).str.strip() != "")
                    & ~results["statement"].astype(str).str.lstrip().str.startswith("[ERROR")
                    & (results["error_message"].fillna("").astype(str).str.strip() == "")
                ]
                method_statements = {}
                for _, row in subset.iterrows():
                    params = {
                        k: row[k]
                        for k in subset.columns
                        if k.startswith("param_") and pd.notna(row[k])
                    }
                    key = create_method_identifier(row["method"], params)
                    method_statements[key] = row["statement"]
                if len(method_statements) < 2:
                    logger.info("Seed %s: <2 statements, skipping ranking", seed)
                    continue
                ranking, reasoning, matrix = evaluator.evaluate_comparative_rankings(
                    method_statements, issue, agent_opinions, seed=int(seed)
                )
                seed_dir = run_dir / "evaluation" / "llm_judge" / f"seed_{seed_index}"
                seed_dir.mkdir(parents=True, exist_ok=True)
                ranking.to_csv(seed_dir / "ranking_results.csv", index=False)
                reasoning.to_csv(seed_dir / "ranking_reasoning.csv", index=False)
                with open(seed_dir / "comparative_ranking_matrix.json", "w") as fh:
                    json.dump(matrix, fh, indent=2)

        # ---- Phase 2b: per-(model x seed) standard evaluation -------------
        logger.info("=== Phase 2b: standard evaluation ===")
        models = evaluation_models or experiment.evaluation_models or [
            config.get("models", {}).get("generation_model", "model")
        ]
        # Optional per-model backend routing; without it every evaluation model
        # shares the generation backend (same scores under different names).
        eval_backends = config.get("evaluation_backends") or {}
        if len(models) > 1 and not eval_backends:
            logger.warning(
                "%d evaluation models share ONE resident backend -- their metrics "
                "will be identical; set config.evaluation_backends to route "
                "models to distinct backends",
                len(models),
            )
        # Per-agent judge scores run only when a judge backend is configured and
        # --skip-llm-judge was not passed.
        include_llm_judge = not skip_llm_judge and bool(config.get("judge_backend"))
        for model in models:
            own_backend = model in eval_backends
            if own_backend:
                spec = dict(eval_backends[model])
                if device is not None:
                    spec.setdefault("device", device)
                model_backend = get_backend(spec)
            else:
                model_backend = backend
            evaluator = StatementEvaluator(
                model_backend,
                evaluation_model=model,
                judge_backend=judge_backend_lazy() if include_llm_judge else None,
                llm_judge_model=llm_judge_model,
                # A path-based embedder is backend-independent: one instance.
                embedder=embedder if embedding_path else get_embedder(None, model_backend),
            )
            evaluator.evaluate_results_file(
                str(run_dir / "results.csv"),
                config=config,
                include_llm_judge=include_llm_judge,
            )
            logger.info("Evaluated with %s", sanitize_model_name(model))
            if own_backend:
                # Free this model's weights before the next phase loads its own.
                del evaluator, model_backend
                _free_device_memory()

    # ---- Phase 3: aggregation (improved, basic fallback) --------------
    logger.info("=== Phase 3: aggregation ===")
    try:
        aggregate_run_dir(str(run_dir))
    except Exception:
        logger.exception("Improved aggregation failed; running basic fallback")
        from consensus_tpu_torch.aggregation import aggregate_run_dir_basic

        aggregate_run_dir_basic(str(run_dir))
    return str(run_dir)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run experiment + evaluation (PyTorch port)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--skip-comparative-ranking", action="store_true")
    parser.add_argument(
        "--skip-llm-judge", action="store_true",
        help="skip per-agent LLM-judge scores in standard evaluation",
    )
    parser.add_argument("--llm-judge-model", default="")
    parser.add_argument("--evaluation-models", nargs="*", default=None)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    configure_logging(args.quiet)
    run_dir = run_pipeline(
        args.config,
        skip_comparative_ranking=args.skip_comparative_ranking,
        skip_llm_judge=args.skip_llm_judge,
        llm_judge_model=args.llm_judge_model,
        evaluation_models=args.evaluation_models,
        device=args.device,
    )
    print(f"Pipeline complete: {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
