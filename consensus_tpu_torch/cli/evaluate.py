"""Standalone evaluation CLI (PyTorch port of ``consensus_tpu/cli/evaluate.py``).

Evaluate either a run directory's ``results.csv`` or an ad-hoc
``{method: statement}`` file against a scenario config, with optional
LLM-judge scores and comparative ranking.  The evaluation model runs in a
``TorchBackend`` on the card unless ``--device cpu`` is given;
``--judge-backend resident`` judges with that same backend, and the API
judge (``openai``, the default as in the JAX package) raises
``NotImplementedError`` until it is ported.

Usage::

    python -m consensus_tpu_torch.cli.evaluate --results-file results/run/results.csv \
        --model llama3-8b
    python -m consensus_tpu_torch.cli.evaluate --config cfg.yaml \
        --statements-file statements.yaml --include-comparative-ranking \
        --judge-backend resident
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys
from typing import List, Optional

import pandas as pd
import yaml

from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.cli.run_experiment import configure_logging
from consensus_tpu_torch.evaluation import StatementEvaluator, sanitize_model_name

logger = logging.getLogger(__name__)


def _load_statements(path: str) -> dict:
    text = pathlib.Path(path).read_text()
    data = json.loads(text) if path.endswith(".json") else yaml.safe_load(text)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path} must contain a mapping of method name -> statement"
        )
    return {str(k): str(v) for k, v in data.items()}


def evaluate_statements_file(
    evaluator: StatementEvaluator,
    statements: dict,
    issue: str,
    agent_opinions: dict,
    output_dir: pathlib.Path,
    include_llm_judge: bool = False,
    include_comparative_ranking: bool = False,
) -> pd.DataFrame:
    """Ad-hoc statement evaluation (reference post_hoc_evaluate.py:488-612
    / evaluation main statements path)."""
    rows = []
    for method, statement in statements.items():
        metrics = evaluator.evaluate_statement(
            statement, issue, agent_opinions, include_llm_judge
        )
        rows.append(
            {"method": method, "statement": statement, "issue": issue, **metrics}
        )
    frame = pd.DataFrame(rows)
    output_dir.mkdir(parents=True, exist_ok=True)
    frame.to_csv(output_dir / "evaluation_results.csv", index=False)

    if include_comparative_ranking and len(statements) >= 2:
        ranking, reasoning, matrix = evaluator.evaluate_comparative_rankings(
            statements, issue, agent_opinions, seed=0
        )
        ranking.to_csv(output_dir / "ranking_results.csv", index=False)
        reasoning.to_csv(output_dir / "ranking_reasoning.csv", index=False)
        with open(output_dir / "comparative_ranking_matrix.json", "w") as fh:
            json.dump(matrix, fh, indent=2)
    return frame


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Evaluate consensus statements using various metrics"
    )
    input_group = parser.add_argument_group("Input Options")
    input_group.add_argument(
        "--results-file", help="Path to a results CSV file to evaluate"
    )
    input_group.add_argument(
        "--config",
        help="Path to a config YAML file (required if not using --results-file)",
    )
    input_group.add_argument(
        "--statements-file",
        help="Path to a YAML or JSON file with method: statement pairs",
    )

    eval_group = parser.add_argument_group("Evaluation Options")
    eval_group.add_argument(
        "--embedding-model-path", dest="embedding_model_path", default=None,
        help="local sentence-transformers dir for cosine metrics "
        "(reference: BAAI/bge-large-en-v1.5); default: LM-pooled hiddens",
    )
    eval_group.add_argument(
        "--evaluation-model", default="",
        help="Label for the evaluation model (directory naming)",
    )
    eval_group.add_argument("--backend", default=None,
                            help="Backend spec: torch (the port's only model backend)")
    eval_group.add_argument("--model", default=None,
                            help="Backend model (e.g. llama3-8b)")
    eval_group.add_argument("--device", default=None,
                            help="torch device (default: cuda)")
    eval_group.add_argument("--checkpoint", default=None)
    eval_group.add_argument("--include-llm-judge", action="store_true")
    eval_group.add_argument(
        "--llm-judge-model", default="o3",
        help='Judge model; "o3" aliases to gpt-4.1 on the openai backend',
    )
    eval_group.add_argument(
        "--judge-backend", default=None,
        help="Backend spec for the judge: resident (the evaluation backend) "
        "or openai (default; not ported yet)",
    )
    eval_group.add_argument("--include-comparative-ranking", action="store_true")

    output_group = parser.add_argument_group("Output Options")
    output_group.add_argument("--output-dir", default=None)
    output_group.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    if not args.results_file and not (args.config and args.statements_file):
        parser.error(
            "Either --results-file or both --config and --statements-file "
            "must be provided"
        )

    configure_logging(args.quiet)

    backend_options = {}
    if args.model:
        backend_options["model"] = args.model
    if args.checkpoint:
        backend_options["checkpoint"] = args.checkpoint
    if args.device:
        backend_options["device"] = args.device
    backend = get_backend(args.backend or "torch", **backend_options)

    judge_backend = None
    if args.include_llm_judge or args.include_comparative_ranking:
        if args.judge_backend == "resident":
            judge_backend = backend
        else:
            judge_backend = get_backend(
                args.judge_backend or "openai", model=args.llm_judge_model
            )

    from consensus_tpu_torch.embedding import get_embedder

    evaluator = StatementEvaluator(
        backend,
        evaluation_model=args.evaluation_model or args.model or "model",
        judge_backend=judge_backend,
        llm_judge_model=args.llm_judge_model,
        embedder=get_embedder(getattr(args, "embedding_model_path", None), backend),
    )

    if args.results_file:
        output_dir = args.output_dir
        frames = evaluator.evaluate_results_file(
            args.results_file,
            output_dir=output_dir,
            include_llm_judge=args.include_llm_judge,
        )
        print(
            f"Evaluated {sum(len(f) for f in frames.values())} statements "
            f"across {len(frames)} seeds "
            f"(model dir: {sanitize_model_name(evaluator.evaluation_model)})"
        )
        return 0

    with open(args.config) as fh:
        config = yaml.safe_load(fh)
    scenario = config.get("scenario", {})
    statements = _load_statements(args.statements_file)
    output_dir = pathlib.Path(args.output_dir or "results/adhoc_evaluation")
    frame = evaluate_statements_file(
        evaluator,
        statements,
        scenario.get("issue", ""),
        dict(scenario.get("agent_opinions", {})),
        output_dir,
        include_llm_judge=args.include_llm_judge,
        include_comparative_ranking=args.include_comparative_ranking,
    )
    print(frame[["method", "egalitarian_welfare_perplexity"]].to_string(index=False))
    print(f"Wrote {output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
