"""Re-evaluate an existing run directory with different models (PyTorch
port of ``consensus_tpu/cli/post_hoc_evaluate.py``).

The phase-split artifact contract makes evaluation a separate, re-runnable
pass over ``results.csv`` + ``config.yaml``: any old run can be re-scored
with any model, plus ad-hoc statements from a text file.

The backend is the run config's (``backend: tpu`` or ``torch``: the
resident ``TorchBackend`` with the config's ``backend_options``) unless
``--backend`` names another; it runs on the card unless ``--device`` names
another device.  ``--backend fake`` re-scores with the deterministic,
hardware-free ``FakeBackend`` (it takes no model options).  In the
statements-text mode the backend is ``--backend`` (default ``torch``)
holding the first ``--evaluation-models`` entry.

Usage:
    python -m consensus_tpu_torch.cli.post_hoc_evaluate --results-dir results/run_x \\
        --evaluation-models llama3-8b [--with-judge]
    python -m consensus_tpu_torch.cli.post_hoc_evaluate --statements-text stmts.txt \\
        --issue "..." --opinions opinions.yaml --evaluation-models llama3-8b
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys
from typing import List, Optional

import pandas as pd
import yaml

from consensus_tpu_torch.aggregation import aggregate_run_dir
from consensus_tpu_torch.backends import RESIDENT, get_backend
from consensus_tpu_torch.cli.run_experiment import configure_logging
from consensus_tpu_torch.embedding import get_embedder
from consensus_tpu_torch.evaluation import StatementEvaluator

logger = logging.getLogger(__name__)


def _make_backend(name, options: dict, device: Optional[str]):
    """The resident backend gets ``options`` and ``device``; another named
    backend (``fake``) gets neither; an instance passes through."""
    if isinstance(name, str) and name not in RESIDENT:
        return get_backend(name)
    if device is not None:
        options = dict(options, device=device)
    return get_backend(name, **options)


def evaluate_run_dir(
    results_dir: str,
    evaluation_models: List[str],
    backend_name: Optional[str] = None,
    with_judge: bool = False,
    device: Optional[str] = None,
) -> None:
    """Evaluate ``results_dir/results.csv`` under each evaluation model
    (``evaluation/<model>/seed_N/``), then aggregate the run dir."""
    run_dir = pathlib.Path(results_dir)
    with open(run_dir / "config.yaml") as fh:
        config = yaml.safe_load(fh)
    backend = _make_backend(
        backend_name or config.get("backend", "torch"),
        dict(config.get("backend_options") or {}), device,
    )
    judge = backend if with_judge else None
    embedder = get_embedder((config.get("models") or {}).get("embedding_model_path"), backend)
    for model in evaluation_models:
        evaluator = StatementEvaluator(
            backend, evaluation_model=model, judge_backend=judge, embedder=embedder,
        )
        evaluator.evaluate_results_file(
            str(run_dir / "results.csv"), config=config, include_llm_judge=with_judge,
        )
        logger.info("Re-evaluated with %s", model)
    aggregate_run_dir(str(run_dir))


def evaluate_adhoc_statements(
    statements_file: str,
    issue: str,
    opinions_file: str,
    backend_name: str,
    evaluation_model: str,
    device: Optional[str] = None,
) -> pd.DataFrame:
    """Score statements from a text file (one per line) against a scenario."""
    with open(opinions_file) as fh:
        agent_opinions = yaml.safe_load(fh)
    statements = [
        line.strip()
        for line in pathlib.Path(statements_file).read_text().splitlines()
        if line.strip()
    ]
    backend = _make_backend(backend_name, {"model": evaluation_model}, device)
    evaluator = StatementEvaluator(backend, evaluation_model=evaluation_model)
    rows = []
    for statement in statements:
        metrics = evaluator.evaluate_statement(statement, issue, agent_opinions)
        rows.append({"statement": statement, **metrics})
    return pd.DataFrame(rows)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Post-hoc evaluation (PyTorch port)")
    parser.add_argument("--results-dir")
    parser.add_argument("--evaluation-models", nargs="*", default=["llama3-8b"])
    parser.add_argument("--backend", default=None)
    parser.add_argument("--with-judge", action="store_true")
    parser.add_argument("--statements-text", help="ad-hoc statements file")
    parser.add_argument("--issue", default="")
    parser.add_argument("--opinions", help="YAML {agent: opinion} file")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    configure_logging(args.quiet)
    if args.results_dir:
        evaluate_run_dir(
            args.results_dir, args.evaluation_models, args.backend, args.with_judge,
            device=args.device,
        )
        print(f"Re-evaluated: {args.results_dir}")
        return 0
    if args.statements_text:
        if not args.opinions:
            parser.error("--statements-text requires --opinions")
        frame = evaluate_adhoc_statements(
            args.statements_text, args.issue, args.opinions, args.backend or "torch",
            args.evaluation_models[0], device=args.device,
        )
        print(frame.to_string(index=False))
        return 0
    parser.error("Provide --results-dir or --statements-text")
    return 2


if __name__ == "__main__":
    sys.exit(main())
