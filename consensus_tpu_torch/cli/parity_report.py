"""Quality-parity A/B harness (PyTorch port of
``consensus_tpu/cli/parity_report.py``).

Re-scores the REFERENCE's own committed AAMAS statements (bundled in
``consensus_tpu_torch/data/aamas_baseline.json``, a byte-for-byte copy of
the JAX package's file: the exact texts the paper's welfare numbers were
measured on) with a local backend, aggregates egalitarian welfare exactly
as the reference does (perplexity of the worst-off agent, mean over seeds),
and reports per-cell deltas against the reference's measured aggregates.

Because the statements are FIXED, every delta isolates the scoring stack:
tokenizer + chat template + teacher-forced logprobs + welfare reduction.
With real checkpoints the north star is |delta| <= 1 %; with random weights
the report still proves the harness and records the gap honestly
(``weights`` field).

``--backend torch`` (``tpu`` is its alias, the JAX package's name) scores
with the resident ``TorchBackend`` on the card unless ``--device cpu``;
``--checkpoint`` takes an HF safetensors directory or one written by
``cli/ingest_checkpoint.py``; ``--backend fake`` needs no model.

Usage::

    python -m consensus_tpu_torch.cli.parity_report \\
        --backend torch --model gemma2-9b --checkpoint /path/to/ckpt \\
        --scenario 1 5 --sweep habermas_vs_bon --output results/parity
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from importlib import resources
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from consensus_tpu_torch.backends.base import Backend, ScoreRequest
from consensus_tpu_torch.data.aamas_scenarios import SCENARIOS
from consensus_tpu_torch.evaluation import EVAL_SYSTEM_TEMPLATE

#: evaluator-model key used when the local backend re-scores (the bundled
#: baselines keyed by the API evaluator checkpoints).
DEFAULT_BASELINE_EVALUATOR = "gemma2-9b"


def load_baseline() -> Dict[str, Any]:
    text = (
        resources.files("consensus_tpu_torch.data")
        .joinpath("aamas_baseline.json")
        .read_text()
    )
    return json.loads(text)


def _cell_key(method: str, params: Dict[str, Any]) -> tuple:
    return (method, tuple(sorted((k, float(v)) for k, v in params.items())))


def score_statements_batched(
    backend: Backend,
    statements: Sequence[str],
    issue: str,
    agent_opinions: Dict[str, str],
    embedder=None,
) -> List[Dict[str, float]]:
    """Per-statement welfare metrics with ONE score batch and ONE embed batch
    across (statements × agents): one device batch each."""
    if embedder is None:
        from consensus_tpu_torch.embedding import get_embedder

        embedder = get_embedder(None, backend)  # honors EVAL_EMBEDDER env
    agents = list(agent_opinions.items())
    requests = [
        ScoreRequest(
            context=EVAL_SYSTEM_TEMPLATE.format(issue=issue, opinion=opinion),
            continuation=statement,
            chat=True,
            role="user",
        )
        for statement in statements
        for _, opinion in agents
    ]
    results = backend.score(requests)

    vectors = embedder.embed(list(statements) + [op for _, op in agents])
    statement_vecs = vectors[: len(statements)]
    opinion_vecs = vectors[len(statements):]

    metrics = []
    n_agents = len(agents)
    for i, statement in enumerate(statements):
        row = results[i * n_agents : (i + 1) * n_agents]
        ppls = []
        for result in row:
            lps = np.asarray(result.logprobs, dtype=np.float64)
            avg_lp = float(lps.mean()) if lps.size else -10.0
            ppls.append(float(np.exp(-avg_lp)))
        cosines = opinion_vecs @ statement_vecs[i]
        metrics.append(
            {
                # Reference convention: egalitarian perplexity = MAX (worst
                # agent), egalitarian cosine = MIN (src/evaluation.py:374).
                "egalitarian_welfare_perplexity": float(np.max(ppls)),
                "egalitarian_welfare_cosine": float(np.min(cosines)),
            }
        )
    return metrics


def build_report(
    backend: Backend,
    evaluator_key: str = DEFAULT_BASELINE_EVALUATOR,
    scenarios: Optional[Sequence[int]] = None,
    sweeps: Optional[Sequence[str]] = None,
    weights: str = "random",
    baseline: Optional[Dict[str, Any]] = None,
    embedder=None,
) -> Dict[str, Any]:
    data = baseline if baseline is not None else load_baseline()
    if embedder is None:
        from consensus_tpu_torch.embedding import get_embedder

        embedder = get_embedder(None, backend)  # honors EVAL_EMBEDDER env
    # The reference embeds with BAAI/bge-large-en-v1.5 (src/utils.py:376-407);
    # cosine-family numbers are baseline-comparable ONLY under that encoder.
    cosine_comparable = "bge-large-en-v1.5" in embedder.name
    cells: List[Dict[str, Any]] = []

    for run in data["runs"]:
        if scenarios and run["scenario"] not in scenarios:
            continue
        if sweeps and run["sweep"] not in sweeps:
            continue
        scenario = SCENARIOS[run["scenario"]]
        issue = scenario["issue"]
        opinions = scenario["agent_opinions"]

        # Group this run's statements by sweep cell.
        grouped: Dict[tuple, List[str]] = {}
        labels: Dict[tuple, Dict[str, Any]] = {}
        for row in run["rows"]:
            key = _cell_key(row["method"], row["params"])
            grouped.setdefault(key, []).append(row["statement"])
            labels[key] = {"method": row["method"], "params": row["params"]}

        flat_statements = [s for key in grouped for s in grouped[key]]
        start = time.perf_counter()
        flat_metrics = score_statements_batched(
            backend, flat_statements, issue, opinions, embedder=embedder
        )
        elapsed = time.perf_counter() - start

        baselines = {
            _cell_key(a["method"], a["params"]): a for a in run["aggregate"]
        }
        cursor = 0
        for key, statements in grouped.items():
            cell_metrics = flat_metrics[cursor : cursor + len(statements)]
            cursor += len(statements)
            local_ppl = float(
                np.mean([m["egalitarian_welfare_perplexity"] for m in cell_metrics])
            )
            local_cos = float(
                np.mean([m["egalitarian_welfare_cosine"] for m in cell_metrics])
            )
            ref = baselines.get(key, {})
            ref_ppl = ref.get("egalitarian_welfare_perplexity_mean", {}).get(
                evaluator_key
            )
            ref_cos = ref.get("egalitarian_welfare_cosine_mean", {}).get(evaluator_key)
            cell = {
                "scenario": run["scenario"],
                "sweep": run["sweep"],
                **labels[key],
                "n_statements": len(statements),
                "local_egalitarian_perplexity": round(local_ppl, 4),
                "baseline_egalitarian_perplexity": ref_ppl,
                "local_egalitarian_cosine": round(local_cos, 4),
                "baseline_egalitarian_cosine": ref_cos,
                "scoring_time_s": round(elapsed, 2),
            }
            if ref_ppl:
                cell["perplexity_delta_pct"] = round(
                    100.0 * (local_ppl - ref_ppl) / ref_ppl, 2
                )
            cells.append(cell)

    deltas = [
        abs(c["perplexity_delta_pct"]) for c in cells if "perplexity_delta_pct" in c
    ]
    return {
        "backend": getattr(backend, "name", "unknown"),
        "model": getattr(backend, "model_name", ""),
        "weights": weights,
        "embedder": embedder.name,
        "cosine_baseline_comparable": cosine_comparable,
        "evaluator_baseline_key": evaluator_key,
        "n_cells": len(cells),
        "mean_abs_perplexity_delta_pct": (
            round(float(np.mean(deltas)), 2) if deltas else None
        ),
        "cells_within_1pct": int(sum(d <= 1.0 for d in deltas)),
        "cells": cells,
    }


def render_markdown(report: Dict[str, Any]) -> str:
    lines = [
        "# Quality-parity report (A/B vs reference AAMAS artifacts)",
        "",
        f"- Backend: `{report['backend']}` model `{report['model']}` "
        f"(**weights: {report['weights']}**)",
        f"- Baseline evaluator key: `{report['evaluator_baseline_key']}`",
        f"- Cells: {report['n_cells']}, within 1%: "
        f"{report['cells_within_1pct']}, mean |Δppl|: "
        f"{report['mean_abs_perplexity_delta_pct']}%",
        f"- Embedder: `{report['embedder']}`",
        "",
    ]
    if "random" in str(report.get("weights", "")):
        lines += [
            "**Status: will certify within-1% the day a real checkpoint is "
            "mounted.** Every link above the weight files is tested: the "
            "port's transformer matches the JAX package's on identical weights "
            "(tests/test_torch_*.py), and the JAX package's is HF-certified "
            "(tests/test_hf_numerics.py); the port loads an HF safetensors "
            "directory with the JAX loader's name map "
            "(tests/test_torch_loader.py), and checkpoint ingest (HF dir -> "
            "the port's int8 safetensors checkpoint -> backend restore) "
            "round-trips bit-equal params (tests/test_torch_ingest_checkpoint.py). "
            "The only missing input is the checkpoint itself: run "
            "`python -m consensus_tpu_torch.cli.ingest_checkpoint --hf-dir ... "
            "--out ...`, pass `--checkpoint <out>`, and re-run this report.",
            "",
        ]
    if not report.get("cosine_baseline_comparable"):
        lines += [
            "**Cosine-family metrics are NOT baseline-comparable in this "
            "report.** The reference embeds with a dedicated encoder, "
            "`BAAI/bge-large-en-v1.5` (src/utils.py:376-407); this run "
            f"embedded with `{report['embedder']}` — a structurally "
            "different embedding space. Local cosine numbers are "
            "self-consistent (usable for method-vs-method comparisons "
            "within this report) but are excluded from the within-1% "
            "parity tally, which covers the perplexity family only. To "
            "restore reference semantics, place a local copy of the bge "
            "model on disk and pass `models.embedding_model_path` "
            "(consensus_tpu_torch/embedding.py).",
            "",
        ]
    lines += [
        "| scenario | sweep | method | params | egal ppl (local) | egal ppl"
        " (baseline) | Δ% |",
        "|---|---|---|---|---|---|---|",
    ]
    for cell in report["cells"]:
        params = ", ".join(f"{k}={v}" for k, v in cell["params"].items())
        lines.append(
            f"| {cell['scenario']} | {cell['sweep']} | {cell['method']} "
            f"| {params} | {cell['local_egalitarian_perplexity']} "
            f"| {cell['baseline_egalitarian_perplexity']} "
            f"| {cell.get('perplexity_delta_pct', '—')} |"
        )
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backend", default="torch", choices=["torch", "tpu", "fake"],
                        help="torch: the resident TorchBackend (tpu is its alias); "
                             "fake: no model")
    parser.add_argument("--model", default="tiny-gemma2")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--max-context", type=int, default=2048)
    parser.add_argument("--device", default=None, help="default: the card (cuda)")
    parser.add_argument("--scenario", nargs="*", type=int, default=None)
    parser.add_argument("--sweep", nargs="*", default=None)
    parser.add_argument(
        "--evaluator-key", default=DEFAULT_BASELINE_EVALUATOR,
        help="which bundled baseline evaluator column to diff against",
    )
    parser.add_argument(
        "--embedding-model-path", default=None,
        help="local sentence-transformers dir (reference: bge-large-en-v1.5)",
    )
    parser.add_argument("--output", default="results/parity")
    args = parser.parse_args(argv)

    if args.backend == "fake":
        from consensus_tpu_torch.backends.fake import FakeBackend

        backend: Backend = FakeBackend()
        weights = "fake"
    else:
        from consensus_tpu_torch.backends.torch_backend import TorchBackend

        backend = TorchBackend(
            model=args.model,
            checkpoint=args.checkpoint,
            tokenizer=args.tokenizer,
            max_context=args.max_context,
            device=args.device,
        )
        weights = "checkpoint" if args.checkpoint else "random"

    from consensus_tpu_torch.embedding import get_embedder

    report = build_report(
        backend,
        embedder=get_embedder(args.embedding_model_path, backend),
        evaluator_key=args.evaluator_key,
        scenarios=args.scenario,
        sweeps=args.sweep,
        weights=weights,
    )

    out = pathlib.Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    json_path = out / f"parity_report_{stamp}.json"
    json_path.write_text(json.dumps(report, indent=1))
    (out / f"parity_report_{stamp}.md").write_text(render_markdown(report))
    print(render_markdown(report))
    print(f"Wrote {json_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
