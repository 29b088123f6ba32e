"""Cross-seed aggregation of evaluation artifacts (PyTorch port of
``consensus_tpu/aggregation.py``; pure pandas, the same frames).

Walks a run directory's ``evaluation/<model>/seed_*/evaluation_results.csv``
and ``evaluation/llm_judge/seed_*/ranking_results.csv``, normalizes method
keys (strips ``[seed=...]``) and emits per-method mean/std across seeds:

* model-metric columns prefixed ``{model}_{metric}_{mean|std}``
  (e.g. ``gemma2-9b_egalitarian_welfare_perplexity_mean``);
* judge-rank columns unprefixed (``avg_rank_mean`` ...), into
  ``evaluation/improved_aggregate/aggregated_metrics.csv``;
* raw per-seed rows preserved in ``aggregated_metrics_raw.csv``.

Metric families: perplexity / cosine / rank, including per-agent columns.
``aggregate_run_dir_basic`` is the older layout the pipeline falls back to
when the main aggregation fails.
"""

from __future__ import annotations

import logging
import pathlib
import re
from typing import Dict, List, Optional

import pandas as pd

from consensus_tpu_torch.utils.identifiers import normalize_method_name

logger = logging.getLogger(__name__)

#: Substrings selecting the metric columns to aggregate
#: (reference improved_aggregation.py:26-39).
METRIC_FAMILIES = ("perplexity", "cosine", "rank")

_SEED_DIR_RE = re.compile(r"seed_(\d+)$")


def collect_evaluation_data(run_dir: pathlib.Path) -> pd.DataFrame:
    """All per-model evaluation rows with ``model`` and ``method_key``
    columns attached (reference collect_evaluation_data, :156-228)."""
    frames = []
    eval_dir = run_dir / "evaluation"
    if not eval_dir.is_dir():
        return pd.DataFrame()
    for model_dir in sorted(eval_dir.iterdir()):
        if not model_dir.is_dir() or model_dir.name in ("llm_judge", "improved_aggregate", "aggregate"):
            continue
        for seed_dir in sorted(model_dir.glob("seed_*")):
            csv = seed_dir / "evaluation_results.csv"
            if not csv.exists():
                continue
            try:
                frame = pd.read_csv(csv)
            except pd.errors.EmptyDataError:
                logger.warning("Empty evaluation file: %s", csv)
                continue
            frame["model"] = model_dir.name
            frame["seed_dir"] = seed_dir.name
            frames.append(frame)
    if not frames:
        return pd.DataFrame()
    data = pd.concat(frames, ignore_index=True)
    data["method_key"] = data["method_with_params"].map(normalize_method_name)
    return data


def collect_llm_judge_data(run_dir: pathlib.Path) -> pd.DataFrame:
    """All judge ranking rows (reference collect_llm_judge_data, :230-289)."""
    frames = []
    judge_dir = run_dir / "evaluation" / "llm_judge"
    if not judge_dir.is_dir():
        return pd.DataFrame()
    for seed_dir in sorted(judge_dir.glob("seed_*")):
        csv = seed_dir / "ranking_results.csv"
        if not csv.exists():
            continue
        try:
            frame = pd.read_csv(csv)
        except pd.errors.EmptyDataError:
            logger.warning("Empty ranking file: %s", csv)
            continue
        frame["seed_dir"] = seed_dir.name
        frames.append(frame)
    if not frames:
        return pd.DataFrame()
    data = pd.concat(frames, ignore_index=True)
    key_source = "method_with_params" if "method_with_params" in data else "method"
    data["method_key"] = data[key_source].map(normalize_method_name)
    return data


def _metric_columns(frame: pd.DataFrame) -> List[str]:
    return [
        c
        for c in frame.columns
        if any(f in c for f in METRIC_FAMILIES)
        and pd.api.types.is_numeric_dtype(frame[c])
        and not c.startswith("param_")
    ]


def format_aggregated_columns(frame: pd.DataFrame) -> pd.DataFrame:
    """Reorder aggregate columns into the reference's presentation order
    (``create_formatted_output``, improved_aggregation.py:578-700):
    identity cols, sorted ``param_*`` cols, then metric families
    perplexity → cosine → rank, each grouped by model prefix with
    egalitarian → utilitarian → per-agent subcategories and mean before
    std; unmatched columns keep their original order at the end.

    Re-designed as one deterministic sort key instead of the reference's
    nested category loops.
    """
    identity = [c for c in ("method", "method_with_params") if c in frame.columns]
    params = sorted(c for c in frame.columns if c.startswith("param_"))
    rest = [c for c in frame.columns if c not in identity and c not in params]

    families = ("perplexity", "cosine", "rank")
    subcategories = ("egalitarian", "utilitarian", "Agent")

    def key(column: str):
        family = next((i for i, f in enumerate(families) if f in column), None)
        if family is None:
            return (len(families), 0, "", "", rest.index(column))
        # Model prefix = text before the first metric stem (sanitized model
        # names may contain underscores; unprefixed judge metrics get "").
        stems = (
            "egalitarian_", "utilitarian_", "log_nash_", "cosine_",
            "perplexity_", "avg_logprob_", "min_rank", "max_rank",
            "avg_rank", "rank_",
        )
        cut = min((column.find(s) for s in stems if s in column), default=0)
        model = column[:cut]
        sub = next(
            (i for i, s in enumerate(subcategories) if s in column),
            len(subcategories),
        )
        base = re.sub(r"_(mean|std)$", "", column)
        return (family, 0, model, (sub, base, column.endswith("_std")), 0)

    ordered = identity + params + sorted(rest, key=key)
    return frame[ordered]


def aggregate_run_dir(run_dir: str) -> Optional[pd.DataFrame]:
    """Aggregate one run directory; writes
    ``evaluation/improved_aggregate/aggregated_metrics{,_raw}.csv`` and
    returns the aggregated frame (reference main, :702-775)."""
    run_path = pathlib.Path(run_dir)
    eval_data = collect_evaluation_data(run_path)
    judge_data = collect_llm_judge_data(run_path)
    if eval_data.empty and judge_data.empty:
        logger.warning("No evaluation artifacts under %s", run_path)
        return None

    per_method: Dict[str, Dict[str, float]] = {}
    raw_frames = []

    if not eval_data.empty:
        raw_frames.append(eval_data)
        metric_cols = _metric_columns(eval_data)
        for (method_key, model), group in eval_data.groupby(["method_key", "model"]):
            stats = per_method.setdefault(method_key, {})
            stats.setdefault("method", group["method"].iloc[0])
            for param_col in (c for c in group.columns if c.startswith("param_")):
                values = group[param_col].dropna()
                if not values.empty:
                    stats.setdefault(param_col, values.iloc[0])
            for col in metric_cols:
                values = group[col].dropna()
                if values.empty:
                    continue
                stats[f"{model}_{col}_mean"] = float(values.mean())
                stats[f"{model}_{col}_std"] = float(values.std(ddof=1)) if len(values) > 1 else 0.0

    if not judge_data.empty:
        raw_frames.append(judge_data)
        metric_cols = _metric_columns(judge_data)
        for method_key, group in judge_data.groupby("method_key"):
            stats = per_method.setdefault(method_key, {})
            stats.setdefault("method", group["method"].iloc[0])
            for param_col in (c for c in group.columns if c.startswith("param_")):
                values = group[param_col].dropna()
                if not values.empty:
                    stats.setdefault(param_col, values.iloc[0])
            for col in metric_cols:
                values = group[col].dropna()
                if values.empty:
                    continue
                stats[f"{col}_mean"] = float(values.mean())
                stats[f"{col}_std"] = float(values.std(ddof=1)) if len(values) > 1 else 0.0

    rows = []
    for method_key, stats in sorted(per_method.items()):
        row = {"method": stats.get("method"), "method_with_params": method_key}
        row.update(
            {k: v for k, v in stats.items() if k not in ("method",)}
        )
        rows.append(row)
    aggregated = format_aggregated_columns(pd.DataFrame(rows))

    out_dir = run_path / "evaluation" / "improved_aggregate"
    out_dir.mkdir(parents=True, exist_ok=True)
    aggregated.to_csv(out_dir / "aggregated_metrics.csv", index=False)
    if raw_frames:
        pd.concat(raw_frames, ignore_index=True).to_csv(
            out_dir / "aggregated_metrics_raw.csv", index=False
        )
    logger.info("Wrote %s", out_dir / "aggregated_metrics.csv")
    return aggregated


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Aggregate evaluation metrics")
    parser.add_argument("run_dir", help="experiment run directory")
    args = parser.parse_args(argv)
    aggregated = aggregate_run_dir(args.run_dir)
    return 0 if aggregated is not None else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())


# ----------------------------------------------------------------------
# Basic (fallback) aggregation — reference aggregate_evaluation.py
# ----------------------------------------------------------------------


def _mean_std_by_method(frame: pd.DataFrame) -> pd.DataFrame:
    """Per-method-key mean/std of every metric column (no model prefix)."""
    rows = []
    metric_cols = _metric_columns(frame)
    for method_key, group in frame.groupby("method_key"):
        row: Dict[str, object] = {
            "method": group["method"].iloc[0],
            "method_with_params": method_key,
        }
        for param_col in (c for c in group.columns if c.startswith("param_")):
            values = group[param_col].dropna()
            if not values.empty:
                row[param_col] = values.iloc[0]
        for col in metric_cols:
            values = group[col].dropna()
            if values.empty:
                continue
            row[f"{col}_mean"] = float(values.mean())
            row[f"{col}_std"] = float(values.std(ddof=1)) if len(values) > 1 else 0.0
        rows.append(row)
    return pd.DataFrame(rows)


def aggregate_run_dir_basic(run_dir: str) -> Optional[pd.DataFrame]:
    """Older/fallback aggregation layout (reference aggregate_evaluation.py,
    SURVEY §2.11): per-model ``aggregate/<model>/aggregated_metrics.csv``,
    ``aggregate/llm_judge/aggregated_rankings.csv``, plus merged
    ``combined_metrics.csv`` and a ``simplified_metrics.csv`` with the
    headline columns."""
    run_path = pathlib.Path(run_dir)
    eval_data = collect_evaluation_data(run_path)
    judge_data = collect_llm_judge_data(run_path)
    if eval_data.empty and judge_data.empty:
        logger.warning("No evaluation artifacts under %s", run_path)
        return None

    out_root = run_path / "evaluation" / "aggregate"
    combined: Optional[pd.DataFrame] = None

    if not eval_data.empty:
        for model, group in eval_data.groupby("model"):
            frame = _mean_std_by_method(group)
            model_dir = out_root / str(model)
            model_dir.mkdir(parents=True, exist_ok=True)
            frame.to_csv(model_dir / "aggregated_metrics.csv", index=False)
            prefixed = frame.rename(
                columns={
                    c: f"{model}_{c}"
                    for c in frame.columns
                    if c not in ("method", "method_with_params")
                    and not c.startswith("param_")
                }
            )
            combined = (
                prefixed
                if combined is None
                else combined.merge(
                    prefixed.drop(columns=["method"], errors="ignore"),
                    on="method_with_params",
                    how="outer",
                    suffixes=("", "_dup"),
                )
            )

    if not judge_data.empty:
        judge_frame = _mean_std_by_method(judge_data)
        judge_dir = out_root / "llm_judge"
        judge_dir.mkdir(parents=True, exist_ok=True)
        judge_frame.to_csv(judge_dir / "aggregated_rankings.csv", index=False)
        merge_cols = ["method_with_params"] + [
            c for c in judge_frame.columns if "rank" in c
        ]
        combined = (
            judge_frame
            if combined is None
            else combined.merge(
                judge_frame[merge_cols], on="method_with_params", how="outer"
            )
        )

    if combined is not None:
        out_root.mkdir(parents=True, exist_ok=True)
        combined.to_csv(out_root / "combined_metrics.csv", index=False)
        headline = [
            c
            for c in combined.columns
            if c in ("method", "method_with_params")
            or c.startswith("param_")
            or "egalitarian_welfare_perplexity_mean" in c
            or c == "avg_rank_mean"
        ]
        combined[headline].to_csv(out_root / "simplified_metrics.csv", index=False)
        logger.info("Wrote %s", out_root / "combined_metrics.csv")
    return combined
