"""Paper-sweep runner: run every matching scenario/method config (PyTorch
port of ``consensus_tpu/cli/run_sweep.py``).

Globs ``{configs_root}/{model}/scenario_N/{method}.yaml`` (the repo's
``configs/appendix`` and ``configs/north_star`` trees, whose configs say
``backend: tpu``: the port's resident ``TorchBackend``) and runs the full
pipeline (``run_experiment_with_eval.run_pipeline``) for each, with
model/scenario/method filters.  Each config runs in-process, and configs
with the same backend and backend options share one resident backend, so
the model's weights load once per sweep.  Every backend runs on the card
unless ``--device`` names another device.

``--timing-pin-budget`` pins every generation to its full token budget
(``pin_budget`` in every run config, ``pin_generation_budget`` on the
resident backends), ``--profile-dir`` writes a ``torch.profiler`` trace per
cell and per evaluation phase, ``--resume`` resumes each cell from its
newest journaled run dir, and ``--metrics-out`` writes the merge of every
cell's ``metrics.json`` delta (``write_sweep_metrics``).

Usage: ``python -m consensus_tpu_torch.cli.run_sweep --configs-root configs/appendix
[--model llama] [--scenario 1 2] [--method beam_search]``
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import re
import sys
import time
from typing import Dict, List, Optional

import yaml

from consensus_tpu_torch.backends import RESIDENT, get_backend
from consensus_tpu_torch.cli.run_experiment import configure_logging
from consensus_tpu_torch.cli.run_experiment_with_eval import run_pipeline

logger = logging.getLogger(__name__)

_SCENARIO_RE = re.compile(r"scenario_(\d+)")


def find_config_files(
    root: str,
    models: Optional[List[str]] = None,
    scenarios: Optional[List[int]] = None,
    methods: Optional[List[str]] = None,
) -> List[pathlib.Path]:
    """Glob ``{root}/{model}/scenario_N/{method}.yaml`` with filters, in
    sorted path order."""
    configs = []
    for path in sorted(pathlib.Path(root).glob("*/scenario_*/*.yaml")):
        model = path.parent.parent.name
        scenario_match = _SCENARIO_RE.search(path.parent.name)
        scenario = int(scenario_match.group(1)) if scenario_match else None
        if models and model not in models:
            continue
        if scenarios and scenario not in scenarios:
            continue
        if methods and path.stem not in methods:
            continue
        configs.append(path)
    return configs


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run a config sweep (PyTorch port)")
    parser.add_argument("--configs-root", default="configs/appendix")
    parser.add_argument("--model", nargs="*", default=None)
    parser.add_argument("--scenario", nargs="*", type=int, default=None)
    parser.add_argument("--method", nargs="*", default=None)
    parser.add_argument("--skip-comparative-ranking", action="store_true")
    parser.add_argument(
        "--on-error", choices=["fail", "skip", "retry"], default=None,
        help="per-row failure policy: 'skip' records a structured error row "
        "and continues (default), 'retry' retries the row before recording "
        "the error, 'fail' aborts the cell",
    )
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument(
        "--timing-pin-budget", action="store_true",
        help="timing mode: pin every generation to its full token budget "
        "(no EOS/terminator early exit) so random-weight timings measure "
        "the full-budget workload; never use for quality runs",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace (CPU and CUDA activity) per cell "
        "and per evaluation phase under this directory",
    )
    parser.add_argument(
        "--metrics-out", default=None,
        help="write a sweep-level metrics aggregate (merge of every cell's "
        "metrics.json delta) to this path",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume each cell from its newest journaled run dir: rows "
        "already in journal.jsonl are reused, only missing (method, "
        "config, seed) combos execute",
    )
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    configure_logging(args.quiet)
    configs = find_config_files(args.configs_root, args.model, args.scenario, args.method)
    if not configs:
        logger.error("No configs matched under %s", args.configs_root)
        return 1

    overrides = {}
    if args.timing_pin_budget:
        overrides["timing_pin_budget"] = True
    if args.profile_dir:
        overrides["profile_dir"] = args.profile_dir
    if args.resume:
        overrides["resume"] = True
    if args.on_error:
        overrides["on_error"] = args.on_error
    backends: Dict[str, object] = {}
    cell_dirs: List[pathlib.Path] = []
    logger.info("Running %d configs", len(configs))
    failures = 0
    for i, path in enumerate(configs, 1):
        logger.info("[%d/%d] %s", i, len(configs), path)
        start = time.perf_counter()
        try:
            config = yaml.safe_load(path.read_text())
            name = config.get("backend", "torch")
            options = dict(config.get("backend_options") or {})
            if name in RESIDENT:
                if args.device is not None:
                    options["device"] = args.device
                if args.timing_pin_budget:
                    options["pin_generation_budget"] = True
            key = json.dumps([name, options], sort_keys=True, default=str)
            if key not in backends:
                backends[key] = get_backend(name, **options)
            run_dir = run_pipeline(
                str(path),
                skip_comparative_ranking=args.skip_comparative_ranking,
                config_overrides=overrides or None,
                backend=backends[key],
            )
            cell_dirs.append(pathlib.Path(run_dir))
            logger.info(
                "[%d/%d] done in %.1fs -> %s",
                i, len(configs), time.perf_counter() - start, run_dir,
            )
        except Exception:
            logger.exception("[%d/%d] FAILED: %s", i, len(configs), path)
            failures += 1
    if args.metrics_out:
        write_sweep_metrics(cell_dirs, pathlib.Path(args.metrics_out))
    return 1 if failures else 0


def write_sweep_metrics(cell_dirs: List[pathlib.Path], out_path: pathlib.Path) -> Optional[dict]:
    """Aggregate every cell's metrics.json DELTA into one sweep snapshot.

    Cell deltas are exact per-cell windows of the process-global registry
    (``experiment.py`` records after - before), so summing them reconstructs
    the sweep total without double-counting; plus the sweep's derived
    padding efficiency / padded-shape count and a per-cell span-tree index
    (schema ``consensus_tpu.metrics.sweep.v1``, the JAX package's)."""
    from consensus_tpu_torch.obs import bucket_recompiles, merge_snapshots, padding_efficiency
    from consensus_tpu_torch.utils.io_atomic import atomic_write_json

    cells = []
    for run_dir in cell_dirs:
        path = run_dir / "metrics.json"
        if not path.exists():
            logger.warning("no metrics.json under %s; skipping", run_dir)
            continue
        cells.append((run_dir.name, json.loads(path.read_text())))
    if not cells:
        logger.warning("no cell metrics found; not writing %s", out_path)
        return None
    merged = merge_snapshots([payload["metrics"] for _, payload in cells])
    aggregate = {
        "schema": "consensus_tpu.metrics.sweep.v1",
        "cells": [name for name, _ in cells],
        "metrics": merged,
        "derived": {
            "padding_efficiency": padding_efficiency(merged),
            "bucket_recompiles": bucket_recompiles(merged),
        },
        "spans_by_cell": {name: payload.get("spans", []) for name, payload in cells},
    }
    atomic_write_json(out_path, aggregate)
    logger.info("Sweep metrics aggregate -> %s", out_path)
    return aggregate


if __name__ == "__main__":
    sys.exit(main())
