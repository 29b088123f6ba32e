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

``--timing-pin-budget``, ``--profile-dir``, ``--resume`` and
``--metrics-out`` select the JAX package's timing cells, device traces,
journal and metrics aggregate, which are not ported yet: they raise
``NotImplementedError`` (ROADMAP.md, queue A6).

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

from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.cli.run_experiment import configure_logging
from consensus_tpu_torch.cli.run_experiment_with_eval import run_pipeline

logger = logging.getLogger(__name__)

_SCENARIO_RE = re.compile(r"scenario_(\d+)")

#: Sweep flags of the JAX CLI whose features wait for queue A6.
_NOT_PORTED_FLAGS = {
    "timing_pin_budget": "timing cells",
    "profile_dir": "tracing",
    "resume": "the journal and resume",
    "metrics_out": "obs metrics",
}


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
    parser.add_argument("--timing-pin-budget", action="store_true", help="not ported (A6)")
    parser.add_argument("--profile-dir", default=None, help="not ported (A6)")
    parser.add_argument("--resume", action="store_true", help="not ported (A6)")
    parser.add_argument("--metrics-out", default=None, help="not ported (A6)")
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    for flag, item in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                f"(ROADMAP.md, queue A: A6, {item})"
            )
    configure_logging(args.quiet)
    configs = find_config_files(args.configs_root, args.model, args.scenario, args.method)
    if not configs:
        logger.error("No configs matched under %s", args.configs_root)
        return 1

    overrides = {"on_error": args.on_error} if args.on_error else None
    backends: Dict[str, object] = {}
    logger.info("Running %d configs", len(configs))
    failures = 0
    for i, path in enumerate(configs, 1):
        logger.info("[%d/%d] %s", i, len(configs), path)
        start = time.perf_counter()
        try:
            config = yaml.safe_load(path.read_text())
            name = config.get("backend", "torch")
            options = dict(config.get("backend_options") or {})
            if args.device is not None:
                options["device"] = args.device
            key = json.dumps([name, options], sort_keys=True, default=str)
            if key not in backends:
                backends[key] = get_backend(name, **options)
            run_dir = run_pipeline(
                str(path),
                skip_comparative_ranking=args.skip_comparative_ranking,
                config_overrides=overrides,
                backend=backends[key],
            )
            logger.info(
                "[%d/%d] done in %.1fs -> %s",
                i, len(configs), time.perf_counter() - start, run_dir,
            )
        except Exception:
            logger.exception("[%d/%d] FAILED: %s", i, len(configs), path)
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
