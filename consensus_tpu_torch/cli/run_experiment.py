"""Generation phase CLI for the PyTorch port.

Load a YAML config, run the experiment on the GPU (or the device given with
``--device``), print the result frame.

Usage: ``python -m consensus_tpu_torch.cli.run_experiment -c config.yaml``
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import pandas as pd
import yaml

from consensus_tpu_torch.experiment import Experiment


def configure_logging(quiet: bool = False) -> None:
    logging.basicConfig(
        level=logging.WARNING if quiet else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        force=True,
    )
    for noisy in ("urllib3", "httpx", "transformers"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def run_experiment_from_config(
    config_path: str, device: Optional[str] = None
) -> "tuple[pd.DataFrame, str]":
    """Run the generation phase; returns (results frame, run dir path)."""
    with open(config_path) as fh:
        config = yaml.safe_load(fh)
    experiment = Experiment(config, device=device)
    frame = experiment.run()
    return frame, str(experiment.run_dir)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run a consensus experiment (PyTorch port)")
    parser.add_argument("-c", "--config", required=True, help="YAML config path")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--quiet", action="store_true", help="less logging")
    args = parser.parse_args(argv)

    configure_logging(args.quiet)
    frame, run_dir = run_experiment_from_config(args.config, device=args.device)
    with pd.option_context("display.max_colwidth", 80, "display.width", 200):
        print(frame.to_string(index=False))
    print(f"\nRun directory: {run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
