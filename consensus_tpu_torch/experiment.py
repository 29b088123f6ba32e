"""Experiment engine: seeds x methods x parameter grids -> results.csv
(PyTorch port of ``consensus_tpu/experiment.py:90-447``).

Same artifact contract as the JAX engine:

* timestamped run directory ``{output_dir}/{experiment_name}_{YYYYmmdd_HHMMSS}``
  with a ``config.yaml`` snapshot;
* per seed ``base_seed + i`` for ``num_seeds``;
* list-valued method parameters expand to the Cartesian product of runs;
* each run records ``method, statement, generation_time_s, seed,
  error_message, evaluation_status="pending"`` plus ``param_*`` columns,
  in the same lead-column and row order, saved atomically to
  ``results.csv``; ``token_counts.json`` holds the cell's token accounting.

Runs execute one after another.  The JAX engine's concurrent batching
(``concurrent_execution``), journal and resume, fault/supervisor wrappers,
obs metrics and tracing are not ported yet: their config keys raise
``NotImplementedError`` instead of being ignored (ROADMAP.md, queue A).
"""

from __future__ import annotations

import datetime
import itertools
import logging
import pathlib
import time
from typing import Any, Dict, List, Optional

import pandas as pd
import yaml

from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.backends.base import Backend
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.utils.io_atomic import (
    atomic_write_json,
    atomic_write_text,
    sanitize_frame_for_csv,
)

logger = logging.getLogger(__name__)

#: Result-row column order (reference src/experiment.py:334-367).
_LEAD_COLUMNS = [
    "method",
    "statement",
    "pre_brushup_statement",
    "generation_time_s",
    "seed",
    "error_message",
    "evaluation_status",
]

ON_ERROR_POLICIES = ("skip", "fail", "retry")

#: Config keys of the JAX engine whose features wait for a later slice.
_NOT_PORTED_KEYS = {
    "concurrent_execution": "obs and tracing (concurrent batching)",
    "engine": "serving",
    "fault_plan": "obs and tracing (fault/supervisor wrappers)",
    "supervisor": "obs and tracing (fault/supervisor wrappers)",
    "resume": "obs and tracing (journal and resume)",
    "profile_dir": "obs and tracing",
    "timing_pin_budget": "obs and tracing (timing cells)",
}


class Experiment:
    def __init__(
        self,
        config: Dict[str, Any],
        backend: Optional[Backend] = None,
        device: Optional[str] = None,
    ):
        for key, item in _NOT_PORTED_KEYS.items():
            if config.get(key):
                raise NotImplementedError(
                    f"experiment option {key!r} is not ported yet (ROADMAP.md, queue A: {item})"
                )
        self.config = config
        self.base_seed = int(config.get("seed", 42))
        self.num_seeds = int(config.get("num_seeds", 1))

        scenario = config.get("scenario", {})
        if not isinstance(scenario, dict) or "ref" in scenario:
            raise NotImplementedError(
                "scenario registry refs are not ported yet (ROADMAP.md, queue A: "
                "evaluation); give issue and agent_opinions inline"
            )
        self.issue: str = scenario.get("issue", "")
        self.agent_opinions: Dict[str, str] = dict(scenario.get("agent_opinions", {}))

        models = config.get("models", {})
        self.generation_model: str = models.get("generation_model", "")
        eval_models = models.get("evaluation_models")
        if eval_models is None:
            single = models.get("evaluation_model")
            eval_models = [single] if single else []
        self.evaluation_models: List[str] = list(eval_models)
        self.methods_to_run: List[str] = list(config.get("methods_to_run", []))

        if backend is not None:
            self.backend = backend
        else:
            options = dict(config.get("backend_options") or {})
            if device is not None:
                options["device"] = device
            self.backend = get_backend(config.get("backend", "torch"), **options)

        self.on_error = str(config.get("on_error", "skip"))
        if self.on_error not in ON_ERROR_POLICIES:
            raise ValueError(
                f"on_error must be one of {ON_ERROR_POLICIES}, got {self.on_error!r}"
            )
        self.error_retries = max(0, int(config.get("error_retries", 1)))
        self.deterministic_artifacts = bool(config.get("deterministic_artifacts", False))

        output_dir = pathlib.Path(config.get("output_dir", "results"))
        name = config.get("experiment_name", "experiment")
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.run_dir = output_dir / f"{name}_{stamp}"
        self.run_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(
            self.run_dir / "config.yaml", yaml.safe_dump(config, sort_keys=False)
        )
        logger.info("Run directory: %s", self.run_dir)

    # -- run configs ---------------------------------------------------------

    @staticmethod
    def expand_param_grid(method_config: Dict[str, Any]) -> List[Dict[str, Any]]:
        """List-valued params -> Cartesian product."""
        listed = {k: v for k, v in method_config.items() if isinstance(v, list)}
        if not listed:
            return [dict(method_config)]
        fixed = {k: v for k, v in method_config.items() if k not in listed}
        configs = []
        keys = sorted(listed)
        for combo in itertools.product(*(listed[k] for k in keys)):
            run_config = dict(fixed)
            run_config.update(dict(zip(keys, combo)))
            configs.append(run_config)
        return configs

    def _run_configs(self, seed: int) -> List[Dict[str, Any]]:
        runs = []
        for method in self.methods_to_run:
            method_config = dict(self.config.get(method, {}) or {})
            method_config["seed"] = seed
            for run_config in self.expand_param_grid(method_config):
                runs.append({"method": method, "config": run_config, "seed": seed})
        return runs

    # -- execution -----------------------------------------------------------

    def _run_one(self, method: str, run_config: Dict[str, Any], seed: int) -> Dict:
        attempts = 1 + (self.error_retries if self.on_error == "retry" else 0)
        start = time.perf_counter()
        for attempt in range(attempts):
            row: Dict[str, Any] = {
                "method": method,
                "seed": seed,
                "error_message": "",
                "evaluation_status": "pending",
            }
            for key, value in run_config.items():
                if key != "seed":
                    row[f"param_{key}"] = value
            try:
                generator = get_method_generator(
                    method, self.backend, run_config, self.generation_model
                )
                row["statement"] = generator.generate_statement(
                    self.issue, self.agent_opinions
                )
                if generator.degraded:
                    row["degraded"] = True
                    row["degraded_reason"] = generator.degraded_reason
                if generator.pre_brushup_statement is not None and run_config.get(
                    "brushup", False
                ):
                    row["pre_brushup_statement"] = generator.pre_brushup_statement
                break
            except Exception as exc:
                if self.on_error == "fail":
                    raise
                if attempt + 1 < attempts:
                    logger.warning(
                        "Method %s failed (%s: %s); retry %d/%d",
                        method, type(exc).__name__, exc, attempt + 1, attempts - 1,
                    )
                    continue
                # Structured error row; the sweep continues.
                logger.exception("Method %s failed", method)
                row["statement"] = ""
                row["error_message"] = f"{type(exc).__name__}: {exc}"
        row["generation_time_s"] = (
            0.0 if self.deterministic_artifacts
            else round(time.perf_counter() - start, 3)
        )
        return row

    def run(self) -> pd.DataFrame:
        runs: List[Dict[str, Any]] = []
        for i in range(self.num_seeds):
            runs.extend(self._run_configs(self.base_seed + i))

        tokens_before = dict(getattr(self.backend, "token_counts", {}) or {})
        wall_start = time.perf_counter()
        rows = []
        for run in runs:
            logger.info("Running %s with %s", run["method"], run["config"])
            rows.append(self._run_one(run["method"], run["config"], run["seed"]))

        frame = pd.DataFrame(rows)
        lead = [c for c in _LEAD_COLUMNS if c in frame.columns]
        rest = sorted(c for c in frame.columns if c not in lead)
        frame = frame[lead + rest]
        atomic_write_text(
            self.run_dir / "results.csv",
            sanitize_frame_for_csv(frame).to_csv(index=False),
        )
        self._write_token_counts(tokens_before, wall_start, len(frame))
        logger.info("Saved %d rows to %s", len(frame), self.run_dir / "results.csv")
        return frame

    def _write_token_counts(
        self, before: Dict[str, int], wall_start: float, statements: int
    ) -> None:
        """Cell-level token accounting -> run_dir/token_counts.json."""
        after = getattr(self.backend, "token_counts", None)
        if not after:
            return
        wall = time.perf_counter() - wall_start
        generated = int(after.get("generated", 0) - (before.get("generated") or 0))
        scored = int(after.get("scored", 0) - (before.get("scored") or 0))
        total = generated + scored
        atomic_write_json(
            self.run_dir / "token_counts.json",
            {
                "statements": statements,
                "wall_s": round(wall, 3),
                "tokens_generated": generated,
                "tokens_scored": scored,
                "tokens_generated_per_statement": round(generated / max(statements, 1), 1),
                "s_per_1k_tokens": round(wall / max(total / 1000.0, 1e-9), 3)
                if total
                else None,
            },
        )
