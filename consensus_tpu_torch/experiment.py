"""Experiment engine: seeds x methods x parameter grids -> results.csv
(PyTorch port of ``consensus_tpu/experiment.py:90-518``).

Same artifact contract as the JAX engine:

* timestamped run directory ``{output_dir}/{experiment_name}_{YYYYmmdd_HHMMSS}``
  with a ``config.yaml`` snapshot;
* per seed ``base_seed + i`` for ``num_seeds``;
* list-valued method parameters expand to the Cartesian product of runs;
* each run records ``method, statement, generation_time_s, seed,
  error_message, evaluation_status="pending"`` plus ``param_*`` columns,
  in the same lead-column and row order, saved atomically to
  ``results.csv``;
* ``journal.jsonl`` (one fsync'd record per finished row: ``resume: true``
  reuses the newest journaled run dir and executes only the missing runs),
  ``timing.json`` (span totals), ``metrics.json`` (schema
  ``consensus_tpu.metrics.v1``: this cell's registry delta, span tree,
  derived padding efficiency and padded-shape count, mesh), ``metrics.prom``
  and ``token_counts.json``.

Execution, as the JAX engine's: ``concurrent_execution`` (default true)
runs a cell's pending (seed x method x param) runs on
``max_concurrent_methods`` (default 4) worker threads whose backend calls
merge into shared device batches through
:class:`~consensus_tpu_torch.backends.batching.BatchingBackend`
(a 10 ms flush window; the config key ``engine`` (default false, as in
the JAX engine) routes them through the continuous-batching decode engine
instead, with ``engine_options``); one pending run, or
``concurrent_execution: false``, runs them one after another.  ``timing_pin_budget`` is the timing
mode: ``pin_budget`` in every run config, and ``pin_generation_budget`` on a
``tpu`` / ``torch`` backend built here.  ``profile_dir`` wraps the cell in a
``torch.profiler`` window (``utils/tracing.py``).

The backend named by the config defaults to ``torch``, the resident
``TorchBackend`` on the card unless ``device`` names another device; the
JAX engine's default is ``fake`` (``consensus_tpu/experiment.py:133``).
``fault_plan`` and ``supervisor`` layer the fault-tolerance stack,
``supervisor(faults(backend))`` (``backends.wrap_backend``), as in the JAX
engine; a fault plan implies supervision unless ``supervisor: false``.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import itertools
import json
import logging
import pathlib
import time
from typing import Any, Dict, List, Optional, Tuple

import pandas as pd
import yaml

from consensus_tpu_torch.backends import RESIDENT, get_backend, wrap_backend
from consensus_tpu_torch.backends.base import Backend
from consensus_tpu_torch.data.scenarios.registry import maybe_resolve_scenario
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.obs import (
    bucket_recompiles,
    diff_snapshots,
    diff_span_paths,
    get_registry,
    padding_efficiency,
)
from consensus_tpu_torch.utils.io_atomic import (
    JournalWriter,
    atomic_write_json,
    atomic_write_text,
    read_journal,
    sanitize_frame_for_csv,
)
from consensus_tpu_torch.utils.tracing import device_trace, get_tracer

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

#: ``on_error`` policies for a failed (method, config, seed) run.
ON_ERROR_POLICIES = ("skip", "fail", "retry")

def run_config_hash(run_config: Dict[str, Any]) -> str:
    """Stable short hash of a run config (seed excluded — the journal key
    carries the seed separately, so the same grid point across seeds shares
    one hash)."""
    payload = {k: v for k, v in run_config.items() if k != "seed"}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode("utf-8"), digest_size=8).hexdigest()


class Experiment:
    def __init__(
        self,
        config: Dict[str, Any],
        backend: Optional[Backend] = None,
        device: Optional[str] = None,
    ):
        self.config = config
        self.base_seed = int(config.get("seed", 42))
        self.num_seeds = int(config.get("num_seeds", 1))

        # ``scenario`` is inline issue/opinions, a registry ref string
        # ("corpus:v2:polarized-0004", "aamas:3"), or a dict with a ``ref``
        # key plus overriding fields (``data/scenarios/registry.py``).
        scenario = maybe_resolve_scenario(config.get("scenario", {}))
        self.issue: str = scenario.get("issue", "")
        self.agent_opinions: Dict[str, str] = dict(scenario.get("agent_opinions", {}))

        models = config.get("models", {})
        self.generation_model: str = models.get("generation_model", "")
        # Singular back-compat key.
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
            name = config.get("backend", "torch")
            if config.get("timing_pin_budget") and name in RESIDENT:
                options["pin_generation_budget"] = True
            if device is not None and name in RESIDENT:
                options["device"] = device
            self.backend = get_backend(name, **options)

        # Fault-tolerance stack: supervisor(faults(engine)).  ``fault_plan``
        # (chaos runs) implies supervision unless explicitly disabled.
        fault_plan = config.get("fault_plan")
        supervise = config.get("supervisor")
        if fault_plan is not None or supervise:
            self.backend = wrap_backend(
                self.backend, fault_plan=fault_plan, supervise=supervise
            )

        self.on_error = str(config.get("on_error", "skip"))
        if self.on_error not in ON_ERROR_POLICIES:
            raise ValueError(
                f"on_error must be one of {ON_ERROR_POLICIES}, "
                f"got {self.on_error!r}"
            )
        self.error_retries = max(0, int(config.get("error_retries", 1)))
        #: Zero wall-clock columns so chaos/resume proofs can assert
        #: byte-identical results.csv across runs.
        self.deterministic_artifacts = bool(
            config.get("deterministic_artifacts", False)
        )

        output_dir = pathlib.Path(config.get("output_dir", "results"))
        name = config.get("experiment_name", "experiment")
        self.resume = bool(config.get("resume", False))
        run_dir: Optional[pathlib.Path] = None
        if self.resume:
            # Reuse the newest journaled run dir for this experiment name;
            # timestamped names sort chronologically.
            candidates = sorted(
                p for p in output_dir.glob(f"{name}_*")
                if (p / "journal.jsonl").exists()
            )
            if candidates:
                run_dir = candidates[-1]
                logger.info("Resuming from %s", run_dir)
        self.resumed = run_dir is not None
        if run_dir is None:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            run_dir = output_dir / f"{name}_{stamp}"
        self.run_dir = run_dir
        self.run_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(
            self.run_dir / "config.yaml",
            yaml.safe_dump(config, sort_keys=False),
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
            if self.config.get("timing_pin_budget"):
                # Timing mode: decoders must not terminate a statement early
                # on EOS strings/terminators, so random-weight timing runs
                # measure the full-budget workload real weights would run.
                # The backend-side half is the pin_generation_budget option.
                method_config["pin_budget"] = True
            for run_config in self.expand_param_grid(method_config):
                runs.append({"method": method, "config": run_config, "seed": seed})
        return runs

    # -- execution -----------------------------------------------------------

    def _run_one(
        self,
        method: str,
        run_config: Dict[str, Any],
        seed: int,
        backend: Optional[Backend] = None,
    ) -> Dict:
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
                    method, backend or self.backend, run_config,
                    self.generation_model,
                )
                with get_tracer().span(f"generate/{method}"):
                    statement = generator.generate_statement(
                        self.issue, self.agent_opinions
                    )
                row["statement"] = statement
                if generator.degraded:
                    # Anytime early exit / scaled budget (budget_s or
                    # budget_scale in the run config).  Keys appear ONLY on
                    # degraded rows so full-budget sweeps keep their exact
                    # historical CSV schema (tests/golden/).
                    row["degraded"] = True
                    row["degraded_reason"] = generator.degraded_reason
                    row["budget_spent"] = json.dumps(
                        generator.budget_spent, sort_keys=True
                    )
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
                        method, type(exc).__name__, exc,
                        attempt + 1, attempts - 1,
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

    @staticmethod
    def _journal_key(run: Dict[str, Any]) -> Tuple[str, str, int]:
        return (
            str(run["method"]),
            run_config_hash(run["config"]),
            int(run["seed"]),
        )

    def _load_journal(
        self, runs: List[Dict[str, Any]]
    ) -> Dict[int, Dict[str, Any]]:
        """Map journaled rows back onto the deterministic run list.

        Keys ``(method, config_hash, seed)`` can repeat (identical grid
        points are legal), so matching is by multiplicity: the K-th
        journaled row for a key fills the K-th run with that key."""
        if not self.resumed:
            return {}
        journaled: Dict[Tuple[str, str, int], collections.deque] = {}
        for record in read_journal(self.run_dir / "journal.jsonl"):
            key_info = record.get("key") or {}
            row = record.get("row")
            if not isinstance(row, dict):
                continue
            key = (
                str(key_info.get("method", "")),
                str(key_info.get("config_hash", "")),
                int(key_info.get("seed", -1)),
            )
            journaled.setdefault(key, collections.deque()).append(row)
        done: Dict[int, Dict[str, Any]] = {}
        for index, run in enumerate(runs):
            queue = journaled.get(self._journal_key(run))
            if queue:
                done[index] = queue.popleft()
        return done

    def run(self) -> pd.DataFrame:
        runs: List[Dict[str, Any]] = []
        for i in range(self.num_seeds):
            seed = self.base_seed + i
            runs.extend(self._run_configs(seed))

        rows_by_index = self._load_journal(runs)
        pending = [
            (index, run) for index, run in enumerate(runs)
            if index not in rows_by_index
        ]
        if rows_by_index:
            logger.info(
                "Resume: %d/%d rows journaled; executing %d",
                len(rows_by_index), len(runs), len(pending),
            )

        # Token-honest cell accounting: the backend may be shared across an
        # in-process sweep, so record deltas around this experiment's runs.
        # Metrics and spans follow the same delta discipline: the registry
        # and tracer are process-global, so this cell's metrics.json records
        # (after - before), which run_sweep can sum back together exactly.
        tokens_before = dict(getattr(self.backend, "token_counts", {}) or {})
        wall_start = time.perf_counter()
        tracer = get_tracer()
        metrics_before = get_registry().snapshot()
        spans_before = tracer.snapshot_paths()

        concurrent = bool(self.config.get("concurrent_execution", True))
        max_workers = int(self.config.get("max_concurrent_methods", 4))

        # --profile-dir: a torch.profiler trace per cell, namespaced by
        # run-dir name so sweep cells don't clobber each other.
        profile_dir = self.config.get("profile_dir") or None
        if profile_dir:
            profile_dir = str(pathlib.Path(profile_dir) / self.run_dir.name)

        # Each completed row is journaled (append + fsync) BEFORE the sweep
        # moves on, so a kill at any point loses at most the in-flight rows;
        # --resume replays the journal and executes only what's missing.
        journal = JournalWriter(self.run_dir / "journal.jsonl")

        def finish(index: int, run: Dict[str, Any], row: Dict[str, Any]) -> Dict[str, Any]:
            method, config_hash, seed = self._journal_key(run)
            journal.append({
                "key": {
                    "method": method,
                    "config_hash": config_hash,
                    "seed": seed,
                },
                "run_index": index,
                "row": row,
            })
            return row

        try:
            with tracer.span("experiment"), device_trace(profile_dir):
                # Worker threads adopt this path so their generate/<method>
                # spans nest under this experiment in the span tree.
                parent_path = tracer.current_path()
                if concurrent and len(pending) > 1 and max_workers > 1:
                    # Independent runs (all seeds flattened) share device
                    # batches through the BatchingBackend: its flush-snapshot
                    # path, or the continuous-batching decode engine with
                    # ``engine: true``.
                    from concurrent.futures import ThreadPoolExecutor

                    from consensus_tpu_torch.backends.batching import BatchingBackend

                    batching = BatchingBackend(
                        self.backend,
                        flush_ms=float(self.config.get("batch_flush_ms", 10.0)),
                        expected_sessions=min(max_workers, len(pending)),
                        engine=bool(self.config.get("engine", False)),
                        engine_options=self.config.get("engine_options"),
                    )

                    def worker(item):
                        index, run = item
                        with tracer.adopt(parent_path), batching.session():
                            logger.info(
                                "Running %s with %s", run["method"], run["config"]
                            )
                            row = self._run_one(
                                run["method"], run["config"], run["seed"],
                                backend=batching,
                            )
                        return index, finish(index, run, row)

                    try:
                        with ThreadPoolExecutor(max_workers=max_workers) as pool:
                            for index, row in pool.map(worker, pending):
                                rows_by_index[index] = row
                    finally:
                        batching.close()
                    self.last_batch_counts = dict(batching.batch_counts)
                    logger.info(
                        "Device batches issued: %s (%d runs, %d workers)",
                        batching.batch_counts, len(pending), max_workers,
                    )
                else:
                    for index, run in pending:
                        logger.info(
                            "Running %s with %s", run["method"], run["config"]
                        )
                        row = self._run_one(
                            run["method"], run["config"], run["seed"]
                        )
                        rows_by_index[index] = finish(index, run, row)
        finally:
            journal.close()

        rows = [rows_by_index[index] for index in range(len(runs))]
        frame = pd.DataFrame(rows)
        lead = [c for c in _LEAD_COLUMNS if c in frame.columns]
        rest = sorted(c for c in frame.columns if c not in lead)
        frame = frame[lead + rest]
        atomic_write_text(
            self.run_dir / "results.csv",
            sanitize_frame_for_csv(frame).to_csv(index=False),
        )
        get_tracer().write(self.run_dir / "timing.json")
        self._write_metrics(metrics_before, spans_before)
        self._write_token_counts(tokens_before, wall_start, len(frame))
        logger.info("Saved %d rows to %s", len(frame), self.run_dir / "results.csv")
        return frame

    def _write_metrics(self, metrics_before, spans_before) -> None:
        """This cell's observability artifacts.

        ``metrics.json`` (schema ``consensus_tpu.metrics.v1``) holds the
        registry DELTA for this cell plus the nested span tree and the two
        derived headline numbers; ``metrics.prom`` is the cumulative
        process registry in Prometheus text exposition (what a scrape
        endpoint would serve)."""
        registry = get_registry()
        delta = diff_snapshots(metrics_before, registry.snapshot())
        span_delta = diff_span_paths(
            spans_before, get_tracer().snapshot_paths()
        )
        payload = {
            "schema": "consensus_tpu.metrics.v1",
            "spans": get_tracer().tree(span_delta),
            "metrics": delta,
            "derived": {
                "padding_efficiency": padding_efficiency(delta),
                "bucket_recompiles": bucket_recompiles(delta),
            },
            "mesh": self._mesh_labels(),
        }
        atomic_write_json(self.run_dir / "metrics.json", payload)
        atomic_write_text(
            self.run_dir / "metrics.prom", registry.to_prometheus()
        )

    def _mesh_labels(self) -> Dict[str, int]:
        """The device-mesh layout this cell ran on (``experiment.py:478-490``),
        so sweep readers can tell a dp=4 run from one card without
        re-deriving it from throughput.  Unwraps batching/supervision
        decorators to find the device backend; no mesh -> dp=1, tp=1."""
        backend = self.backend
        seen = set()
        while backend is not None and id(backend) not in seen:
            seen.add(id(backend))
            plan = getattr(backend, "mesh", None) or getattr(backend, "mesh_plan", None)
            if plan is not None:
                return {"dp": int(plan.dp), "tp": int(plan.tp)}
            backend = getattr(backend, "inner", None)
        return {"dp": 1, "tp": 1}

    def _write_token_counts(
        self, before: Dict[str, int], wall_start: float, statements: int
    ) -> None:
        """Cell-level token accounting -> run_dir/token_counts.json: s/stmt
        numbers come with how many tokens were actually generated/scored,
        so degenerate short statements cannot flatter a speedup."""
        after = getattr(self.backend, "token_counts", None)
        if not after:
            return
        wall = time.perf_counter() - wall_start
        generated = int(after.get("generated", 0) - (before.get("generated") or 0))
        scored = int(after.get("scored", 0) - (before.get("scored") or 0))
        total = generated + scored
        payload = {
            "statements": statements,
            "wall_s": round(wall, 3),
            "tokens_generated": generated,
            "tokens_scored": scored,
            "tokens_generated_per_statement": round(generated / max(statements, 1), 1),
            "s_per_1k_tokens": round(wall / max(total / 1000.0, 1e-9), 3)
            if total
            else None,
            "pinned_budget": bool(self.config.get("timing_pin_budget", False)),
        }
        atomic_write_json(self.run_dir / "token_counts.json", payload)
