"""One run of one cell: set-up, warm-up, the measured window, the reading
of the metrics, and the correctness check after the window."""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from bench_port.harness import check, program, spec
from bench_port.harness.clients import Schedule, Statement, run_clients
from bench_port.harness.record import CallTimer
from bench_port.harness.trace import Trace, Tracer, breakdown

#: Statements still running this long after the window opened fail the run.
JOIN_TIMEOUT_S = 240.0
WARMUP_INDEX = 1 << 20


@dataclasses.dataclass
class Window:
    """What the metric readers read: everything over the measured window."""

    seconds: float  # from the first admission to the last return
    statements: List[Statement]
    registry: Dict[str, Any]  # obs registry snapshot diff
    call_counts: Dict[str, int]
    token_counts: Dict[str, int]
    spans: list  # CallTimer (kind, start, end), host clock
    start: float
    end: float
    config: Dict[str, Any]
    trace: Optional[Trace] = None


def _diff(after: Dict[str, Any], before: Dict[str, Any]) -> Dict[str, Any]:
    """Counter values and histogram count/sum, after minus before, keyed
    (family, labels)."""
    out = {}
    for name, fam in after["families"].items():
        old = {tuple(sorted(s["labels"].items())): s for s in before["families"].get(name, {}).get("series", [])}
        for series in fam["series"]:
            key = (name, tuple(sorted(series["labels"].items())))
            prev = old.get(key[1], {})
            if "value" in series:
                out[key] = series["value"] - prev.get("value", 0)
            elif "count" in series:
                out[key] = {
                    "count": series["count"] - prev.get("count", 0),
                    "sum": series["sum"] - prev.get("sum", 0.0),
                }
    return out


def run_cell(
    cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
    process_start: float, control: bool = False, warmup: bool = True, log=sys.stderr,
) -> Dict[str, Any]:
    from consensus_tpu_torch.backends.batching import BatchingBackend
    from consensus_tpu_torch.obs.metrics import get_registry

    traffic, cfg = cell.traffic, cell.config
    flat = program.flat_config(cfg)
    scenarios = spec.scenarios()
    schedule = Schedule(traffic, seed)
    n_clients = len(schedule.clients)

    backend = program.build_backend(cfg, seed, device, int(traffic["max_batch_rows"]))
    timer = CallTimer(backend)

    def batching_layer():
        # A fresh one per phase, as each experiment makes its own: its
        # ramp-up waits for every client before the first flush.
        return BatchingBackend(
            timer, flush_ms=float(traffic["flush_ms"]), expected_sessions=n_clients, engine=False,
        )

    # Warm-up: each client's first statements, with the traffic's warm-up
    # overrides (short drafts over the window's rows, prompts and batches).
    rounds = int(traffic["warmup"]["statements_per_client"]) if warmup else 0
    warm_schedule = Schedule(traffic, seed, traffic["warmup"].get("config"))
    warm = batching_layer()
    run_clients(warm, warm_schedule, scenarios, lambda c, j: j < rounds, WARMUP_INDEX, JOIN_TIMEOUT_S)
    warm.close()
    batching = batching_layer()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    registry = get_registry()
    before = (registry.snapshot(), dict(backend.call_counts), dict(backend.token_counts))
    timer.spans.clear()
    tracer = Tracer() if trace else None
    if tracer:
        tracer.start()
    start = time.perf_counter()
    setup_s = start - process_start
    close = start + seconds
    statements = run_clients(
        batching, schedule, scenarios, lambda c, j: time.perf_counter() < close, 0, JOIN_TIMEOUT_S
    )
    end = max((s.end for s in statements), default=time.perf_counter())
    traced = tracer.stop() if tracer else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    after = (registry.snapshot(), dict(backend.call_counts), dict(backend.token_counts))
    window = Window(
        seconds=end - start,
        statements=statements,
        registry=_diff(after[0], before[0]),
        call_counts={k: after[1][k] - before[1].get(k, 0) for k in after[1]},
        token_counts={k: after[2][k] - before[2].get(k, 0) for k in after[2]},
        spans=list(timer.spans),
        start=start,
        end=end,
        config=cfg,
        trace=traced,
    )
    prompt_lengths = [
        len(check.prompt_ids(r.user_prompt, r.system_prompt, r.chat))
        for s in statements for k, reqs, _ in s.log.calls if k == "generate" for r in reqs
    ] + [
        len(check.prompt_ids(sess.spec.ref_user, sess.spec.ref_system, chat=False))
        for s in statements for sess in s.log.sessions
    ]
    batching.close()
    del batching, timer, backend
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ok = [s for s in statements if s.ok]
    for s in statements:
        if s.error:
            print(f"statement failed (client {s.client}):\n{s.error}", file=log)
    walls = sorted(s.wall for s in ok)
    launches = {
        dict(labels).get("kernel"): v
        for (family, labels), v in window.registry.items() if family == "kernel_launches_total"
    }
    print(
        f"window: {len(statements)} statements admitted, {len(ok)} completed, "
        f"{window.seconds:.3f} s from the first admission to the last return, "
        f"{window.seconds - seconds:.3f} s past --seconds {seconds}; "
        f"walls median {statistics.median(walls) if walls else float('nan'):.3f} s over {len(walls)}; "
        f"longest prompt {max(prompt_lengths, default=0)} tokens "
        f"(max_context {cfg['backend']['max_context']}); peak {peak} B; kernel launches {launches}",
        file=log,
    )

    results: Dict[str, Any] = {}
    if not trace:
        e2e = {
            "statements_per_s": len(ok) / window.seconds if window.seconds > 0 else 0.0,
            "statement_s_p50": statistics.median(walls) if walls else None,
            "setup_s": setup_s,
        }
        for metric in cell.end_to_end:
            value = e2e[metric.name]
            if value is not None:
                results[metric.name] = value
    else:
        for metric in cell.per_layer:
            value = metric.reader.read(window)
            if value is not None:
                results[metric.name] = value

    readings = check.judge(statements, scenarios, traffic, cfg, flat, seed, device, control=control)
    return {
        "window": window,
        "metrics": results,
        "readings": readings,
        "attempted": len(statements),
        "failed": len(statements) - len(ok),
        "peak": peak,
        "breakdown": breakdown(traced, window.spans) if traced else None,
    }


def verdict(readings: Dict[str, Any], limits: Dict[str, float], failed: int) -> Dict[str, Any]:
    """Each compared number beside its limit; correct when every number
    exists and is within its limit and no statement failed."""
    compared = {name: {"value": readings.get(name), "limit": limit} for name, limit in limits.items()}
    compared["failed_statements"] = {"value": failed, "limit": 0}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return {"correct": ok, "compared": compared}

