"""Open-loop load generator for the consensus server.

PyTorch port of ``consensus_tpu/serve/loadgen.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

Open-loop means arrivals are scheduled on a fixed clock regardless of how
fast responses come back — the regime that actually exposes tail latency
and overload behaviour (a closed loop self-throttles and hides both).
Request ``i`` is launched at ``t0 + i/rate`` on its own thread; each
records latency and outcome, and the report aggregates throughput,
p50/p95/p99 latency, and the rejection rate.

Request bodies replay the AAMAS survey scenarios
(``consensus_tpu_torch/data/aamas_scenarios.py``) round-robin, with distinct
seeds so the workload is deterministic but not degenerate-identical.
``scenario_repeat`` skews the scenario mix toward repeats (Zipf or a
fixed-k rotation) — the regime where the engine's prefix KV cache pays —
and the report then carries ``prefix_hit_fraction`` read from the
server's /healthz engine stats.  Stdlib only (``urllib``), like the
front end.

Alternatively :func:`corpus_requests` drives load from a scenario corpus
(``consensus_tpu_torch/data/scenarios``): weighted per-family sampling with a
deterministic per-request assignment — the honest-diversity workload.
Whichever builder produced the payloads, the report stamps the
scenario-mix provenance (``round_robin:aamas`` / ``fixed:K`` /
``zipf:S`` / ``corpus:v2[:mix]``) as ``scenario_mix`` right next to
``prefix_hit_fraction``, so a repetition-artifact cache number can never
be read as a workload property.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from consensus_tpu_torch.data.aamas_scenarios import SCENARIOS
from consensus_tpu_torch.obs.trace import RollingWindow


class Workload(list):
    """A payload list that remembers how its scenario mix was built, so
    :func:`run_loadgen` can stamp provenance on the report without the
    caller re-plumbing it."""

    provenance: str = "unspecified"

    @classmethod
    def with_provenance(cls, payloads, provenance: str) -> "Workload":
        workload = cls(payloads)
        workload.provenance = provenance
        return workload


def _scenario_sequence(
    count: int, n_scenarios: int, scenario_repeat: Optional[str],
    base_seed: int,
) -> List[int]:
    """Deterministic scenario indices for ``count`` requests.

    ``scenario_repeat`` picks the arrival mix:

    * ``None`` — round-robin over all scenarios (the historical default;
      every prompt distinct until the rotation wraps).
    * ``"fixed:K"`` — round-robin over only the first K scenarios, so each
      prompt repeats every K requests (K=1 is the degenerate all-same
      stream).
    * ``"zipf:S"`` — scenario rank r drawn with probability ∝ 1/(r+1)^S
      (seeded by ``base_seed``): a few hot scenarios dominate, the tail
      stays cold — the shape real consensus traffic has, and the one the
      prefix cache's LRU is sized for.
    """
    if scenario_repeat is None:
        return [i % n_scenarios for i in range(count)]
    kind, _, arg = str(scenario_repeat).partition(":")
    if kind == "fixed":
        k = max(1, min(n_scenarios, int(arg or 1)))
        return [i % k for i in range(count)]
    if kind == "zipf":
        s = float(arg or 1.1)
        weights = [1.0 / (rank + 1) ** s for rank in range(n_scenarios)]
        rng = random.Random(base_seed)
        return rng.choices(range(n_scenarios), weights=weights, k=count)
    raise ValueError(
        f"scenario_repeat must be None, 'fixed:K', or 'zipf:S', "
        f"got {scenario_repeat!r}"
    )


def _expand_agents(opinions: Dict[str, str], agents: int) -> Dict[str, str]:
    """Deterministic many-agent variant of a scenario's opinion dict for
    the AAMAS 50-200 agent regime: cycle the base opinions in sorted-name
    order, restating each copy as a distinct panel member (variant-tagged
    name AND variant-tagged text, so prompt dedup/prefix sharing can't
    collapse the extra agents).  ``agents <= len(opinions)`` truncates to
    the first ``agents`` base agents unchanged."""
    base = sorted(opinions.items())
    if agents <= len(base):
        return dict(base[:agents])
    out: Dict[str, str] = {}
    for i in range(agents):
        name, opinion = base[i % len(base)]
        variant = i // len(base)
        if variant == 0:
            out[name] = opinion
        else:
            out[f"{name}_v{variant}"] = (
                f"{opinion} (Restated by panel member {i}, holding the "
                f"same position — emphasis variant {variant}.)"
            )
    return out


def scenario_requests(
    count: int,
    method: str = "best_of_n",
    params: Optional[Dict[str, Any]] = None,
    base_seed: int = 100,
    evaluate: bool = False,
    timeout_s: Optional[float] = None,
    scenario_repeat: Optional[str] = None,
    agents: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """``count`` request payloads cycling the AAMAS scenarios (see
    :func:`_scenario_sequence` for the ``scenario_repeat`` mixes).
    ``agents`` expands every scenario to exactly that many deterministic
    opinion-holders (:func:`_expand_agents`) — the many-agent regime the
    utility-matrix scoring path is sized for."""
    keys = sorted(SCENARIOS)
    order = _scenario_sequence(count, len(keys), scenario_repeat, base_seed)
    payloads = []
    for i in range(count):
        scenario = SCENARIOS[keys[order[i]]]
        opinions = dict(scenario["agent_opinions"])
        if agents is not None:
            opinions = _expand_agents(opinions, int(agents))
        payload: Dict[str, Any] = {
            "issue": scenario["issue"],
            "agent_opinions": opinions,
            "method": method,
            "params": dict(params or {}),
            "seed": base_seed + i,
            "evaluate": evaluate,
            "request_id": f"loadgen-{i}",
        }
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        payloads.append(payload)
    provenance = (
        "round_robin:aamas" if scenario_repeat is None
        else str(scenario_repeat)
    )
    return Workload.with_provenance(payloads, provenance)


def corpus_requests(
    corpus,
    count: int,
    method: str = "best_of_n",
    params: Optional[Dict[str, Any]] = None,
    base_seed: int = 100,
    evaluate: bool = False,
    timeout_s: Optional[float] = None,
    mix: Optional[str] = None,
    agents: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """``count`` request payloads drawn from a scenario corpus.

    ``corpus`` is a loaded :class:`~consensus_tpu_torch.data.scenarios.Corpus`
    or a name/path resolvable by the scenario registry (``"v2"`` →
    ``data/scenarios_v2``).  ``mix`` is an optional per-family weighting
    (``"polarized=2,sybil=1"``); assignment is deterministic in
    (corpus, mix, count, base_seed) — see ``Corpus.sample_sequence``.
    Each request's id carries its scenario id
    (``loadgen-<i>:<scenario_id>``) so reports and traces can attribute
    outcomes per family.  ``agents`` force-expands every scenario to a
    fixed panel size, like :func:`scenario_requests`."""
    if isinstance(corpus, str):
        from consensus_tpu_torch.data.scenarios.registry import get_corpus

        corpus = get_corpus(corpus)
    order = corpus.sample_sequence(count, mix=mix, base_seed=base_seed)
    payloads = []
    for i, scenario in enumerate(order):
        opinions = dict(scenario["agent_opinions"])
        if agents is not None:
            opinions = _expand_agents(opinions, int(agents))
        payload: Dict[str, Any] = {
            "issue": scenario["issue"],
            "agent_opinions": opinions,
            "method": method,
            "params": dict(params or {}),
            "seed": base_seed + i,
            "evaluate": evaluate,
            "request_id": f"loadgen-{i}:{scenario['id']}",
        }
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        payloads.append(payload)
    provenance = f"corpus:{corpus.version or corpus.name}"
    if mix:
        provenance += f":{mix}"
    return Workload.with_provenance(payloads, provenance)


@dataclasses.dataclass
class RequestOutcome:
    request_id: str
    status: int  # HTTP status; 0 = transport error / client timeout
    latency_s: float
    error_type: str = ""
    statement: str = ""
    #: True when the 200 carried an anytime partial / browned-out result.
    degraded: bool = False
    #: Fleet mode: which replica / model tier served the 200 ("" otherwise).
    served_by: str = ""
    served_tier: str = ""
    #: Launch offset from the run's start (seconds) — lets the report
    #: bucket outcomes into a recovery curve without re-deriving arrivals.
    started_s: float = 0.0
    #: Welfare of the returned statement (``evaluate=True`` requests only;
    #: cosine channel) — feeds the report's ``welfare`` block.
    welfare_egalitarian: Optional[float] = None
    welfare_utilitarian: Optional[float] = None
    #: Worst-off agent's cosine utility — the egalitarian quantity itself.
    min_agent_utility: Optional[float] = None


def _percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (no numpy needed for a
    report, and nearest-rank keeps tiny samples honest)."""
    if not sorted_values:
        return float("nan")
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[rank]


def run_loadgen(
    base_url: str,
    payloads: List[Dict[str, Any]],
    rate_rps: float,
    client_timeout_s: float = 60.0,
    curve_bucket_s: Optional[float] = None,
    include_slo: bool = False,
    scenario_mix: Optional[str] = None,
    transport_fault_plan: Optional[str] = None,
) -> Dict[str, Any]:
    """Replay ``payloads`` open-loop at ``rate_rps`` against ``base_url``.

    Returns the report dict (see keys below); per-request outcomes ride
    along under ``"outcomes"`` for callers that want the raw data (the
    acceptance test compares statements against offline Experiment runs).
    """
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    url = base_url.rstrip("/") + "/v1/consensus"
    outcomes: List[Optional[RequestOutcome]] = [None] * len(payloads)

    def fire(index: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode("utf-8")
        request = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"},
            method="POST",
        )
        start = time.perf_counter()
        started_s = max(0.0, start - start_wall)
        try:
            with urllib.request.urlopen(
                request, timeout=client_timeout_s
            ) as response:
                data = json.loads(response.read().decode("utf-8"))
                welfare = data.get("welfare")
                egal = util = min_util = None
                if isinstance(welfare, dict):
                    egal = welfare.get("egalitarian_welfare_cosine")
                    util = welfare.get("utilitarian_welfare_cosine")
                utilities = data.get("utilities")
                if isinstance(utilities, dict) and utilities:
                    per_agent = [
                        u.get("cosine_similarity")
                        for u in utilities.values()
                        if isinstance(u, dict)
                        and u.get("cosine_similarity") is not None
                    ]
                    if per_agent:
                        min_util = min(per_agent)
                outcomes[index] = RequestOutcome(
                    request_id=payload.get("request_id", str(index)),
                    status=response.status,
                    latency_s=time.perf_counter() - start,
                    statement=data.get("statement", ""),
                    degraded=bool(data.get("degraded", False)),
                    served_by=str(data.get("served_by", "")),
                    served_tier=str(data.get("served_tier", "")),
                    started_s=started_s,
                    welfare_egalitarian=egal,
                    welfare_utilitarian=util,
                    min_agent_utility=min_util,
                )
        except urllib.error.HTTPError as exc:
            try:
                error = json.loads(exc.read().decode("utf-8")).get("error", {})
            except Exception:
                error = {}
            outcomes[index] = RequestOutcome(
                request_id=payload.get("request_id", str(index)),
                status=exc.code,
                latency_s=time.perf_counter() - start,
                error_type=error.get("type", "http_error"),
                started_s=started_s,
            )
        except Exception as exc:
            outcomes[index] = RequestOutcome(
                request_id=payload.get("request_id", str(index)),
                status=0,
                latency_s=time.perf_counter() - start,
                error_type=type(exc).__name__,
                started_s=started_s,
            )

    fleet_before = fetch_fleet_stats(base_url)
    prefix_before = fetch_prefix_stats(base_url)
    spec_before = fetch_speculative_stats(base_url)
    threads: List[threading.Thread] = []
    start_wall = time.perf_counter()
    # Seam-degradation windows are recorded on time.monotonic (the
    # PageStore clients' clock); anchor it so they can be re-based onto
    # the run timeline next to the recovery curve's buckets.
    start_mono = time.monotonic()
    for i, payload in enumerate(payloads):
        # Open loop: hold the schedule even if earlier requests are slow.
        target = start_wall + i / rate_rps
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        thread = threading.Thread(target=fire, args=(i, payload), daemon=True)
        thread.start()
        threads.append(thread)
    for thread in threads:
        thread.join(timeout=client_timeout_s + 5.0)
    wall_s = time.perf_counter() - start_wall

    def classify(outcome: RequestOutcome) -> str:
        if outcome.status == 200:
            return "ok"
        if outcome.status in (413, 429, 503):  # too large/overload/breaker
            return "rejected"
        if outcome.status == 504 or outcome.error_type == "timeout":
            return "timeout"
        return "failed"

    done = [o for o in outcomes if o is not None]
    buckets: Dict[str, List[RequestOutcome]] = {
        "ok": [], "rejected": [], "timeout": [], "failed": []}
    for outcome in done:
        buckets[classify(outcome)].append(outcome)
    ok, rejected = buckets["ok"], buckets["rejected"]
    timeouts, failed = buckets["timeout"], buckets["failed"]
    degraded = [o for o in ok if o.degraded]
    latencies = sorted(o.latency_s for o in ok)
    report: Dict[str, Any] = {
        "requests": len(payloads),
        "offered_rate_rps": rate_rps,
        "wall_s": round(wall_s, 3),
        "completed": len(ok),
        "rejected": len(rejected),
        "timeouts": len(timeouts),
        "failed": len(failed),
        "throughput_rps": round(len(ok) / wall_s, 3) if wall_s > 0 else 0.0,
        "rejection_rate": round(len(rejected) / len(payloads), 4)
        if payloads else 0.0,
        # Availability under faults: fraction of offered requests that got
        # a 200 — the headline chaos/SLO number.
        "availability": round(len(ok) / len(payloads), 4) if payloads else 0.0,
        # Brownout surface: how many 200s were anytime partials / ran at a
        # reduced search budget — the price paid for the availability above.
        "degraded": len(degraded),
        "degraded_fraction": round(len(degraded) / len(payloads), 4)
        if payloads else 0.0,
        "latency_ms": {
            "p50": round(_percentile(latencies, 0.50) * 1e3, 2),
            "p95": round(_percentile(latencies, 0.95) * 1e3, 2),
            "p99": round(_percentile(latencies, 0.99) * 1e3, 2),
            "max": round(latencies[-1] * 1e3, 2) if latencies else float("nan"),
        },
        "outcomes": done,
    }
    # Recovery curve: time-bucketed availability/rps/p95 over the run, so
    # chaos and elastic runs can show the dip at the fault and the climb
    # back after respawn instead of one blended availability number.
    bucket_s = curve_bucket_s or max(0.5, round(wall_s / 12.0, 1) or 0.5)
    window = RollingWindow(bucket_s=bucket_s)
    for outcome in done:
        is_ok = outcome.status == 200
        window.observe(
            outcome.started_s, ok=is_ok,
            latency_s=outcome.latency_s if is_ok else None,
        )
    report["recovery_bucket_s"] = bucket_s
    report["recovery_curve"] = window.curve()
    # Welfare block: only for evaluate=True payloads (the welfare fields
    # ride on the response), summarising what fairness the run delivered —
    # and, when some 200s were degraded, what egalitarian welfare the
    # degradation cost relative to full-fidelity responses.
    evaluated = [o for o in ok if o.welfare_egalitarian is not None]
    if evaluated:
        def _mean(values: List[float]) -> float:
            return sum(values) / len(values)

        egal = [o.welfare_egalitarian for o in evaluated]
        util = [o.welfare_utilitarian for o in evaluated
                if o.welfare_utilitarian is not None]
        mins = sorted(o.min_agent_utility for o in evaluated
                      if o.min_agent_utility is not None)
        full_egal = [o.welfare_egalitarian for o in evaluated
                     if not o.degraded]
        degraded_egal = [o.welfare_egalitarian for o in evaluated
                         if o.degraded]
        report["welfare"] = {
            "evaluated": len(evaluated),
            "egalitarian_mean": round(_mean(egal), 6),
            "utilitarian_mean": round(_mean(util), 6) if util else None,
            "min_agent_utility_p5": (
                round(_percentile(mins, 0.05), 6) if mins else None
            ),
            "degraded_welfare_gap": (
                round(_mean(full_egal) - _mean(degraded_egal), 6)
                if full_egal and degraded_egal else None
            ),
        }
    if include_slo:
        slo = fetch_slo(base_url)
        if slo is not None:
            report["slo"] = slo
    tier_counts = fetch_tier_counts(base_url)
    if tier_counts is not None:
        report["tier_request_counts"] = tier_counts
    # Durable-state accounting: journal replays from the server's
    # healthz durability block (single-server WAL path) and, in fleet
    # mode, rolling-restart events + warm-seed fractions gathered from
    # the manager snapshot below.  Emitted only when non-empty, so
    # non-durable runs' reports are unchanged.
    durability: Dict[str, Any] = {}
    fleet_after = fetch_fleet_stats(base_url)
    if fleet_after is not None:
        # Per-replica placement of the 200s (client view, from served_by)
        # and the failover fraction over this run (server view, from the
        # fleet counter delta — hedges excluded, failed-over-then-200 only).
        replica_counts: Dict[str, int] = {}
        for outcome in ok:
            if outcome.served_by:
                replica_counts[outcome.served_by] = (
                    replica_counts.get(outcome.served_by, 0) + 1
                )
        before_failovers = (
            fleet_before.get("failovers_total", 0) if fleet_before else 0
        )
        failovers = fleet_after.get("failovers_total", 0) - before_failovers
        report["fleet"] = {
            "size": fleet_after.get("size"),
            "healthy": fleet_after.get("healthy"),
            "lost": fleet_after.get("lost"),
            "availability": fleet_after.get("availability"),
            "serving_tier": fleet_after.get("serving_tier"),
            "failovers": failovers,
            "hedges_total": fleet_after.get("hedges_total", 0),
        }
        report["fleet"]["affinity_hit_rate"] = fleet_after.get(
            "affinity_hit_rate", 0.0
        )
        manager_after = fleet_after.get("manager")
        if isinstance(manager_after, dict):
            # Elastic fleet: respawns absorbed by the lifecycle manager
            # over THIS run (counter delta), plus any members the flap
            # detector quarantined — the report-level proof that a chaos
            # run recovered by respawning rather than by shrinking.
            manager_before = (
                fleet_before.get("manager") if fleet_before else None
            ) or {}
            report["fleet"]["respawns"] = (
                manager_after.get("respawns", 0)
                - manager_before.get("respawns", 0)
            )
            report["fleet"]["quarantined"] = list(
                manager_after.get("quarantined") or []
            )
            # Seam-degradation windows: when the PageStore transport seam
            # degraded (client retry exhaustion) and when the manager's
            # probes detected/cleared replica partitions — re-based from
            # time.monotonic onto the run timeline so they line up with
            # the recovery curve's buckets above.
            def _rel(stamp: Any) -> Optional[float]:
                if stamp is None:
                    return None
                return round(float(stamp) - start_mono, 3)

            store_stats = manager_after.get("page_store")
            seam: Dict[str, Any] = {}
            if isinstance(store_stats, dict):
                windows = store_stats.get("degradation_windows") or []
                seam["degraded_clients"] = list(
                    store_stats.get("degraded_clients") or []
                )
                seam["degradation_windows"] = [
                    {
                        "client": w.get("client"),
                        "enter_s": _rel(w.get("enter_s")),
                        "exit_s": _rel(w.get("exit_s")),
                    }
                    for w in windows
                ]
            partition_events = manager_after.get("partition_events") or []
            seam["partition_events"] = [
                {
                    "replica": e.get("replica"),
                    "detected_s": _rel(e.get("detected_s")),
                    "cleared_s": _rel(e.get("cleared_s")),
                }
                for e in partition_events
            ]
            if seam.get("degradation_windows") or seam["partition_events"]:
                report["seam_degradation"] = seam
            # Rolling-restart timeline: per-member drain -> respawn ->
            # warm-seed -> rejoin events, re-based onto the run timeline
            # like the seam windows above, plus the fraction of restarted
            # members that came back with warm prefix pages.
            restart_events = manager_after.get("restart_events") or []
            if restart_events:
                warm = manager_after.get("warm_seeded") or {}
                durability["rolling_restarts"] = manager_after.get(
                    "restarts", 0)
                durability["restart_events"] = [
                    {
                        "replica": e.get("replica"),
                        "started_s": _rel(e.get("started_s")),
                        "completed_s": _rel(e.get("completed_s")),
                        "time_to_recover_s": (
                            round(float(e["completed_s"])
                                  - float(e["started_s"]), 3)
                            if e.get("started_s") is not None
                            and e.get("completed_s") is not None
                            else None
                        ),
                        "warm_seeded_runs": e.get("warm_seeded", 0),
                    }
                    for e in restart_events
                ]
                restarted = [e.get("replica") for e in restart_events]
                durability["warm_seed_fraction"] = (
                    round(
                        sum(1 for r in restarted if (warm.get(r) or 0) > 0)
                        / len(restarted), 4)
                    if restarted else None
                )
        report["replica_request_counts"] = replica_counts
        report["failover_fraction"] = (
            round(failovers / len(ok), 4) if ok else 0.0
        )
    server_durability = fetch_durability_stats(base_url)
    if server_durability is not None:
        wal = server_durability.get("wal") or {}
        idem = server_durability.get("idempotency") or {}
        durability["journal"] = {
            "replayed": wal.get("replayed", 0),
            "recovered_unresolved": wal.get("recovered_unresolved", 0),
            "unresolved": wal.get("unresolved", 0),
        }
        if idem:
            durability["idempotency_restored"] = idem.get("restored", 0)
    if durability:
        report["durability"] = durability
    mesh_stats = fetch_engine_mesh(base_url)
    if mesh_stats is not None:
        # Per-dp-shard slot occupancy at run end: under a balanced engine
        # the shards should read near-equal — a skewed vector here is the
        # loadgen-visible signature of admission imbalance.
        report["mesh"] = {"dp": mesh_stats["dp"], "tp": mesh_stats["tp"]}
        report["dp_shard_slot_occupancy"] = [
            shard.get("slots_occupied", 0)
            for shard in mesh_stats.get("per_shard", [])
        ]
    # Scenario-mix provenance rides NEXT TO prefix_hit_fraction: a
    # prefix-cache number from `fixed:2` repetition and one from
    # `corpus:v2` diversity are different claims, and the report says
    # which one it is making.
    report["scenario_mix"] = (
        scenario_mix
        if scenario_mix is not None
        else getattr(payloads, "provenance", "unspecified")
    )
    # Transport-fault-plan provenance: a recovery curve measured under a
    # seeded seam fault schedule and one measured fault-free are different
    # claims — the header says which schedule (if any) was in force.
    report["transport_fault_plan"] = (
        transport_fault_plan if transport_fault_plan else "none"
    )
    prefix_after = fetch_prefix_stats(base_url)
    if prefix_after is not None:
        # Prefix-cache effectiveness over THIS run: admission hit/miss
        # deltas across every engine behind the server (one in single mode,
        # one per replica in fleet mode).
        before = prefix_before or {}
        hits = prefix_after.get("hits", 0) - before.get("hits", 0)
        misses = prefix_after.get("misses", 0) - before.get("misses", 0)
        saved = (
            prefix_after.get("tokens_saved", 0)
            - before.get("tokens_saved", 0)
        )
        report["prefix_cache"] = {
            "hits": hits,
            "misses": misses,
            "tokens_saved": saved,
            "scenario_mix": report["scenario_mix"],
        }
        report["prefix_hit_fraction"] = (
            round(hits / (hits + misses), 4) if (hits + misses) else 0.0
        )
    spec_after = fetch_speculative_stats(base_url)
    if spec_after is not None:
        # Speculative-decode effectiveness over THIS run: draft
        # proposed/accepted deltas across every engine behind the server.
        before = spec_before or {}
        proposed = (
            spec_after.get("proposed_tokens", 0)
            - before.get("proposed_tokens", 0)
        )
        accepted = (
            spec_after.get("accepted_tokens", 0)
            - before.get("accepted_tokens", 0)
        )
        windows = (
            spec_after.get("decode_windows", 0)
            - before.get("decode_windows", 0)
        )
        report["speculative"] = {
            "proposed_tokens": proposed,
            "accepted_tokens": accepted,
            "decode_windows": windows,
            "accepted_tokens_per_dispatch": (
                round(accepted / windows, 4) if windows else 0.0
            ),
            "draft_acceptance_rate": (
                round(accepted / proposed, 4) if proposed else 0.0
            ),
        }
    return report


def fetch_slo(base_url: str) -> Optional[Dict[str, Any]]:
    """End-of-run SLO verdicts from the server's ``GET /v1/slo``: the
    worst state plus per-SLO state and fast/slow burn rates.  None when
    the server runs no SLO engine (404) or the endpoint is down."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/v1/slo", timeout=5.0
        ) as response:
            snapshot = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    if not isinstance(snapshot, dict) or "specs" not in snapshot:
        return None
    return {
        "worst": snapshot.get("worst"),
        "specs": {
            spec["name"]: {
                "state": spec.get("state"),
                "fast_burn": (spec.get("burn") or {}).get("fast"),
                "slow_burn": (spec.get("burn") or {}).get("slow"),
            }
            for spec in snapshot.get("specs", [])
            if isinstance(spec, dict) and "name" in spec
        },
    }


def fetch_fleet_stats(base_url: str) -> Optional[Dict[str, Any]]:
    """The ``fleet`` block of the server's /healthz; None when the server
    is not running a fleet (single-scheduler bypass) or /healthz is down."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    fleet = health.get("fleet")
    return dict(fleet) if isinstance(fleet, dict) else None


def fetch_durability_stats(base_url: str) -> Optional[Dict[str, Any]]:
    """The ``durability`` block of the server's /healthz (WAL + durable
    idempotency stats); None when the server runs without ``--state-dir``
    (single server) or /healthz is down."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    block = health.get("durability")
    return dict(block) if isinstance(block, dict) else None


def fetch_prefix_stats(base_url: str) -> Optional[Dict[str, float]]:
    """Summed prefix-cache counters across every engine behind the server's
    /healthz — the single scheduler's ``engine`` block, or each fleet
    replica's.  None when no engine runs a prefix cache (or /healthz is
    down)."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    blocks = []
    engine = health.get("engine")
    if isinstance(engine, dict):
        blocks.append(engine.get("prefix_cache"))
    fleet = health.get("fleet")
    if isinstance(fleet, dict):
        for snap in (fleet.get("replicas") or {}).values():
            if isinstance(snap, dict) and isinstance(
                snap.get("engine"), dict
            ):
                blocks.append(snap["engine"].get("prefix_cache"))
    blocks = [
        b for b in blocks if isinstance(b, dict) and b.get("enabled")
    ]
    if not blocks:
        return None
    totals: Dict[str, float] = {}
    for key in ("hits", "misses", "evictions", "inserted_pages",
                "tokens_saved"):
        totals[key] = sum(b.get(key, 0) for b in blocks)
    return totals


def fetch_speculative_stats(base_url: str) -> Optional[Dict[str, float]]:
    """Summed speculative-decode counters across every engine behind the
    server's /healthz — the single scheduler's ``engine`` block, or each
    fleet replica's.  None when no engine has speculative decoding on (or
    /healthz is down)."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    engines = []
    engine = health.get("engine")
    if isinstance(engine, dict):
        engines.append(engine)
    fleet = health.get("fleet")
    if isinstance(fleet, dict):
        for snap in (fleet.get("replicas") or {}).values():
            if isinstance(snap, dict) and isinstance(
                snap.get("engine"), dict
            ):
                engines.append(snap["engine"])
    engines = [
        e for e in engines
        if isinstance(e.get("speculative"), dict)
        and e["speculative"].get("enabled")
    ]
    if not engines:
        return None
    totals: Dict[str, float] = {
        key: sum(e["speculative"].get(key, 0) for e in engines)
        for key in ("proposed_tokens", "accepted_tokens")
    }
    totals["decode_windows"] = sum(
        e.get("decode_windows", 0) for e in engines
    )
    return totals


def fetch_engine_mesh(base_url: str) -> Optional[Dict[str, Any]]:
    """The ``mesh`` block of the scheduler's engine stats in /healthz
    (dp/tp widths + per-dp-shard slot and page occupancy); None when the
    server runs no decode engine (or /healthz is down).  Fleet mode sums
    nothing — the first replica's engine block is representative, since
    every replica serves the same mesh shape."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    engine = health.get("engine")
    if isinstance(engine, dict) and isinstance(engine.get("mesh"), dict):
        return dict(engine["mesh"])
    fleet = health.get("fleet")
    if isinstance(fleet, dict):
        for snap in (fleet.get("replicas") or {}).values():
            if isinstance(snap, dict) and isinstance(snap.get("engine"), dict):
                mesh = snap["engine"].get("mesh")
                if isinstance(mesh, dict):
                    return dict(mesh)
    return None


def fetch_tier_counts(base_url: str) -> Optional[Dict[str, int]]:
    """Per-tier dispatch counts from the server's /healthz brownout
    snapshot; None when the controller is disabled or /healthz is down."""
    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=5.0
        ) as response:
            health = json.loads(response.read().decode("utf-8"))
    except Exception:
        return None
    brownout = health.get("brownout")
    if not isinstance(brownout, dict):
        return None
    counts = brownout.get("tier_request_counts")
    return dict(counts) if isinstance(counts, dict) else None


def report_json(report: Dict[str, Any]) -> str:
    """The report as JSON, outcomes elided (they hold full statements)."""
    slim = {k: v for k, v in report.items() if k != "outcomes"}
    return json.dumps(slim, indent=2)
