#!/usr/bin/env python
"""Open-loop load generator CLI for the consensus server (PyTorch port of
``scripts/serve_loadgen.py``).

Replays AAMAS-scenario requests at a target rate and reports throughput,
p50/p95/p99 latency, and rejection rate (one JSON object on stdout).

Two modes:

* ``--url http://host:port`` — drive an already-running server.
* ``--self-contained`` — spin up an in-process fake-backend server (the
  hardware-free smoke path), drive it, and shut it down; prints the same
  report plus the server's device-batch accounting, which shows the
  coalescing win (merged device batches << per-request call count).

Examples:

    python consensus_tpu_torch/scripts/serve_loadgen.py --self-contained \
        --requests 32 --rate 50
    python consensus_tpu_torch/scripts/serve_loadgen.py --self-contained \
        --fleet 3 --elastic --chaos-schedule kill:0.3,kill:0.8
    python consensus_tpu_torch/scripts/serve_loadgen.py \
        --url http://127.0.0.1:8080 \
        --requests 100 --rate 10 --method best_of_n --params '{"n": 8}'
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def _parse_chaos_schedule(spec):
    """``'kill:10,kill:25:r1,restart:40'`` -> ``[(10.0, 'kill', None),
    (25.0, 'kill', 'r1'), (40.0, 'restart', None)]``, sorted by fire
    time.  ``kill`` takes an optional replica NAME; ``restart`` rolls
    the whole fleet and takes none."""
    events = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if parts[0] == "kill" and len(parts) in (2, 3):
            events.append((float(parts[1]), "kill",
                           parts[2] if len(parts) == 3 else None))
        elif parts[0] == "restart" and len(parts) == 2:
            events.append((float(parts[1]), "restart", None))
        else:
            raise ValueError(
                "chaos event must be 'kill:S', 'kill:S:NAME' or "
                f"'restart:S', got {item!r}")
    events.sort(key=lambda e: e[0])
    return events


def _run_chaos(router, schedule, recover_timeout_s, events_out, stop):
    """Fire ``schedule`` against a live FleetRouter and measure, per kill,
    how long the fleet takes to read fully healthy again (the elastic
    manager's detect -> respawn -> warm-seed -> rejoin round trip).  Runs
    on its own daemon thread alongside the open-loop load."""
    import time

    start = time.monotonic()
    for index, (at_s, kind, name) in enumerate(schedule):
        if stop.wait(max(0.0, start + at_s - time.monotonic())):
            return
        if kind == "restart":
            # Rolling restart of the whole fleet: drain -> capture ->
            # respawn -> warm-seed -> health-gated rejoin, one replica
            # at a time.  rolling_restart() is synchronous, so its
            # return doubles as the recovery point.
            event = {"kind": kind, "at_s": at_s, "replica": None,
                     "recovered_s": None}
            events_out.append(event)
            manager = getattr(router, "manager", None)
            if manager is None:
                continue
            fired = time.monotonic()
            outcome = manager.rolling_restart()
            event["restarted"] = outcome.get("restarted")
            event["aborted"] = outcome.get("aborted")
            if outcome.get("aborted") is None:
                event["recovered_s"] = round(time.monotonic() - fired, 3)
            continue
        target = name
        if target is None:
            live = [r.name for r in router.replicas if not r.lost]
            target = live[0] if live else None
        event = {"kind": kind, "at_s": at_s, "replica": target,
                 "recovered_s": None}
        events_out.append(event)
        if target is None:
            continue
        size_before = len(router.replicas)
        try:
            router.kill_replica(target, reason="chaos")
        except KeyError:
            continue
        # Poll until the fleet is back at its pre-kill size with every
        # member HEALTHY (corpse removal shrinks size mid-recovery, so
        # healthy == size alone would declare victory too early), bounded
        # by the recovery timeout and by the next scheduled event.
        fired = time.monotonic()
        deadline = fired + recover_timeout_s
        if index + 1 < len(schedule):
            deadline = min(deadline, start + schedule[index + 1][0])
        while time.monotonic() < deadline and not stop.is_set():
            fleet = router.stats().get("fleet") or {}
            if (fleet.get("size", 0) >= size_before
                    and fleet.get("healthy", 0) >= fleet.get("size", 0)):
                event["recovered_s"] = round(time.monotonic() - fired, 3)
                break
            if stop.wait(0.05):
                return


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--url", default=None,
                        help="base URL of a running server")
    parser.add_argument("--self-contained", action="store_true",
                        help="start an in-process fake-backend server")
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--rate", type=float, default=20.0,
                        help="offered load, requests/sec (open loop)")
    parser.add_argument("--method", default="best_of_n")
    parser.add_argument("--params", default='{"n": 4, "max_tokens": 24}',
                        help="JSON object of method params")
    parser.add_argument("--seed", type=int, default=100)
    parser.add_argument("--corpus", default=None, metavar="NAME[:MIX]",
                        help="drive load from a scenario corpus instead "
                             "of the 5 AAMAS scenarios: NAME resolves "
                             "via the scenario registry ('v2' -> "
                             "data/scenarios_v2, or a directory path); "
                             "an optional :MIX weights families, e.g. "
                             "'v2:polarized=2,sybil=1'.  Per-request "
                             "assignment is deterministic in --seed, and "
                             "the report's scenario_mix records "
                             "'corpus:NAME[:MIX]' next to "
                             "prefix_hit_fraction")
    parser.add_argument("--scenario-repeat", default=None, metavar="MIX",
                        help="scenario arrival mix: 'fixed:K' cycles the "
                             "first K scenarios, 'zipf:S' draws ranks with "
                             "probability 1/(r+1)^S (default: round-robin "
                             "over all scenarios); repeated scenarios are "
                             "what the prefix KV cache accelerates, and "
                             "the report then shows prefix_hit_fraction")
    parser.add_argument("--agents", type=int, default=None, metavar="N",
                        help="expand every scenario to exactly N "
                             "deterministic opinion-holders (base opinions "
                             "cycled as variant-tagged panel members) — the "
                             "AAMAS 50-200 agent regime the utility-matrix "
                             "scoring path is sized for")
    parser.add_argument("--evaluate", action="store_true",
                        help="request per-agent utilities + welfare too")
    parser.add_argument("--timeout-s", type=float, default=None,
                        help="per-request deadline sent to the server")
    parser.add_argument("--client-timeout-s", type=float, default=60.0)
    parser.add_argument("--max-inflight", type=int, default=4,
                        help="(self-contained) worker pool size")
    parser.add_argument("--max-queue-depth", type=int, default=64,
                        help="(self-contained) admission queue bound")
    parser.add_argument("--engine", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="(self-contained) serve through the "
                             "continuous-batching decode engine (the "
                             "default; --no-engine falls back to the "
                             "legacy flush-window batcher)")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="(self-contained) enable the engine's "
                             "cross-request prefix KV cache (implies "
                             "--engine)")
    parser.add_argument("--engine-options", default="{}",
                        help="(self-contained) JSON object of extra "
                             "DecodeEngine options (slots, num_pages, "
                             "prefix_cache_pages, ...)")
    parser.add_argument("--decode-steps", type=int, default=None,
                        metavar="K",
                        help="(self-contained) multi-token decode: the "
                             "engine dispatches K-step on-device decode "
                             "windows per cohort instead of one blocking "
                             "call per token (implies --engine; shorthand "
                             'for --engine-options \'{"decode_steps": K}\')')
    parser.add_argument("--speculative", action="store_true",
                        help="(self-contained) engine-native speculative "
                             "decoding: each decode window drafts K tokens "
                             "per row (n-gram self-draft) and verifies them "
                             "in one dispatch, emitting 1 + accepted real "
                             "tokens (implies --engine; shorthand for "
                             '--engine-options \'{"speculative": true}\'; '
                             "output stays byte-identical)")
    parser.add_argument("--mesh", default=None, metavar="dp=N,tp=M",
                        help="(self-contained) serve over the (data, model) "
                             "device mesh: the decode engine partitions its "
                             "slots + page pools over dp (implies --engine) "
                             "and the report gains dp_shard_slot_occupancy")
    parser.add_argument("--brownout", action="store_true",
                        help="(self-contained) enable the brownout "
                             "controller: overloaded requests run at a "
                             "scaled search budget (degraded 200s) instead "
                             "of timing out")
    parser.add_argument("--target-p95-ms", type=float, default=None,
                        help="(self-contained) latency SLO fed into the "
                             "brownout pressure signal (implies --brownout)")
    parser.add_argument("--metrics-out", default=None,
                        help="write the serve-side registry snapshot delta "
                             "(metrics.json schema) here (self-contained)")
    parser.add_argument("--fleet", type=int, default=1, metavar="N",
                        help="(self-contained) run N backend replicas "
                             "behind the fleet router; the report gains "
                             "replica_request_counts and failover_fraction")
    parser.add_argument("--fleet-options", default="{}",
                        help="(self-contained) JSON object of fleet "
                             "options (tiers, hedge_after_s, elastic, "
                             "autoscale, watchdog_timeout_s, ...)")
    parser.add_argument("--elastic", action="store_true",
                        help="(self-contained, fleet) run the replica "
                             "lifecycle manager: lost replicas respawn "
                             "under their old name with warm PageStore "
                             "prefix pages (shorthand for fleet-options "
                             '{"elastic": true})')
    parser.add_argument("--autoscale", action="store_true",
                        help="(self-contained, fleet) run the "
                             "pressure-driven autoscaler on top of the "
                             "lifecycle manager (implies --elastic)")
    parser.add_argument("--watchdog-timeout-s", type=float, default=None,
                        metavar="S",
                        help="(self-contained, fleet) arm each replica "
                             "engine's hang watchdog: a dispatch wedged "
                             "longer than S marks the replica lost and "
                             "the elastic ladder respawns it")
    parser.add_argument("--chaos-schedule", default=None, metavar="EVENTS",
                        help="(self-contained, fleet) comma-separated "
                             "fault events: 'kill:S' or 'kill:S:NAME' — "
                             "kill a replica S seconds into the run (NAME "
                             "defaults to the first live replica at fire "
                             "time) — or 'restart:S' — roll the whole "
                             "fleet through drain -> capture -> respawn "
                             "-> warm-seed, one replica at a time.  "
                             "Repeated kills exercise the elastic respawn "
                             "path; the report gains a 'chaos' block with "
                             "per-event time-to-recover and the fleet "
                             "respawn count")
    parser.add_argument("--chaos-recover-timeout-s", type=float,
                        default=30.0,
                        help="cap on the per-event recovery poll (fleet "
                             "healthy == size) after a chaos kill")
    parser.add_argument("--kill-replica-at-s", type=float, default=None,
                        metavar="S",
                        help="(self-contained, fleet) legacy single-kill "
                             "form of --chaos-schedule: kill "
                             "--kill-replica S seconds into the run")
    parser.add_argument("--kill-replica", default="r0", metavar="NAME",
                        help="(self-contained, fleet) which replica "
                             "--kill-replica-at-s kills (default: r0)")
    parser.add_argument("--state-dir", default=None, metavar="DIR",
                        help="(self-contained) arm the durable-state "
                             "layer under DIR: fsync'd request WAL + "
                             "idempotency snapshots (single server) and "
                             "the disk-backed PageStore spill tier "
                             "(elastic fleets); the report gains a "
                             "'durability' block")
    parser.add_argument("--telemetry", action="store_true",
                        help="(self-contained) enable the welfare "
                             "telemetry plane (latency + welfare quantile "
                             "sketches, drift detector) on the server")
    parser.add_argument("--slo", action="store_true",
                        help="run the server's burn-rate SLO engine "
                             "(self-contained implies creating it; --url "
                             "mode just reads GET /v1/slo) and print the "
                             "end-of-run SLO verdicts in the report")
    parser.add_argument("--fault-plan", default=None,
                        help="(self-contained) JSON fault plan injected "
                             "below a supervised backend, e.g. "
                             '\'{"seed": 7, "faults": [{"kind": '
                             '"transient_error", "rate": 0.05}]}\'; the '
                             "report gains availability and retried "
                             "fraction")
    parser.add_argument("--transport-fault-plan", default=None,
                        help="(self-contained, fleet) JSON fault plan "
                             "injected into the PageStore transport seam "
                             "(ops ship/fetch/probe; kinds drop, "
                             "duplicate, reorder, bit_flip, partition, "
                             "latency, ...), e.g. '{\"seed\": 7, "
                             '"faults": [{"kind": "drop", "op": "ship", '
                             '"rate": 0.05}, {"kind": "partition", '
                             '"op": "*", "peer": "r1", "after_s": 1.0, '
                             "\"duration_s\": 2.0}]}'; implies elastic "
                             "fleet plumbing and stamps the plan as "
                             "transport_fault_plan provenance in the "
                             "report, next to the seam_degradation "
                             "windows")
    args = parser.parse_args(argv)
    if bool(args.url) == bool(args.self_contained):
        parser.error("exactly one of --url / --self-contained is required")

    from consensus_tpu_torch.serve.loadgen import (
        corpus_requests,
        report_json,
        run_loadgen,
        scenario_requests,
    )

    if args.corpus is not None:
        if args.scenario_repeat is not None:
            parser.error("--corpus and --scenario-repeat are mutually "
                         "exclusive scenario sources")
        name, _, mix = args.corpus.partition(":")
        payloads = corpus_requests(
            name,
            args.requests,
            method=args.method,
            params=json.loads(args.params),
            base_seed=args.seed,
            evaluate=args.evaluate,
            timeout_s=args.timeout_s,
            mix=mix or None,
            agents=args.agents,
        )
    else:
        payloads = scenario_requests(
            args.requests,
            method=args.method,
            params=json.loads(args.params),
            base_seed=args.seed,
            evaluate=args.evaluate,
            timeout_s=args.timeout_s,
            scenario_repeat=args.scenario_repeat,
            agents=args.agents,
        )

    if args.self_contained:
        from consensus_tpu_torch.obs import diff_snapshots, get_registry
        from consensus_tpu_torch.serve import create_server
        from consensus_tpu_torch.utils.io_atomic import atomic_write_json

        engine_options = json.loads(args.engine_options) or {}
        if args.prefix_cache:
            engine_options.setdefault("prefix_cache", True)
        if args.decode_steps is not None:
            engine_options.setdefault("decode_steps", args.decode_steps)
        if args.speculative:
            engine_options.setdefault("speculative", True)
        fleet_options = json.loads(args.fleet_options) or {}
        if args.elastic or args.autoscale:
            fleet_options.setdefault("elastic", True)
        if args.autoscale:
            fleet_options.setdefault("autoscale", True)
        if args.watchdog_timeout_s is not None:
            fleet_options.setdefault(
                "watchdog_timeout_s", args.watchdog_timeout_s)
        if args.transport_fault_plan is not None:
            fleet_options.setdefault(
                "transport_fault_plan", args.transport_fault_plan)
        server = create_server(
            backend="fake",
            port=0,  # ephemeral
            max_inflight=args.max_inflight,
            max_queue_depth=args.max_queue_depth,
            fault_plan=args.fault_plan,
            brownout=args.brownout or args.target_p95_ms is not None,
            target_p95_ms=args.target_p95_ms,
            engine=args.engine or args.prefix_cache or bool(engine_options)
            or args.mesh is not None,
            engine_options=engine_options or None,
            fleet_size=args.fleet,
            fleet_options=fleet_options or None,
            mesh=args.mesh,
            telemetry=args.telemetry,
            slo=args.slo,
            state_dir=args.state_dir,
        ).start()
        schedule = (_parse_chaos_schedule(args.chaos_schedule)
                    if args.chaos_schedule else [])
        if args.kill_replica_at_s is not None:
            schedule.append(
                (args.kill_replica_at_s, "kill", args.kill_replica))
            schedule.sort(key=lambda e: e[0])
        chaos_thread = chaos_stop = None
        chaos_events = []
        if schedule:
            if args.fleet <= 1:
                parser.error("--chaos-schedule / --kill-replica-at-s "
                             "need --fleet > 1")
            import threading

            chaos_stop = threading.Event()
            chaos_thread = threading.Thread(
                target=_run_chaos,
                args=(server.scheduler, schedule,
                      args.chaos_recover_timeout_s, chaos_events,
                      chaos_stop),
                daemon=True,
            )
        before = get_registry().snapshot()
        try:
            if chaos_thread is not None:
                chaos_thread.start()
            report = run_loadgen(
                server.base_url, payloads, args.rate,
                client_timeout_s=args.client_timeout_s,
                include_slo=args.slo,
                transport_fault_plan=args.transport_fault_plan,
            )
            report["device_batches"] = server.scheduler.stats()[
                "device_batches"]
            if chaos_thread is not None:
                # Let in-progress recovery polling settle before reading
                # the event list (bounded; the load has already drained).
                chaos_thread.join(timeout=args.chaos_recover_timeout_s + 5.0)
                recovered = [e["recovered_s"] for e in chaos_events
                             if e["recovered_s"] is not None]
                manager = (server.scheduler.stats().get("fleet") or {}).get(
                    "manager") or {}
                report["chaos"] = {
                    "events": chaos_events,
                    "kills": sum(1 for e in chaos_events
                                 if e["kind"] == "kill"),
                    "rolling_restarts": manager.get("restarts", 0),
                    "recovered": len(recovered),
                    "respawns": manager.get("respawns", 0),
                    "time_to_recover_s": {
                        "max": max(recovered) if recovered else None,
                        "mean": (round(sum(recovered) / len(recovered), 3)
                                 if recovered else None),
                    },
                }
        finally:
            if chaos_stop is not None:
                chaos_stop.set()
            server.stop()
        delta = diff_snapshots(before, get_registry().snapshot())

        def family_total(name):
            family = (delta.get("families") or {}).get(name) or {}
            return sum(s.get("value", 0) for s in family.get("series", []))

        # Retries absorbed below the HTTP surface: supervisor-level call
        # retries plus scheduler-level ticket retries, per offered request.
        retries = family_total("supervisor_retries_total") + family_total(
            "serve_retried_total")
        report["retried_fraction"] = (
            round(retries / args.requests, 4) if args.requests else 0.0)
        if args.metrics_out:
            payload = {"schema": "consensus_tpu.metrics.v1",
                       "metrics": delta}
            atomic_write_json(pathlib.Path(args.metrics_out), payload)
    else:
        report = run_loadgen(
            args.url, payloads, args.rate,
            client_timeout_s=args.client_timeout_s,
            include_slo=args.slo,
            transport_fault_plan=args.transport_fault_plan,
        )

    print(report_json(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
