"""``python -m consensus_tpu_torch.serve`` — run the consensus HTTP server
(PyTorch port of ``consensus_tpu/serve/__main__.py``, with its flags).

Quickstart (hardware-free):

    python -m consensus_tpu_torch.serve --backend fake --port 8080

On the card, ``--backend torch --backend-options '{"model": "llama3-8b",
...}'`` serves the resident ``TorchBackend`` (random weights from
``base_seed`` unless the options name a ``checkpoint``: an HF safetensors
directory or one written by ``cli/ingest_checkpoint.py``); ``--device cpu``
puts it on the CPU, the only way there (a tiny model only).

    curl -s localhost:8080/v1/consensus -d '{
      "issue": "Should we invest in public transport?",
      "agent_opinions": {"Agent 1": "Yes, buses are vital.",
                         "Agent 2": "Only with congestion pricing."},
      "method": "best_of_n", "params": {"n": 4, "max_tokens": 32},
      "seed": 7}'

SIGINT/SIGTERM drains gracefully: admission closes (new requests get 429),
queued and in-flight requests finish, then the process exits.

``--mesh dp=N,tp=1`` serves over N data-parallel shards, one card each
(``tp > 1`` raises: ROADMAP.md, queue A15).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m consensus_tpu_torch.serve",
        description="Online consensus-statement server.",
    )
    parser.add_argument("--backend", default="fake",
                        help="backend name: fake | torch | tpu (the resident "
                             "TorchBackend under either name; default: fake)")
    parser.add_argument("--device", default=None,
                        help="device of a torch/tpu backend (default: cuda; "
                             "cpu only for tiny models)")
    parser.add_argument("--backend-options", default="{}",
                        help="JSON object of backend constructor kwargs "
                             '(e.g. \'{"checkpoint": "/path/to/hf"}\')')
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-queue-depth", type=int, default=64,
                        help="admission queue bound; beyond it requests get "
                             "an explicit 429 (default: 64)")
    parser.add_argument("--max-inflight", type=int, default=4,
                        help="worker pool size = concurrently executing "
                             "requests sharing one BatchingBackend "
                             "(default: 4)")
    parser.add_argument("--default-timeout-s", type=float, default=120.0,
                        help="per-request deadline when the client sends "
                             "none (default: 120)")
    parser.add_argument("--max-retries", type=int, default=2,
                        help="transient-failure retries per request "
                             "(default: 2)")
    parser.add_argument("--flush-ms", type=float, default=10.0,
                        help="BatchingBackend quiescence window (default: 10)")
    parser.add_argument("--generation-model", default="")
    parser.add_argument("--brownout", action="store_true",
                        help="enable the brownout controller: under load "
                             "pressure, scale down per-request search "
                             "budgets (degraded answers) instead of "
                             "timing out")
    parser.add_argument("--target-p95-ms", type=float, default=None,
                        help="latency SLO fed into the brownout pressure "
                             "signal (implies --brownout)")
    parser.add_argument("--engine", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="serve through the continuous-batching decode "
                             "engine (slot table + paged KV cache) — the "
                             "default; --no-engine opts back into the "
                             "legacy flush-snapshot merge (results are "
                             "byte-identical either way)")
    parser.add_argument("--engine-options", default="{}",
                        help="JSON object of DecodeEngine kwargs (e.g. "
                             '\'{"slots": 16, "page_size": 16}\')')
    parser.add_argument("--decode-steps", type=int, default=None,
                        metavar="K",
                        help="multi-token decode: the engine dispatches "
                             "K-step on-device decode windows per cohort "
                             "(shorthand for --engine-options "
                             '\'{"decode_steps": K}\')')
    parser.add_argument("--speculative", action="store_true",
                        help="engine-native speculative decoding: each "
                             "decode window drafts K tokens per row (n-gram "
                             "self-draft) and verifies them in one dispatch, "
                             "emitting 1 + accepted real tokens; output "
                             "stays byte-identical (shorthand for "
                             '--engine-options \'{"speculative": true}\')')
    parser.add_argument("--fleet", type=int, default=1, metavar="N",
                        help="run N backend replicas behind the fleet "
                             "router (health-gated routing, scenario "
                             "affinity, transparent failover); 1 = "
                             "single-scheduler path, router bypassed "
                             "(default: 1)")
    parser.add_argument("--fleet-options", default="{}",
                        help="JSON object of fleet options: tiers, "
                             "tier_backend_options, hedge_after_s, "
                             "probe_timeout_s, engine (per-replica list — "
                             "legacy flush vs --engine is chosen per "
                             "replica), elastic, elastic_options, "
                             "autoscale, watchdog_timeout_s, ... (see "
                             "create_server docs)")
    parser.add_argument("--elastic", action="store_true",
                        help="(fleet) run the replica lifecycle manager: "
                             "lost replicas respawn under their old name "
                             "with warm PageStore prefix pages, flapping "
                             "ones are quarantined")
    parser.add_argument("--autoscale", action="store_true",
                        help="(fleet) run the pressure-driven autoscaler "
                             "on top of the lifecycle manager (implies "
                             "--elastic); scales the replica target on "
                             "brownout pressure before quality degrades")
    parser.add_argument("--watchdog-timeout-s", type=float, default=None,
                        metavar="S",
                        help="(fleet) arm each replica engine's hang "
                             "watchdog: a device dispatch wedged longer "
                             "than S marks the replica lost and the "
                             "elastic ladder respawns it")
    parser.add_argument("--mesh", default=None, metavar="dp=N,tp=M",
                        help="serve over the (data, model) device mesh: "
                             "replicate the backend params over dp cards and "
                             "partition the decode engine's slots + page "
                             "pools over them (e.g. --mesh dp=4,tp=1; tp > 1 "
                             "is not ported)")
    parser.add_argument("--state-dir", default=None, metavar="DIR",
                        help="arm the durable-state layer: fsync'd request "
                             "WAL + idempotency snapshots (single server) "
                             "and the disk-backed PageStore spill tier "
                             "(elastic fleets), all under DIR; relaunching "
                             "with the same DIR after a crash replays "
                             "unresolved requests and warm-seeds KV from "
                             "disk")
    parser.add_argument("--blackbox", default=None, metavar="PATH",
                        help="write the flight recorder's blackbox JSON "
                             "(recent iterations + fleet events) to PATH on "
                             "watchdog trip, replica loss, or SIGTERM "
                             "(env: CONSENSUS_BLACKBOX)")
    parser.add_argument("--telemetry", action="store_true",
                        help="welfare telemetry plane: latency + welfare "
                             "quantile sketches (mergeable across replicas), "
                             "per-tier degraded welfare-gap gauges, fairness "
                             "drift detector; fleets federate /metrics")
    parser.add_argument("--slo", action="store_true",
                        help="run the multi-window burn-rate SLO engine "
                             "(availability, p95 latency, degraded fraction, "
                             "KV headroom, welfare drift) at GET /v1/slo "
                             "and inside /healthz")
    parser.add_argument("--slo-specs", default=None, metavar="JSON",
                        help="JSON list of SLO spec dicts overriding the "
                             "defaults (implies --slo)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    from consensus_tpu_torch.obs.trace import get_flight_recorder
    from consensus_tpu_torch.serve import create_server

    if args.blackbox:
        get_flight_recorder().configure(args.blackbox)

    backend_options = json.loads(args.backend_options)
    if args.device is not None:
        backend_options["device"] = args.device
    engine_options = json.loads(args.engine_options) or {}
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
        fleet_options.setdefault("watchdog_timeout_s", args.watchdog_timeout_s)

    server = create_server(
        backend=args.backend,
        backend_options=backend_options,
        host=args.host,
        port=args.port,
        max_queue_depth=args.max_queue_depth,
        max_inflight=args.max_inflight,
        default_timeout_s=args.default_timeout_s,
        max_retries=args.max_retries,
        flush_ms=args.flush_ms,
        generation_model=args.generation_model,
        brownout=args.brownout or args.target_p95_ms is not None,
        target_p95_ms=args.target_p95_ms,
        engine=args.engine,
        engine_options=engine_options or None,
        fleet_size=args.fleet,
        fleet_options=fleet_options or None,
        mesh=args.mesh,
        telemetry=args.telemetry,
        slo=(json.loads(args.slo_specs) if args.slo_specs else args.slo),
        state_dir=args.state_dir,
    )
    stop = threading.Event()
    shutdown_reason = ["exit"]

    def handle_signal(signum, frame):
        logging.getLogger("consensus_tpu_torch.serve").info(
            "signal %d: draining and shutting down", signum)
        shutdown_reason[0] = (
            "sigterm" if signum == signal.SIGTERM else "sigint")
        stop.set()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    server.start()
    print(json.dumps({
        "serving": server.base_url,
        "endpoints": ["POST /v1/consensus", "GET /healthz", "GET /metrics",
                      "GET /v1/trace/<request_id>", "GET /v1/slo"],
        "backend": args.backend,
        "max_queue_depth": args.max_queue_depth,
        "max_inflight": args.max_inflight,
        "brownout": args.brownout or args.target_p95_ms is not None,
        "engine": args.engine,
        "speculative": bool(engine_options.get("speculative")),
        "fleet": args.fleet,
        "elastic": bool(fleet_options.get("elastic")
                        or fleet_options.get("autoscale")),
        "autoscale": bool(fleet_options.get("autoscale")),
        "mesh": args.mesh,
    }))
    try:
        stop.wait()
    finally:
        _shutdown(server, shutdown_reason[0])
    return 0


def _shutdown(server, reason: str) -> None:
    """Deterministic shutdown ordering: drain → WAL seal → blackbox dump.

    The signal handler only records the reason and sets the stop event;
    the actual teardown happens here, on the main thread.  ``stop()``
    drains the scheduler, which seals the WAL as its last act — so by the
    time the flight recorder dumps, the journal is sealed and the
    blackbox can never capture a half-sealed journal."""
    from consensus_tpu_torch.obs.trace import get_flight_recorder

    server.stop(drain=True)
    if reason != "exit":
        get_flight_recorder().dump(reason)


if __name__ == "__main__":
    raise SystemExit(main())
