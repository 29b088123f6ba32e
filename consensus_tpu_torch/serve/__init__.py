"""Online serving: scheduler + service + HTTP front end, and the replica
fleet behind a router (PyTorch port of ``consensus_tpu/serve``).

The layering, front to back:

    HTTP front end  (serve.http_frontend — stdlib ThreadingHTTPServer)
      └─ scheduler      (serve.scheduler — bounded queue, admission control,
         └─ worker pool          deadlines, retry, drain, breaker admission)
            └─ service  (serve.service — request → method generator)
               └─ merge layer backends.batching.BatchingBackend (shared;
                  │              the continuous-batching DecodeEngine by
                  │              default)
                  └─ stack    supervisor(faults(backend)) when armed
                     └─ backend  FakeBackend / TorchBackend

With ``fleet_size > 1`` the scheduler is replaced by a
:class:`FleetRouter` over N such stacks (``serve.fleet``), each replica with
its own backend; elastic fleets add the replica manager, the page store
over the transport seam and the autoscaler.  ``state_dir`` arms the request
WAL, ``telemetry`` the welfare plane and ``slo`` the burn-rate SLO engine.

``python -m consensus_tpu_torch.serve --backend fake`` runs a hardware-free
server; ``--backend torch`` (or ``tpu``) serves the resident
``TorchBackend`` on the card; ``serve.loadgen`` replays AAMAS scenarios
against either.  ``mesh`` serves over the data-parallel device mesh.
"""

from consensus_tpu_torch.serve.autoscale import Autoscaler  # noqa: F401
from consensus_tpu_torch.serve.brownout import BrownoutController  # noqa: F401
from consensus_tpu_torch.serve.fleet import Replica, ReplicaManager  # noqa: F401
from consensus_tpu_torch.serve.http_frontend import ConsensusServer  # noqa: F401
from consensus_tpu_torch.serve.pagestore import (  # noqa: F401
    PageIntegrityError,
    PageStore,
    PageStoreClient,
)
from consensus_tpu_torch.serve.router import FleetRouter, FleetTicket  # noqa: F401
from consensus_tpu_torch.serve.transport import (  # noqa: F401
    FaultyTransport,
    LoopbackTransport,
    TransportDropped,
    TransportError,
    TransportPartitioned,
    TransportTimeout,
)
from consensus_tpu_torch.serve.scheduler import (  # noqa: F401
    IdempotencyCache,
    RequestScheduler,
    RequestTimeout,
    SchedulerRejected,
    Ticket,
)
from consensus_tpu_torch.serve.service import (  # noqa: F401
    ConsensusRequest,
    ConsensusService,
    RequestValidationError,
    parse_request,
)


def create_server(
    backend="fake",
    backend_options=None,
    host: str = "127.0.0.1",
    port: int = 8080,
    max_queue_depth: int = 64,
    max_inflight: int = 4,
    default_timeout_s=120.0,
    max_retries: int = 2,
    flush_ms: float = 10.0,
    generation_model: str = "",
    registry=None,
    fault_plan=None,
    supervise=None,
    brownout: bool = False,
    target_p95_ms=None,
    anytime_margin_s: float = 0.2,
    engine: bool = True,
    engine_options=None,
    fleet_size: int = 1,
    fleet_options=None,
    mesh=None,
    telemetry: bool = False,
    telemetry_options=None,
    slo=False,
    slo_options=None,
    state_dir=None,
) -> ConsensusServer:
    """Wire backend → service → scheduler → HTTP server (not yet started).

    ``backend`` is a name (``fake``, the default as in the JAX package;
    ``torch`` / ``tpu`` for the resident ``TorchBackend``, on the card
    unless ``backend_options["device"]`` names another device) or a Backend
    instance, which is used as it is.

    ``state_dir`` (``--state-dir`` on the CLI) arms the durable-state
    layer, all files under one directory so crash recovery is "relaunch
    with the same flag": the fsync'd request WAL
    (:mod:`consensus_tpu_torch.serve.wal`; single-scheduler path), durable
    idempotency-cache snapshots (``idempotency.json``), and — for elastic
    fleets — a disk-backed PageStore spill tier (``pages/``).  A
    relaunched server replays unresolved journal entries through normal
    admission and serves already-answered ones from the snapshot as
    ``idempotent_replay``.  Unset (the default), the serving path is
    byte-identical to the non-durable build (pinned in
    tests/test_torch_durability.py).

    ``fault_plan`` (chaos testing) and ``supervise`` layer the
    fault-tolerance stack over the engine via
    :func:`consensus_tpu_torch.backends.wrap_backend`; a supervised engine's
    circuit breaker is picked up by the scheduler's admission control and
    surfaced in ``/healthz``.

    ``brownout=True`` installs a :class:`BrownoutController`: under load
    pressure, newly dispatched requests run at a scaled-down search budget
    (responses tagged ``degraded``) instead of queueing into 504s.
    ``target_p95_ms`` adds a latency-SLO term to the pressure signal.

    The continuous-batching decode engine is the DEFAULT merge layer:
    byte-identical results to the legacy flush path, no flush barrier,
    and /healthz gains slot-table + KV-page-pool pressure.
    ``engine=False`` (``--no-engine`` on the CLI) opts back into the
    legacy flush-snapshot BatchingBackend.

    ``fleet_size > 1`` (or any ``fleet_options``) builds N full replica
    stacks — each with its OWN backend instance, kill switch, supervisor +
    breaker, optional brownout controller, and scheduler — behind a
    :class:`FleetRouter` (health-gated routing, scenario affinity,
    transparent failover, optional hedging and tier routing).
    ``fleet_options`` keys: ``tiers`` (per-replica tier names; first tier
    listed is the default/full tier), ``tier_backend_options`` (dict tier →
    backend kwargs, e.g. a smaller model for the ``small`` tier),
    ``fault_plans`` (per-replica FaultPlan list for chaos runs),
    ``engine`` (per-replica bool list overriding the global ``engine``
    flag — the flush-vs-engine merge layer is chosen PER REPLICA),
    ``hedge_after_s``, ``probe_interval_s``, ``probe_timeout_s``,
    ``tier_enter_pressure``, ``tier_exit_pressure``, ``tier_min_dwell_s``.

    Elastic fleets (``fleet_options["elastic"]=True``) additionally get a
    :class:`~consensus_tpu_torch.serve.fleet.ReplicaManager` (respawn lost
    replicas under the same name with warm prefix-KV handoff through a
    fleet :class:`~consensus_tpu_torch.serve.pagestore.PageStore`, flap
    quarantine, target-count reconciliation; knobs via
    ``fleet_options["elastic_options"]``) and, with
    ``fleet_options["autoscale"]`` (True or an options dict), an
    :class:`~consensus_tpu_torch.serve.autoscale.Autoscaler` driving the
    manager's target from brownout pressure.
    ``fleet_options["watchdog_timeout_s"]`` arms each replica engine's
    hang watchdog (a dispatch wedged that long latches ``backend_lost``,
    so the ladder — and the manager — treat the hang as a loss).

    With ``fleet_size=1`` and no ``fleet_options`` the router is bypassed
    entirely — the server runs the exact single-scheduler path below, so
    responses stay byte-identical to that path (pinned in
    tests/test_torch_fleet.py).

    ``mesh`` (``"dp=4,tp=1"``, ``{'dp': 4, 'tp': 1}`` or a
    :class:`~consensus_tpu_torch.parallel.mesh.MeshPlan`) makes the device
    mesh the serving path: the resident backend is built over the dp
    shards' cards and the decode engine partitions its slot table and page
    pools over them (``--mesh`` on the CLI).  Other backends only see the
    engine-side partitioning.  ``tp > 1`` raises (ROADMAP.md, queue A15).

    ``telemetry=True`` installs a
    :class:`~consensus_tpu_torch.obs.welfare.ServeTelemetry` sink: latency and
    welfare quantile sketches (mergeable, replica-labelled), per-tier
    degraded-vs-full welfare-gap gauges, and the fairness drift detector.
    ``slo=True`` (or a sequence of spec dicts) runs an
    :class:`~consensus_tpu_torch.obs.slo.SLOEngine` over the request stream plus
    polled ``kv_headroom``/``welfare_drift`` signals, served at ``/v1/slo``
    and inside ``/healthz``.  Both default OFF: with them off the serving
    path takes zero extra allocations and responses stay byte-identical
    (pinned in tests/test_torch_welfare_telemetry.py).

    Resilience/brownout/fleet features default OFF so a quiet server's
    responses stay byte-identical to offline Experiment runs (pinned in
    tests/test_torch_serve.py — the engine default keeps that identity)."""
    from consensus_tpu_torch.backends import get_backend, wrap_backend

    if mesh is not None:
        from consensus_tpu_torch.parallel.mesh import MeshPlan, parse_mesh_spec

        # A MeshPlan keeps its devices; any other spelling is parsed.
        mesh = mesh if isinstance(mesh, MeshPlan) else parse_mesh_spec(mesh)
        if backend in ("tpu", "torch"):
            backend_options = {"mesh": mesh, **dict(backend_options or {})}
        engine_options = {"mesh": mesh, **dict(engine_options or {})}

    telemetry_obj = None
    if telemetry:
        from consensus_tpu_torch.obs.welfare import ServeTelemetry, set_welfare_sink

        telemetry_obj = ServeTelemetry(
            registry=registry, **dict(telemetry_options or {})
        )
        set_welfare_sink(telemetry_obj)

    if fleet_size > 1 or fleet_options:
        return _create_fleet_server(
            backend=backend,
            backend_options=backend_options,
            host=host,
            port=port,
            max_queue_depth=max_queue_depth,
            max_inflight=max_inflight,
            default_timeout_s=default_timeout_s,
            max_retries=max_retries,
            flush_ms=flush_ms,
            generation_model=generation_model,
            registry=registry,
            fault_plan=fault_plan,
            supervise=supervise,
            brownout=brownout,
            target_p95_ms=target_p95_ms,
            anytime_margin_s=anytime_margin_s,
            engine=engine,
            engine_options=engine_options,
            fleet_size=max(1, fleet_size),
            fleet_options=dict(fleet_options or {}),
            telemetry_obj=telemetry_obj,
            slo=slo,
            slo_options=slo_options,
            state_dir=state_dir,
        )

    inner = get_backend(backend, **(backend_options or {}))
    if fault_plan is not None or supervise:
        inner = wrap_backend(
            inner, fault_plan=fault_plan, supervise=supervise,
            registry=registry,
        )
    controller = None
    if brownout:
        controller = BrownoutController(
            target_p95_s=(
                target_p95_ms / 1000.0 if target_p95_ms else None
            ),
            registry=registry,
        )
    service = ConsensusService(inner, generation_model=generation_model)
    wal = None
    idempotency = None
    if state_dir is not None:
        import pathlib

        from consensus_tpu_torch.serve.wal import RequestWAL

        state_path = pathlib.Path(state_dir)
        # snapshot_every=1: the WAL already fsyncs per record, so the
        # snapshot matching that cadence is what makes "crash after
        # resolve" deterministically replay from cache (not recompute).
        idempotency = IdempotencyCache(
            snapshot_path=state_path / "idempotency.json",
            snapshot_every=1)
        wal = RequestWAL(state_path, registry=registry)
    scheduler = RequestScheduler(
        handler=service.run,
        backend=inner,
        max_queue_depth=max_queue_depth,
        max_inflight=max_inflight,
        default_timeout_s=default_timeout_s,
        max_retries=max_retries,
        flush_ms=flush_ms,
        registry=registry,
        brownout=controller,
        anytime_margin_s=anytime_margin_s,
        engine=engine,
        engine_options=engine_options,
        telemetry=telemetry_obj,
        idempotency=idempotency,
        wal=wal,
    )
    slo_engine = _build_slo_engine(
        slo, slo_options, registry, scheduler.stats, telemetry_obj
    )
    return ConsensusServer(
        scheduler, host=host, port=port, registry=registry,
        slo_engine=slo_engine, telemetry=telemetry_obj,
    )


def _kv_headroom_signal(stats_fn):
    """Poll signal: min KV-page headroom across whatever ``stats_fn`` sees.

    Single-scheduler stats carry an ``engine`` block; router stats carry
    ``fleet.replicas.<name>.engine``.  Returns None (sample skipped) when
    no engine stats are available — e.g. the legacy flush path."""
    def signal():
        try:
            stats = stats_fn()
        except Exception:
            return None
        engine_stats = stats.get("engine")
        if isinstance(engine_stats, dict):
            value = engine_stats.get("kv_page_headroom")
            if value is not None:
                return value
        fleet = stats.get("fleet")
        if isinstance(fleet, dict):
            values = []
            for rep in fleet.get("replicas", {}).values():
                if not isinstance(rep, dict):
                    continue
                eng = rep.get("engine")
                if isinstance(eng, dict):
                    value = eng.get("kv_page_headroom")
                    if value is not None:
                        values.append(value)
            if values:
                return min(values)
        return None

    return signal


def _build_slo_engine(slo, slo_options, registry, stats_fn, telemetry_obj):
    """Construct the SLOEngine (or None when ``slo`` is falsy).

    ``slo`` is True (default specs) or a sequence of SLOSpec/spec dicts;
    ``slo_options`` passes through engine kwargs (``clock``,
    ``dump_blackbox``, extra ``signals`` — explicit signals win over the
    built-in ``kv_headroom``/``welfare_drift`` closures)."""
    if not slo:
        return None
    from consensus_tpu_torch.obs.slo import SLOEngine

    options = dict(slo_options or {})
    specs = options.pop("specs", None)
    if specs is None and slo is not True:
        specs = slo
    signals = dict(options.pop("signals", None) or {})
    signals.setdefault("kv_headroom", _kv_headroom_signal(stats_fn))
    if telemetry_obj is not None:
        signals.setdefault("welfare_drift", telemetry_obj.drift_status)
    return SLOEngine(
        specs=specs, registry=registry, signals=signals, **options
    )


def _create_fleet_server(
    *,
    backend,
    backend_options,
    host,
    port,
    max_queue_depth,
    max_inflight,
    default_timeout_s,
    max_retries,
    flush_ms,
    generation_model,
    registry,
    fault_plan,
    supervise,
    brownout,
    target_p95_ms,
    anytime_margin_s,
    engine,
    engine_options,
    fleet_size,
    fleet_options,
    telemetry_obj=None,
    slo=False,
    slo_options=None,
    state_dir=None,
):
    """Build N replica stacks behind a :class:`FleetRouter`.

    Every replica gets its OWN backend instance (``get_backend`` with
    ``fresh=True`` — cached instances would alias one device across
    "replicas" and a single injected loss would kill them all), its own
    breaker/supervisor (supervision defaults ON for fleets: the breaker is
    the router's passive health signal), and optionally its own brownout
    controller.  Scalar ``fault_plan`` arms every replica identically;
    ``fleet_options["fault_plans"]`` is a per-replica list (``None``
    entries = no chaos on that replica).  Chaos plans arm a replica's
    FIRST life only: a respawned name gets a clean backend, so a
    deterministic kill cannot respawn-loop the fleet into quarantine.
    """
    from consensus_tpu_torch.backends import get_backend
    from consensus_tpu_torch.serve.fleet import _name_index

    tiers = fleet_options.get("tiers")
    if tiers is not None and len(tiers) != fleet_size:
        raise ValueError(
            f"fleet_options['tiers'] has {len(tiers)} entries for "
            f"fleet_size={fleet_size}"
        )
    tier_backend_options = fleet_options.get("tier_backend_options", {})
    fault_plans = fleet_options.get("fault_plans")
    if fault_plans is not None and len(fault_plans) != fleet_size:
        raise ValueError(
            f"fleet_options['fault_plans'] has {len(fault_plans)} entries "
            f"for fleet_size={fleet_size}"
        )
    engines = fleet_options.get("engine")
    if engines is not None and not isinstance(engines, (list, tuple)):
        engines = [engines] * fleet_size
    watchdog_timeout_s = fleet_options.get("watchdog_timeout_s")
    if watchdog_timeout_s is not None:
        engine_options = {
            "watchdog_timeout_s": watchdog_timeout_s,
            **dict(engine_options or {}),
        }

    built = set()  # names whose first life already consumed its fault plan

    # One fleet-shared completed-result cache: schedulers record terminal
    # results, the router consults it before failover re-dispatch — a
    # request that completed on a dying replica is re-delivered, never
    # re-executed (the zero-duplicates chaos invariant).  With a state
    # dir, the cache is durable: snapshots survive a full-fleet restart,
    # and the disk-backed PageStore (below) survives warm KV with it —
    # the fleet's durability story; the per-request WAL stays single-path
    # (one journal cannot have N replica writers).
    state_path = None
    if state_dir is not None:
        import pathlib

        state_path = pathlib.Path(state_dir)
        state_path.mkdir(parents=True, exist_ok=True)
    idempotency = IdempotencyCache(
        max_entries=fleet_options.get("idempotency_entries", 1024),
        snapshot_path=(
            state_path / "idempotency.json"
            if state_path is not None else None
        ),
    )

    def replica_factory(name, tier=None):
        """Build one UNSTARTED replica stack.  Used for the initial fleet
        AND by the ReplicaManager for respawns/scale-ups — the one place
        the full stack recipe lives."""
        i = _name_index(name)
        if tier is None:
            tier = (
                tiers[i] if tiers is not None and 0 <= i < len(tiers)
                else "full"
            )
        options = dict(backend_options or {})
        options.update(tier_backend_options.get(tier, {}))
        inner = get_backend(backend, fresh=True, **options)
        controller = None
        if brownout:
            controller = BrownoutController(
                target_p95_s=(
                    target_p95_ms / 1000.0 if target_p95_ms else None
                ),
                registry=registry,
            )
        plan = None
        if name not in built:
            built.add(name)
            plan = (
                fault_plans[i]
                if fault_plans is not None and 0 <= i < len(fault_plans)
                else fault_plan
            )
        engine_flag = (
            engines[i] if engines is not None and 0 <= i < len(engines)
            else engine
        )
        return Replica(
            name=name,
            backend=inner,
            tier=tier,
            registry=registry,
            fault_plan=plan,
            supervise=supervise if supervise is not None else True,
            brownout=controller,
            generation_model=generation_model,
            scheduler_options={
                "max_queue_depth": max_queue_depth,
                "max_inflight": max_inflight,
                "default_timeout_s": default_timeout_s,
                "max_retries": max_retries,
                "flush_ms": flush_ms,
                "anytime_margin_s": anytime_margin_s,
                "engine": engine_flag,
                "engine_options": engine_options,
                "telemetry": telemetry_obj,
                "idempotency": idempotency,
            },
        )

    replicas = [replica_factory(f"r{i}") for i in range(fleet_size)]
    router = FleetRouter(
        replicas,
        registry=registry,
        default_timeout_s=default_timeout_s,
        hedge_after_s=fleet_options.get("hedge_after_s"),
        probe_interval_s=fleet_options.get("probe_interval_s", 1.0),
        probe_timeout_s=fleet_options.get("probe_timeout_s"),
        tier_enter_pressure=fleet_options.get("tier_enter_pressure", 0.85),
        tier_exit_pressure=fleet_options.get("tier_exit_pressure", 0.5),
        tier_min_dwell_s=fleet_options.get("tier_min_dwell_s", 2.0),
        idempotency_cache=idempotency,
    )

    autoscale = fleet_options.get("autoscale")
    transport_fault_plan = fleet_options.get("transport_fault_plan")
    if fleet_options.get("elastic") or autoscale or transport_fault_plan:
        from consensus_tpu_torch.serve.autoscale import Autoscaler
        from consensus_tpu_torch.serve.fleet import ReplicaManager
        from consensus_tpu_torch.serve.pagestore import PageStore

        elastic_options = dict(fleet_options.get("elastic_options") or {})
        # The PageStore ships page runs over the transport seam; a
        # transport_fault_plan wraps the loopback hub in the seeded
        # FaultyTransport so drops/corruption/partitions hit real traffic.
        transport = LoopbackTransport()
        if transport_fault_plan is not None:
            from consensus_tpu_torch.backends.faults import FaultPlan

            transport = FaultyTransport(
                transport,
                FaultPlan.from_spec(transport_fault_plan),
                registry=registry,
            )
        store_kwargs = {}
        if "page_store_chunk_bytes" in elastic_options:
            store_kwargs["chunk_bytes"] = elastic_options.pop(
                "page_store_chunk_bytes")
        disk_budget = elastic_options.pop(
            "page_store_disk_budget_bytes", None)
        if state_path is not None:
            store_kwargs["spill_dir"] = state_path / "pages"
            store_kwargs["disk_budget_bytes"] = disk_budget
        store = PageStore(
            max_runs=elastic_options.pop("page_store_runs", 256),
            registry=registry,
            transport=transport,
            lease_s=elastic_options.pop("page_store_lease_s", None),
            **store_kwargs,
        )
        manager = ReplicaManager(
            router,
            replica_factory,
            page_store=store,
            registry=registry,
            **elastic_options,
        )
        if autoscale:
            autoscale_options = (
                dict(autoscale) if isinstance(autoscale, dict) else {}
            )
            autoscale_options.setdefault("max_replicas", fleet_size * 2)
            Autoscaler(manager, registry=registry, **autoscale_options)

    slo_engine = _build_slo_engine(
        slo, slo_options, registry, router.stats, telemetry_obj
    )
    return ConsensusServer(
        router, host=host, port=port, registry=registry,
        slo_engine=slo_engine, telemetry=telemetry_obj,
        federate_metrics=telemetry_obj is not None,
    )
