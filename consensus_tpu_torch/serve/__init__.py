"""Online serving: scheduler + service + HTTP front end (PyTorch port of
``consensus_tpu/serve``, its single-replica server).

The layering, front to back:

    HTTP handler threads      http_frontend.ConsensusHTTPServer
      └─ admission + queue    scheduler.RequestScheduler (bounded FIFO,
         └─ worker pool          deadlines, retry, drain, breaker admission)
            └─ decode+score   service.ConsensusService (GENERATOR_MAP)
               └─ merge layer backends.batching.BatchingBackend (shared;
                  │              the continuous-batching DecodeEngine by
                  │              default)
                  └─ stack    supervisor(faults(backend)) when armed
                     └─ backend  FakeBackend / TorchBackend

``python -m consensus_tpu_torch.serve --backend fake`` runs a hardware-free
server; ``--backend torch`` (or ``tpu``) serves the resident
``TorchBackend`` on the card.  The fleet (router, replicas, page store,
transport, autoscaler, load generator), the request WAL (``state_dir``),
the welfare telemetry and SLO planes, and speculative engine windows wait
for queue A8 and raise ``NotImplementedError``; ``mesh`` waits for A9.
"""

from consensus_tpu_torch.serve.brownout import BrownoutController  # noqa: F401
from consensus_tpu_torch.serve.http_frontend import ConsensusServer  # noqa: F401
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


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"serving option {option} is not ported yet (ROADMAP.md, queue {item})"
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
    """Wire backend → service → scheduler → HTTP server (not yet started):
    the single-replica path of ``consensus_tpu/serve/__init__.py``.

    ``backend`` is a name (``fake``, the default as in the JAX package;
    ``torch`` / ``tpu`` for the resident ``TorchBackend``, on the card
    unless ``backend_options["device"]`` names another device) or a Backend
    instance, which is used as it is.

    ``fault_plan`` (chaos testing) and ``supervise`` layer the
    fault-tolerance stack over the backend via
    :func:`consensus_tpu_torch.backends.wrap_backend`; a supervised
    backend's circuit breaker is picked up by the scheduler's admission
    control (503 while open) and surfaced in ``/healthz``.

    ``brownout=True`` installs a :class:`BrownoutController`: under load
    pressure, newly dispatched requests run at a scaled-down search budget
    (responses tagged ``degraded``) instead of queueing into 504s.
    ``target_p95_ms`` adds a latency-SLO term to the pressure signal.

    The continuous-batching decode engine is the DEFAULT merge layer
    (``engine_options`` reach ``DecodeEngine``: ``slots``, ``page_size``,
    ``decode_steps``, ``prefix_cache``, ``watchdog_timeout_s``, ...);
    ``engine=False`` (``--no-engine`` on the CLI) takes the flush-snapshot
    ``BatchingBackend``.

    Left out, each raising ``NotImplementedError`` naming its queue item:
    ``fleet_size > 1`` / ``fleet_options``, ``telemetry``, ``slo`` and
    ``state_dir`` (A8), ``mesh`` (A9)."""
    from consensus_tpu_torch.backends import get_backend, wrap_backend

    if mesh is not None:
        raise _not_ported("mesh (the data-parallel serving mesh)", "A9")
    if fleet_size > 1 or fleet_options:
        raise _not_ported("fleet_size / fleet_options (the replica fleet)", "A8")
    if telemetry or telemetry_options:
        raise _not_ported("telemetry (obs/welfare.py)", "A8")
    if slo or slo_options:
        raise _not_ported("slo (obs/slo.py)", "A8")
    if state_dir is not None:
        raise _not_ported("state_dir (the request WAL, serve/wal.py)", "A8")

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
    )
    return ConsensusServer(scheduler, host=host, port=port, registry=registry)
