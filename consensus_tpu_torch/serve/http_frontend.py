"""Stdlib-only HTTP front end for the consensus scheduler or the fleet
router (PyTorch port of ``consensus_tpu/serve/http_frontend.py``).

``ThreadingHTTPServer`` (one thread per connection, stdlib, no new
dependencies) in front of :class:`RequestScheduler`:

* ``POST /v1/consensus`` — validate → admit → wait → respond.  Errors are
  structured JSON (``{"error": {"type", "message", ...}}``) with the HTTP
  status carrying the overload semantics: 400 validation, 413 KV-footprint
  too large for the engine's page pool (``kv_oom`` — not retryable), 429
  admission rejection (with ``Retry-After``), 503 circuit-breaker open
  (``Retry-After`` = breaker cooldown), 504 deadline expiry with NO
  completed search wave (``Retry-After`` hint attached), 500 terminal
  backend failure.  A deadline expiry where at least one wave completed
  returns **200** with the anytime partial and ``"degraded": true`` —
  graceful degradation trades answer quality for availability, never the
  other way around.
* ``GET /healthz`` — queue depth, in-flight count, drain state, backend
  liveness, device-batch accounting (the coalescing proof surface).
* ``GET /metrics`` — Prometheus text exposition straight from the obs
  registry (the ``serve_*`` families plus everything the backends record).
  With welfare telemetry on a fleet, the snapshot is federated first
  (``obs/sketch.py``): per-replica sketches merge into exact
  ``replica="fleet"`` series.
* ``GET /v1/slo`` — burn rates, states, and the transition log from the
  SLO engine (404 when the server was built without ``slo=True``); the
  ``/healthz`` payload gains ``slo`` and ``welfare`` blocks when those
  planes are armed.
* ``GET /v1/trace/<request_id>`` — recent span trees; every response
  (success or structured error) echoes a ``request_id`` so sketch
  exemplars and error bodies alike are trace-addressable.

Handler threads block on their ticket while the scheduler's worker pool —
not the connection pool — bounds device work; a handler thread waiting on
an admitted ticket costs one parked thread, nothing on device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.obs.trace import TraceContext, get_trace_store, use_trace
from consensus_tpu_torch.serve.scheduler import (
    RequestScheduler,
    RequestTimeout,
    SchedulerRejected,
)
from consensus_tpu_torch.serve.service import RequestValidationError, parse_request

logger = logging.getLogger(__name__)

#: Grace period past the request deadline before the handler gives up on
#: its ticket — covers scheduler bookkeeping so the worker, not the
#: handler's stopwatch, decides borderline timeouts.
_WAIT_GRACE_S = 0.25
#: After cancelling an expired ticket, how long the handler lingers for the
#: worker to surface an anytime partial (the method notices the expired
#: BudgetClock at its next checkpoint — at most one wave away — and returns
#: best-so-far tagged ``degraded``).  Only when NO wave completed does the
#: 504 fire.
_DEGRADED_GRACE_S = 2.0
#: Ticket wait for requests with no deadline at all.
_UNBOUNDED_WAIT_S = 3600.0
#: Retry-After hint on 504s: the deadline was the client's own budget, so
#: there is no server cooldown to report — suggest a short backoff.
_TIMEOUT_RETRY_AFTER_S = 1

#: Server-minted request ids: a process-local sequence for uniqueness plus
#: a payload digest for determinism, so the same omitted-id request body
#: always maps to the same digest suffix and every response — success or
#: error — is trace-addressable.
_MINT_SEQ = itertools.count(1)


def _mint_request_id(payload: Any) -> str:
    try:
        canonical = json.dumps(payload, sort_keys=True, default=str)
    except (TypeError, ValueError):
        canonical = repr(payload)
    digest = hashlib.blake2b(
        canonical.encode("utf-8"), digest_size=4
    ).hexdigest()
    return f"srv-{next(_MINT_SEQ):06d}-{digest}"


class ConsensusHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the scheduler + registry for handlers."""

    daemon_threads = True

    def __init__(
        self,
        address: Tuple[str, int],
        scheduler: RequestScheduler,
        registry: Optional[Registry] = None,
        slo_engine: Optional[Any] = None,
        telemetry: Optional[Any] = None,
        federate_metrics: bool = False,
    ):
        super().__init__(address, ConsensusRequestHandler)
        self.scheduler = scheduler
        self.registry = registry if registry is not None else get_registry()
        #: Optional obs.slo.SLOEngine — fed one event per terminal HTTP
        #: response, served at GET /v1/slo and in the /healthz slo block.
        self.slo_engine = slo_engine
        #: Optional obs.welfare.ServeTelemetry (for the /healthz welfare
        #: block; the schedulers hold their own reference for recording).
        self.telemetry = telemetry
        #: Fleet mode: /metrics federates per-replica sketch/counter
        #: series into additional replica="fleet" series (obs/sketch.py).
        self.federate_metrics = federate_metrics


class ConsensusRequestHandler(BaseHTTPRequestHandler):
    server: ConsensusHTTPServer
    protocol_version = "HTTP/1.1"

    # -- routing -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        if self.path == "/healthz":
            self._send_json(200, self._health_payload())
        elif self.path == "/metrics":
            if self.server.federate_metrics:
                from consensus_tpu_torch.obs.metrics import prometheus_text
                from consensus_tpu_torch.obs.sketch import federate_snapshot

                text = prometheus_text(
                    federate_snapshot(self.server.registry.snapshot())
                )
            else:
                text = self.server.registry.to_prometheus()
            self._send_bytes(
                200, text.encode("utf-8"), "text/plain; version=0.0.4"
            )
        elif self.path == "/v1/slo":
            engine = self.server.slo_engine
            if engine is None:
                self._send_error_json(
                    404, "slo_disabled",
                    "no SLO engine attached (create_server(slo=True))")
            else:
                self._send_json(200, engine.evaluate())
        elif self.path.startswith("/v1/trace/"):
            trace_id = urllib.parse.unquote(self.path[len("/v1/trace/"):])
            trace = get_trace_store().get(trace_id)
            if trace is None:
                self._send_error_json(
                    404, "trace_not_found",
                    f"no trace retained for request id {trace_id!r}")
            else:
                payload = trace.to_dict()
                payload["critical_path"] = trace.critical_path()
                self._send_json(200, payload)
        else:
            self._send_error_json(404, "not_found",
                                  f"no route for GET {self.path}")

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/consensus":
            self._send_error_json(404, "not_found",
                                  f"no route for POST {self.path}")
            return
        try:
            payload = self._read_json()
        except ValueError as exc:
            self._send_error_json(400, "bad_json", str(exc))
            return
        try:
            request = parse_request(payload)
        except RequestValidationError as exc:
            # Even a rejected-at-the-door request gets a request id (the
            # client's own, else a minted one): EVERY structured error
            # response is trace-addressable.
            supplied = (
                str(payload.get("request_id") or "")
                if isinstance(payload, dict) else ""
            )
            self._send_json(400, {"error": {
                "type": "validation",
                "message": "request failed validation",
                "details": exc.errors,
                "request_id": supplied or _mint_request_id(payload),
            }})
            return
        if not request.request_id:
            # Server-side mint: every response (success or error) carries a
            # request id, so every request is trace-addressable.
            request = dataclasses.replace(
                request, request_id=_mint_request_id(payload))
        request_id = request.request_id
        trace = TraceContext(request_id)
        root = trace.begin(
            "http_request", method=request.method, path=self.path,
            request_id=request_id)
        get_trace_store().put(trace)
        scheduler = self.server.scheduler
        status = 500
        degraded = False
        started = time.monotonic()
        try:
            try:
                with use_trace(trace, root):
                    ticket = scheduler.submit(request)
            except SchedulerRejected as exc:
                status = self._send_rejection(exc, request_id=request_id)
                return
            remaining = ticket.remaining()
            wait_s = (
                remaining + _WAIT_GRACE_S if remaining is not None
                else _UNBOUNDED_WAIT_S
            )
            if not ticket.wait(timeout=max(0.0, wait_s)):
                # Cooperative cancellation: a queued ticket dies at pop; a
                # running one sees the expired BudgetClock (or the dropped
                # batch entry) at its next checkpoint and returns its
                # best-so-far statement tagged ``degraded`` — so linger
                # briefly for that partial before conceding a 504.  Anytime
                # over unavailable.
                ticket.cancel()
                if not ticket.wait(timeout=_DEGRADED_GRACE_S):
                    status = 504
                    self._send_error_json(
                        504, "timeout",
                        "deadline expired before any search wave completed",
                        headers={"Retry-After": str(_TIMEOUT_RETRY_AFTER_S)},
                        request_id=request_id)
                    return
            try:
                result = ticket.result()
            except RequestTimeout as exc:
                status = 504
                self._send_error_json(
                    504, "timeout", str(exc),
                    headers={"Retry-After": str(_TIMEOUT_RETRY_AFTER_S)},
                    request_id=request_id)
                return
            except SchedulerRejected as exc:
                status = self._send_rejection(exc, request_id=request_id)
                return
            except Exception as exc:
                status = 500
                self._send_json(500, {"error": {
                    "type": "backend_failure",
                    "exception": type(exc).__name__,
                    "message": str(exc),
                    "attempts": ticket.attempts,
                    "request_id": request_id,
                }})
                return
            status = 200
            degraded = isinstance(result, dict) and bool(
                result.get("degraded"))
            # End the root BEFORE snapshotting so the debug block's
            # critical path covers the full served latency.
            trace.end(root, status=200)
            if request.trace:
                result = dict(result)
                result["trace"] = {
                    "trace_id": trace.trace_id,
                    "critical_path": trace.critical_path(),
                    "spans": trace.to_dict()["spans"],
                }
            self._send_json(200, result)
        finally:
            trace.end(root, status=status)
            engine = self.server.slo_engine
            if engine is not None:
                # One terminal event per response: 2xx (degraded or not)
                # counts as served; 4xx/5xx past admission burns budget.
                engine.record_request(
                    ok=status == 200,
                    latency_s=time.monotonic() - started,
                    degraded=degraded,
                )

    # -- helpers -----------------------------------------------------------

    def _send_rejection(self, exc: SchedulerRejected,
                        request_id: Optional[str] = None) -> int:
        """Admission rejections: 503 for an open circuit breaker (the
        backend is down — clients should back off for its cooldown), 413
        for a request whose KV footprint exceeds the engine's page pool
        (the REQUEST is too large — retrying unchanged can never succeed,
        so no Retry-After), 429 for overload (queue_full/draining — retry
        soon elsewhere).  Returns the status sent so the caller can stamp
        it on the trace root."""
        if exc.reason == "breaker_open":
            status = 503
        elif exc.reason == "kv_oom":
            status = 413
        else:
            status = 429
        headers = None
        if status != 413:
            retry_after = (
                exc.retry_after_s if exc.retry_after_s is not None else 1
            )
            headers = {"Retry-After": str(int(max(1, retry_after)))}
        error: Dict[str, Any] = {
            "type": "rejected",
            "reason": exc.reason,
            "message": str(exc),
        }
        if request_id:
            error["request_id"] = request_id
        self._send_json(status, {"error": error}, headers=headers)
        return status

    def _health_payload(self) -> Dict[str, Any]:
        scheduler = self.server.scheduler
        stats = scheduler.stats()
        inner = scheduler.inner_backend
        if stats["draining"]:
            stats["status"] = "draining"
        elif (
            "fleet" in stats
            and stats["fleet"]["healthy"] < stats["fleet"]["size"]
        ):
            # Fleet-aggregated health: still serving, but with reduced
            # redundancy — per-replica tier/breaker/brownout/occupancy is
            # in stats["fleet"]["replicas"].
            stats["status"] = "degraded"
        else:
            stats["status"] = "ok"
        stats["backend"] = {
            "name": getattr(inner, "name", type(inner).__name__),
            "model": getattr(inner, "model_name", ""),
            "alive": stats["workers_alive"] > 0,
        }
        engine = self.server.slo_engine
        if engine is not None:
            engine.evaluate()
            stats["slo"] = engine.states()
        telemetry = self.server.telemetry
        if telemetry is not None:
            stats["welfare"] = telemetry.snapshot()
        return stats

    def _read_json(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValueError("empty request body (Content-Length required)")
        raw = self.rfile.read(length)
        try:
            return json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"request body is not valid JSON: {exc}") from exc

    def _send_json(self, status: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self._send_bytes(status, body, "application/json", headers)

    def _send_error_json(self, status: int, error_type: str, message: str,
                         headers: Optional[Dict[str, str]] = None,
                         request_id: Optional[str] = None) -> None:
        error: Dict[str, Any] = {"type": error_type, "message": message}
        if request_id:
            error["request_id"] = request_id
        self._send_json(status, {"error": error}, headers=headers)

    def _send_bytes(self, status: int, body: bytes, content_type: str,
                    headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("%s - %s", self.address_string(), format % args)


class ConsensusServer:
    """Scheduler + HTTP front end with a test-friendly lifecycle.

    ``start()`` binds (port 0 → ephemeral), spawns the serve loop thread
    and the scheduler workers; ``stop()`` drains the scheduler and closes
    the socket.  ``base_url`` is where clients (and the load generator)
    point."""

    def __init__(
        self,
        scheduler: RequestScheduler,
        host: str = "127.0.0.1",
        port: int = 8080,
        registry: Optional[Registry] = None,
        slo_engine: Optional[Any] = None,
        telemetry: Optional[Any] = None,
        federate_metrics: bool = False,
    ):
        self.scheduler = scheduler
        self.slo_engine = slo_engine
        self.telemetry = telemetry
        self._httpd = ConsensusHTTPServer(
            (host, port),
            scheduler,
            registry,
            slo_engine=slo_engine,
            telemetry=telemetry,
            federate_metrics=federate_metrics,
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def base_url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ConsensusServer":
        self.scheduler.start()
        wal = getattr(self.scheduler, "wal", None)
        if wal is not None:
            # Crash recovery: re-admit the previous life's unresolved
            # journal entries through normal admission BEFORE the HTTP
            # socket takes new traffic.  Entries whose answers survived
            # in the durable idempotency snapshot resolve instantly as
            # idempotent replays; the rest recompute (byte-identical —
            # everything is (prompt, seed)-keyed).
            from consensus_tpu_torch.serve.wal import replay_unresolved

            replayed = replay_unresolved(wal, self.scheduler)
            if replayed:
                logger.info(
                    "replayed %d unresolved journal entries", replayed)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        logger.info("consensus server listening on %s", self.base_url)
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        self.scheduler.shutdown(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "ConsensusServer":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()
