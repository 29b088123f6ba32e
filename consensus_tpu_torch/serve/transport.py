"""Message transport seam: loopback impl + deterministic fault wrapper.

PyTorch port of ``consensus_tpu/serve/transport.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

Everything that moves between replicas — KV page-run shipping, fetches,
health probes — crosses this seam, so this is where partial transfers,
corrupt bytes, duplicate deliveries, and partitions are *made real* for
tests.  Two implementations:

* :class:`LoopbackTransport` — an in-process hub: peers register named op
  handlers, ``call(src, dst, op, msg)`` invokes the destination handler
  synchronously.  This is the fault-free seam the single-host fleet uses;
  a cross-host transport would implement the same three methods.
* :class:`FaultyTransport` — wraps any transport and injects faults from a
  seeded :class:`~consensus_tpu_torch.backends.faults.FaultPlan`, reusing the
  backend fault plan's addressing (``op``/``call_index``/``after_s``/
  ``rate``) for the transport ops ``ship`` / ``fetch`` / ``probe``:

  - ``latency`` — sleep ``latency_s`` before delivery.
  - ``drop`` — the message never arrives (:class:`TransportDropped`).
  - ``duplicate`` — the destination handler runs TWICE; the first response
    is discarded.  Handlers must be idempotent (PageStore's are).
  - ``reorder`` — delivery is delayed until the next call on the same
    route passes it (degenerates to extra latency for serial callers).
  - ``bit_flip`` — one deterministic bit of the message's ``data`` bytes
    (or of the response's, when the request carries none) is flipped:
    the corruption end-to-end hash verification exists to catch.
  - ``partition`` — scheduled window ``[after_s, after_s + duration_s)``
    during which every call to/from ``spec.peer`` (or every call at all,
    when ``peer`` is None) raises :class:`TransportPartitioned`.
    Bidirectional by construction: the hub sees both directions.

  Injections are counted in the same ``faults_injected_total{kind,op}``
  registry family the backend wrapper uses, so one scrape shows the whole
  scripted incident.

Messages are plain dicts.  By convention a payload's raw bytes ride under
``"data"`` (requests) or ``"data"`` in the response; ``bit_flip`` targets
whichever side carries bytes so both ship (client->store) and fetch
(store->client) directions are corruptible.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from consensus_tpu_torch.backends.faults import (
    FaultPlan,
    TRANSPORT_OPS,
    _hash_unit,
)
from consensus_tpu_torch.obs.metrics import Registry, get_registry

Message = Dict[str, Any]
Handler = Callable[[Message], Message]


class TransportError(RuntimeError):
    """Base class for transport-seam failures."""


class TransportDropped(TransportError):
    """The message was dropped in flight (injected or real loss)."""


class TransportTimeout(TransportError):
    """The peer did not answer in time."""


class TransportPartitioned(TransportError):
    """The route is inside a scheduled partition window."""


class LoopbackTransport:
    """In-process hub: named peers expose op handlers; calls are local.

    ``register(peer, handlers)`` binds ``{op: callable}`` for a peer;
    ``call(src, dst, op, msg)`` runs ``dst``'s handler for ``op``
    synchronously and returns its response dict.  Unknown destinations or
    ops raise :class:`TransportError` — the same failure shape a remote
    transport would surface for an unreachable or incompatible peer.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: Dict[str, Dict[str, Handler]] = {}

    def register(self, peer: str, handlers: Dict[str, Handler]) -> None:
        with self._lock:
            self._peers[peer] = dict(handlers)

    def unregister(self, peer: str) -> None:
        with self._lock:
            self._peers.pop(peer, None)

    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._peers)

    def call(self, src: str, dst: str, op: str, msg: Message) -> Message:
        with self._lock:
            handlers = self._peers.get(dst)
        if handlers is None:
            raise TransportError(f"unknown peer {dst!r}")
        handler = handlers.get(op)
        if handler is None:
            raise TransportError(f"peer {dst!r} has no handler for op {op!r}")
        return handler(msg)


class FaultyTransport:
    """Wrap ``inner`` and inject the plan's transport faults into calls.

    Wraps the HUB, not one endpoint: every ``(src, dst)`` pair's traffic
    crosses this object, which is what makes ``partition`` specs
    bidirectional — during the window, calls where EITHER end is the
    partitioned peer fail.  Per-op call indices and the plan seed make
    every injection deterministic given the call order.
    """

    def __init__(
        self,
        inner: Union[LoopbackTransport, "FaultyTransport"],
        plan: Union[FaultPlan, Dict[str, Any], str, None],
        registry: Optional[Registry] = None,
        sleep=time.sleep,
        clock=time.monotonic,
    ) -> None:
        self.inner = inner
        self.plan = FaultPlan.from_spec(plan) or FaultPlan()
        self._sleep = sleep
        self._clock = clock
        self.t0 = clock()
        self._lock = threading.Lock()
        self._call_index = {op: 0 for op in TRANSPORT_OPS}
        #: Parked (reorder) messages keyed by route; each entry is released
        #: by the next call on the same route or by its deadline passing.
        self._parked: Dict[Tuple[str, str], float] = {}
        self._windows = self.plan.partition_windows()
        reg = registry if registry is not None else get_registry()
        self._injected = reg.counter(
            "faults_injected_total",
            "Faults injected by the fault-injection backend, by kind and op.",
            labels=("kind", "op"),
        )

    # -- introspection -------------------------------------------------------

    def peers(self) -> List[str]:
        return self.inner.peers()

    def partition_windows(self) -> List[Tuple[Optional[str], float, float]]:
        """Scheduled partitions as absolute ``(peer, start, end)`` on this
        wrapper's monotonic clock — recovery-time math reads this."""
        return [
            (peer, self.t0 + start, self.t0 + end)
            for peer, start, end in self._windows
        ]

    def partitioned(self, src: str, dst: str,
                    now: Optional[float] = None) -> bool:
        """Is the (src, dst) route inside a partition window right now?"""
        elapsed = (now if now is not None else self._clock()) - self.t0
        for peer, start, end in self._windows:
            if not start <= elapsed < end:
                continue
            if peer is None or peer == src or peer == dst:
                return True
        return False

    # -- registration passthrough -------------------------------------------

    def register(self, peer: str, handlers: Dict[str, Handler]) -> None:
        self.inner.register(peer, handlers)

    def unregister(self, peer: str) -> None:
        self.inner.unregister(peer)

    # -- injection core ------------------------------------------------------

    def _next_index(self, op: str) -> int:
        with self._lock:
            index = self._call_index.setdefault(op, 0)
            self._call_index[op] = index + 1
            return index

    @staticmethod
    def _flip_bit(data: bytes, seed: int, index: int) -> bytes:
        if not data:
            return data
        pos = int(_hash_unit(seed, "bit_flip", index) * len(data) * 8)
        pos = min(pos, len(data) * 8 - 1)
        out = bytearray(data)
        out[pos // 8] ^= 1 << (pos % 8)
        return bytes(out)

    def call(self, src: str, dst: str, op: str, msg: Message) -> Message:
        index = self._next_index(op)
        now = self._clock()
        if self.partitioned(src, dst, now):
            self._injected.labels("partition", op).inc()
            raise TransportPartitioned(
                f"route {src}->{dst} partitioned (op={op}, call={index})"
            )
        specs = self.plan.firing(op, index, now - self.t0)
        duplicate = False
        corrupt_request = corrupt_response = False
        for spec in specs:
            if spec.kind == "latency":
                self._injected.labels("latency", op).inc()
                self._sleep(spec.latency_s)
            elif spec.kind == "drop":
                self._injected.labels("drop", op).inc()
                raise TransportDropped(
                    f"message {src}->{dst} dropped (op={op}, call={index})"
                )
            elif spec.kind == "transient_error":
                self._injected.labels("transient_error", op).inc()
                raise TransportError(
                    f"injected transport fault (op={op}, call={index})"
                )
            elif spec.kind == "timeout_error":
                self._injected.labels("timeout_error", op).inc()
                raise TransportTimeout(
                    f"injected transport timeout (op={op}, call={index})"
                )
            elif spec.kind == "duplicate":
                self._injected.labels("duplicate", op).inc()
                duplicate = True
            elif spec.kind == "reorder":
                # Park this delivery until the next call on the same route
                # has gone first (bounded by a short deadline so a serial
                # caller sees plain extra latency, not a deadlock).
                self._injected.labels("reorder", op).inc()
                route = (src, dst)
                with self._lock:
                    self._parked[route] = now + 0.05
                deadline = now + 0.05
                while self._clock() < deadline:
                    with self._lock:
                        if self._parked.get(route, 0.0) <= self._clock():
                            break
                    self._sleep(0.005)
                with self._lock:
                    self._parked.pop(route, None)
            elif spec.kind == "bit_flip":
                self._injected.labels("bit_flip", op).inc()
                if isinstance(msg.get("data"), (bytes, bytearray)):
                    corrupt_request = True
                else:
                    corrupt_response = True
            # Backend-only kinds (nan/inf/truncate/device_lost/hang) have
            # no transport meaning; ignore them so one plan can address
            # both domains.
        # A later call on a parked route releases the parked one first.
        with self._lock:
            for route in list(self._parked):
                if route == (src, dst):
                    self._parked[route] = 0.0
        if corrupt_request:
            msg = dict(msg, data=self._flip_bit(
                bytes(msg["data"]), self.plan.seed, index))
        if duplicate:
            self.inner.call(src, dst, op, msg)
        response = self.inner.call(src, dst, op, msg)
        if corrupt_response and isinstance(
                response.get("data"), (bytes, bytearray)):
            response = dict(response, data=self._flip_bit(
                bytes(response["data"]), self.plan.seed, index))
        return response
