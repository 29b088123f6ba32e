"""Deterministic fault injection: the test substrate for every failure path.

Nothing in a failure path can be trusted until it has been exercised, and
real devices fail unreproducibly.  :class:`FaultInjectingBackend` wraps any
:class:`~consensus_tpu_torch.backends.base.Backend` and injects faults from a
seeded :class:`FaultPlan` — the SAME plan against the same workload injects
the SAME faults at the same call indices, so chaos tests are as
reproducible as golden tests.

Fault kinds (``FaultSpec.kind``):

* ``transient_error`` / ``timeout_error`` — raise ``RuntimeError`` /
  ``TimeoutError`` BEFORE the inner call (the raw exception types flaky
  transports actually raise; the supervisor must classify them).
* ``nan_logprobs`` / ``inf_logprobs`` — poison one row (or all rows) of a
  ``score`` / ``next_token_logprobs`` result with NaN / +Inf.
* ``truncate`` — cut a generation's text in half and mark it
  ``finish_reason="length"``.
* ``latency`` — sleep ``latency_s`` before the inner call.
* ``device_lost`` — from the firing call onward, EVERY call raises
  :class:`~consensus_tpu_torch.backends.base.BackendLostError` (a lost device
  does not come back).
* ``hang`` — block the call FOREVER (until :meth:`release_hangs`): the one
  failure mode nothing above can classify, because nothing raises.  A hung
  collective or wedged host runtime looks exactly like this — the call
  simply never returns — and it is what the decode engine's hang watchdog
  exists to convert into a recoverable ``backend_lost``.  Hung threads are
  daemon threads by serving convention; tests call ``release_hangs()`` at
  teardown to unstick them.

Transport-plane kinds (``drop``, ``duplicate``, ``reorder``, ``bit_flip``,
``partition``) share this spec/plan/seed machinery but are applied by
``serve.transport.FaultyTransport`` against the transport ops (``ship``,
``fetch``, ``probe``); the backend wrapper ignores them, so ONE seeded plan
can script a whole incident across both domains.

Firing is per-op and per-call-index: ``call_index`` pins a spec to the
N-th call of that op (exact), ``after_s`` pins it to the first matching
call at/after that much wall-clock time since backend construction (the
replica-loss spec fleet chaos runs arm per replica), and ``rate`` fires
pseudo-randomly via a seeded hash of
``(plan seed, spec index, op, call index)`` — deterministic given the
call order.  Injections are counted in ``faults_injected_total{kind,op}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from consensus_tpu_torch.backends.base import (
    Backend,
    BackendLostError,
    GenerationRequest,
    GenerationResult,
    NextTokenRequest,
    ScoreRequest,
    ScoreResult,
    TokenCandidate,
)
from consensus_tpu_torch.obs.metrics import Registry, get_registry

#: Backend protocol ops (the original injection surface).
BACKEND_OPS = ("generate", "score", "next_token", "embed")

#: Transport-plane ops (``serve/transport.py``): page-run shipping,
#: fetching, and the health probe.  One seeded plan can address both
#: domains — a spec with ``op="ship"`` simply never matches a backend
#: call, and a backend-only kind firing on a transport op is ignored by
#: the transport wrapper.
TRANSPORT_OPS = ("ship", "fetch", "probe")

#: Ops fault specs can target (``"*"`` matches all of them).
OPS = BACKEND_OPS + TRANSPORT_OPS

FAULT_KINDS = (
    "transient_error",
    "timeout_error",
    "nan_logprobs",
    "inf_logprobs",
    "truncate",
    "latency",
    "device_lost",
    "hang",
    # Transport-plane kinds (applied by ``serve.transport.FaultyTransport``;
    # ignored by the backend wrapper):
    "drop",
    "duplicate",
    "reorder",
    "bit_flip",
    "partition",
)

#: Kinds only the transport wrapper knows how to apply.
TRANSPORT_KINDS = ("drop", "duplicate", "reorder", "bit_flip", "partition")


def _hash_unit(*parts) -> float:
    """Deterministic float in [0, 1) from the fault plan's hash space."""
    h = hashlib.blake2b(digest_size=8)
    for part in parts:
        h.update(str(part).encode("utf-8", "replace"))
        h.update(b"\x1f")
    return int.from_bytes(h.digest(), "big") / 2**64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule: what to inject, into which op, and when."""

    kind: str
    op: str = "*"  # generate | score | next_token | embed | *
    #: Exact per-op call index to fire at (0-based).  Mutually exclusive
    #: with ``rate`` in spirit; when set, ``rate`` is ignored.
    call_index: Optional[int] = None
    #: Fire on the first matching call at/after this many wall-clock
    #: seconds since the backend was constructed (checked after
    #: ``call_index``, before ``rate``).  With ``kind="device_lost"`` this
    #: is the "replica lost after N seconds" chaos spec: deterministic per
    #: replica given its own FaultInjectingBackend and clock.
    after_s: Optional[float] = None
    #: Seeded per-call firing probability when ``call_index`` is None.
    rate: float = 0.0
    #: Row to poison for nan/inf/truncate faults (None = every row).
    row_index: Optional[int] = None
    #: Added delay for ``latency`` faults.
    latency_s: float = 0.0
    #: Window length for ``partition`` faults: the peer is unreachable for
    #: ``[after_s, after_s + duration_s)`` on the transport's clock.
    duration_s: float = 0.0
    #: Peer name a ``partition`` fault isolates (None = partition the whole
    #: seam — every peer unreachable for the window).
    peer: Optional[str] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        if self.op != "*" and self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected {OPS} or '*'")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.after_s is not None and self.after_s < 0:
            raise ValueError(f"after_s must be >= 0, got {self.after_s}")
        if self.duration_s < 0:
            raise ValueError(
                f"duration_s must be >= 0, got {self.duration_s}")
        if self.kind == "partition" and self.after_s is None:
            raise ValueError("partition faults need after_s (window start)")

    def matches(self, op: str) -> bool:
        return self.op == "*" or self.op == op

    def fires(self, seed: int, spec_index: int, op: str, call_index: int,
              elapsed_s: float = 0.0) -> bool:
        if not self.matches(op):
            return False
        if self.call_index is not None:
            return call_index == self.call_index
        if self.after_s is not None:
            return elapsed_s >= self.after_s
        if self.rate <= 0.0:
            return False
        return _hash_unit(seed, spec_index, op, call_index) < self.rate


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, ordered set of :class:`FaultSpec` rules."""

    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    @classmethod
    def from_spec(cls, spec: Union["FaultPlan", Dict[str, Any], str, None]
                  ) -> Optional["FaultPlan"]:
        """Coerce a plan from itself, a dict, or a JSON string (the
        ``--fault-plan`` CLI surface); ``None`` stays ``None``."""
        if spec is None or isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, str):
            spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(
                f"fault plan must be a dict or JSON object, got "
                f"{type(spec).__name__}"
            )
        faults = tuple(
            fault if isinstance(fault, FaultSpec) else FaultSpec(**fault)
            for fault in spec.get("faults", ())
        )
        return cls(seed=int(spec.get("seed", 0)), faults=faults)

    @classmethod
    def replica_lost(cls, after_s: Optional[float] = None,
                     call_index: Optional[int] = None,
                     op: str = "*", seed: int = 0) -> "FaultPlan":
        """A single sticky ``device_lost`` spec: the replica dies at the
        given wall-clock time OR per-op call index and never comes back —
        the deterministic kill fleet failover tests and chaos runs arm on one replica's backend."""
        if (after_s is None) == (call_index is None):
            raise ValueError(
                "replica_lost needs exactly one of after_s / call_index")
        return cls(seed=seed, faults=(FaultSpec(
            kind="device_lost", op=op, call_index=call_index,
            after_s=after_s,
        ),))

    def firing(self, op: str, call_index: int,
               elapsed_s: float = 0.0) -> List[FaultSpec]:
        """Specs that fire for this (op, per-op call index, elapsed time).

        ``partition`` specs are window-scheduled, not per-call — they are
        excluded here and consumed via :meth:`partition_windows`."""
        return [
            spec for i, spec in enumerate(self.faults)
            if spec.kind != "partition"
            and spec.fires(self.seed, i, op, call_index, elapsed_s)
        ]

    def partition_windows(self) -> List[Tuple[Optional[str], float, float]]:
        """Scheduled partitions as ``(peer, start_s, end_s)`` windows
        relative to the consuming wrapper's construction time.  ``peer``
        is None for a full-seam partition."""
        return [
            (spec.peer, float(spec.after_s),
             float(spec.after_s) + float(spec.duration_s))
            for spec in self.faults
            if spec.kind == "partition" and spec.after_s is not None
        ]


class FaultInjectingBackend:
    """Wrap ``inner`` and inject the plan's faults into its protocol calls.

    Deliberately does NOT expose ``open_fused_token_search``: fused
    sessions bypass the protocol seam, so they would bypass injection too —
    without the attribute, the session factory falls back to the
    full-prefix path whose every call crosses this wrapper.
    """

    name = "faults"

    def __init__(
        self,
        inner: Backend,
        plan: Union[FaultPlan, Dict[str, Any], str],
        registry: Optional[Registry] = None,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self.inner = inner
        self.plan = FaultPlan.from_spec(plan) or FaultPlan()
        self._sleep = sleep
        self._clock = clock
        self._t0 = clock()  # ``after_s`` specs measure from construction
        self._lock = threading.Lock()
        self._call_index = {op: 0 for op in OPS}
        self._device_lost = False
        # ``hang`` faults park the calling thread on this event; it starts
        # unset (block forever) and ``release_hangs()`` sets it for good.
        self._hang_release = threading.Event()
        self.hangs_active = 0
        reg = registry if registry is not None else get_registry()
        self._injected = reg.counter(
            "faults_injected_total",
            "Faults injected by the fault-injection backend, by kind and op.",
            labels=("kind", "op"),
        )

    # -- passthrough surface -------------------------------------------------

    @property
    def deterministic_greedy(self) -> bool:
        return bool(getattr(self.inner, "deterministic_greedy", False))

    @property
    def token_counts(self):
        return getattr(self.inner, "token_counts", {})

    # -- injection core ------------------------------------------------------

    def _next_index(self, op: str) -> int:
        with self._lock:
            index = self._call_index[op]
            self._call_index[op] = index + 1
            return index

    def _pre_call(self, op: str) -> List[FaultSpec]:
        """Apply call-blocking faults; return result-mutating specs."""
        index = self._next_index(op)
        specs = self.plan.firing(op, index, self._clock() - self._t0)
        if self._device_lost or any(s.kind == "device_lost" for s in specs):
            if not self._device_lost:
                self._injected.labels("device_lost", op).inc()
            self._device_lost = True
            raise BackendLostError(
                f"injected device loss (op={op}, call={index})"
            )
        post = []
        for spec in specs:
            if spec.kind == "latency":
                self._injected.labels("latency", op).inc()
                self._sleep(spec.latency_s)
            elif spec.kind == "transient_error":
                self._injected.labels("transient_error", op).inc()
                raise RuntimeError(
                    f"injected transient fault (op={op}, call={index})"
                )
            elif spec.kind == "timeout_error":
                self._injected.labels("timeout_error", op).inc()
                raise TimeoutError(
                    f"injected timeout (op={op}, call={index})"
                )
            elif spec.kind == "hang":
                # Block until released — the silent-hang failure mode.  The
                # caller's thread parks here with no exception for anything
                # above to classify; only the decode engine's heartbeat
                # watchdog can observe the wedge.  After release the call
                # proceeds normally (the hang was transient from the
                # caller's perspective — but the watchdog has long since
                # declared the replica lost).
                self._injected.labels("hang", op).inc()
                with self._lock:
                    self.hangs_active += 1
                try:
                    self._hang_release.wait()
                finally:
                    with self._lock:
                        self.hangs_active -= 1
            else:
                post.append(spec)
        return post

    def release_hangs(self) -> None:
        """Unstick every thread parked (now or later) on a ``hang`` fault.

        Irreversible by design: tests call this at teardown so hung daemon
        threads do not outlive the test holding shared state."""
        self._hang_release.set()

    def _target_rows(self, spec: FaultSpec, n: int) -> List[int]:
        if spec.row_index is None:
            return list(range(n))
        return [spec.row_index] if 0 <= spec.row_index < n else []

    # -- protocol ------------------------------------------------------------

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        post = self._pre_call("generate")
        results = list(self.inner.generate(requests))
        for spec in post:
            if spec.kind != "truncate":
                continue
            for row in self._target_rows(spec, len(results)):
                res = results[row]
                cut = max(1, len(res.text) // 2)
                results[row] = dataclasses.replace(
                    res, text=res.text[:cut], finish_reason="length"
                )
                self._injected.labels("truncate", "generate").inc()
        return results

    def score(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        post = self._pre_call("score")
        results = list(self.inner.score(requests))
        for spec in post:
            if spec.kind not in ("nan_logprobs", "inf_logprobs"):
                continue
            poison = float("nan") if spec.kind == "nan_logprobs" else float("inf")
            for row in self._target_rows(spec, len(results)):
                res = results[row]
                logprobs = list(res.logprobs) or [0.0]
                logprobs[0] = poison
                results[row] = dataclasses.replace(
                    res,
                    tokens=res.tokens or ("<poison>",),
                    logprobs=tuple(logprobs),
                )
                self._injected.labels(spec.kind, "score").inc()
        return results

    def next_token_logprobs(
        self, requests: Sequence[NextTokenRequest]
    ) -> List[List[TokenCandidate]]:
        post = self._pre_call("next_token")
        results = [list(cands) for cands in self.inner.next_token_logprobs(requests)]
        for spec in post:
            if spec.kind not in ("nan_logprobs", "inf_logprobs"):
                continue
            poison = float("nan") if spec.kind == "nan_logprobs" else float("inf")
            for row in self._target_rows(spec, len(results)):
                cands = results[row]
                if cands:
                    results[row] = [
                        dataclasses.replace(cands[0], logprob=poison)
                    ] + cands[1:]
                    self._injected.labels(spec.kind, "next_token").inc()
        return results

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        post = self._pre_call("embed")
        vectors = np.array(self.inner.embed(texts), copy=True)
        for spec in post:
            if spec.kind not in ("nan_logprobs", "inf_logprobs"):
                continue
            poison = float("nan") if spec.kind == "nan_logprobs" else float("inf")
            for row in self._target_rows(spec, len(vectors)):
                vectors[row, 0] = poison
                self._injected.labels(spec.kind, "embed").inc()
        return vectors
