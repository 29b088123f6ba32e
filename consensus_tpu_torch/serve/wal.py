"""Durable serving state: the crash-consistent request journal (WAL).

PyTorch port of ``consensus_tpu/serve/wal.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.

The serving plane's analogue of the offline sweep journal (``utils/io_atomic.py``): every
request the scheduler ACCEPTS is fsync'd to an append-only journal before
``submit`` returns, and every terminal outcome is fsync'd at ``_finish``.
A SIGKILL can therefore lose at most work, never accounting:

* **admitted** — appended at ticket creation, carrying the full request
  payload (``(prompt, seed)``-keyed, so recomputation is byte-identical)
  and the request's idempotency key.
* **resolved** — appended at the terminal outcome with
  ``{outcome, idempotency_key, result_hash}``.  ``result_hash`` digests
  the response minus its volatile stamps (timing, serving replica), so a
  post-restart recomputation of the same request hashes identically.
* **sealed** — appended once by a clean drain; a journal WITHOUT a seal
  is a crash, and the restarted server replays its unresolved entries
  through the normal admission path.  Dedup rides the durable idempotency
  cache: a replayed request whose result survived in the snapshot is
  served as ``idempotent_replay`` (and its ``result_hash`` is verified
  against the journal's — a mismatch is a loud
  :class:`WALIntegrityError`, never a silently different answer).

Torn-tail handling is inherited from
:class:`consensus_tpu_torch.utils.io_atomic.JournalWriter`: each record is one
fsync'd JSONL line under schema ``consensus_tpu.serve.wal.v1`` (the JAX package's, so
either package replays the other's journal); only the
final line can be torn by a crash and its record was never acknowledged,
so skipping it on read is lossless.

A wall-clock **lease** (``wal.lease`` in the state dir) guards the
journal against two live processes: a starting server refuses a journal
whose lease has not expired (:class:`WALLeaseHeld`) — crash recovery is
take-over of a STALE lease.  A lease is stale when it has expired, or
when its default ``pid-<N>`` owner is a dead process on this host (so a
SIGKILL'd server's replacement takes over immediately instead of
waiting out the TTL); both paths are pinned in tests.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.utils.io_atomic import (
    JournalWriter,
    atomic_write_json,
    read_journal,
)

#: Journal line schema for the serving WAL (distinct from the experiment
#: journal's ``consensus_tpu.journal.v1`` so the two readers never
#: cross-parse each other's records).
WAL_SCHEMA = "consensus_tpu.serve.wal.v1"

#: Journal file name inside the state dir.
WAL_FILENAME = "requests.wal"

#: Lease file name inside the state dir.
LEASE_FILENAME = "wal.lease"

#: Default lease TTL.  Long enough that a healthy server's renewals (one
#: per resolved request) never lapse under load, short enough that a
#: crashed server's replacement takes over promptly.
DEFAULT_LEASE_TTL_S = 30.0

#: Response keys excluded from ``result_hash``: stamps that legitimately
#: differ between the original computation and a byte-identical replay
#: (timing, serving replica, replay markers).  Everything else — the
#: statement, welfare numbers, degraded markers — must match.
VOLATILE_RESULT_KEYS = frozenset({
    "generation_time_s",
    "served_by",
    "served_tier",
    "idempotent_replay",
})


class WALIntegrityError(RuntimeError):
    """The journal contradicts itself or the durable idempotency cache
    (resolved-twice, or a replayed result whose hash does not match the
    journal's recorded ``result_hash``)."""


class WALLeaseHeld(RuntimeError):
    """Another process holds an unexpired lease on this journal."""


def result_hash(value: Any) -> Optional[str]:
    """Stable digest of one response, None for non-dict results.

    Volatile stamps are dropped first so the hash is a statement about the
    ANSWER: the same ``(prompt, seed)`` recomputed after a crash hashes
    identically, and a divergent recomputation is detectable."""
    if not isinstance(value, dict):
        return None
    stable = {
        k: v for k, v in value.items() if k not in VOLATILE_RESULT_KEYS
    }
    blob = json.dumps(stable, sort_keys=True, default=repr)
    return hashlib.blake2b(blob.encode("utf-8"), digest_size=16).hexdigest()


class RequestWAL:
    """Fsync'd write-ahead journal of one server's request lifecycle.

    Opening the WAL reads any existing journal first (torn tail skipped),
    computes the replay plan — ``admitted`` entries without a matching
    ``resolved`` in an UNSEALED journal — and then appends to the same
    file.  ``admitted``/``resolved`` appends after a crash-restart simply
    continue the log: an entry may legitimately be admitted twice (once
    per life), but a second ``resolved`` without an intervening
    ``admitted`` is rejected as :class:`WALIntegrityError`.
    """

    def __init__(
        self,
        state_dir,
        clock: Callable[[], float] = time.time,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        owner: Optional[str] = None,
        registry: Optional[Registry] = None,
    ):
        self.state_dir = pathlib.Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.state_dir / WAL_FILENAME
        self.lease_path = self.state_dir / LEASE_FILENAME
        self._clock = clock
        self.lease_ttl_s = float(lease_ttl_s)
        self.owner = owner or f"pid-{os.getpid()}"
        self._lock = threading.Lock()
        self.sealed = False
        self.closed = False
        self.replayed = 0

        reg = registry if registry is not None else get_registry()
        self._m_appends = reg.counter(
            "serve_wal_appends_total",
            "Fsync'd WAL records appended, by type "
            "(admitted|resolved|sealed).",
            labels=("type",),
        )
        self._m_replays = reg.counter(
            "serve_wal_replays_total",
            "Unresolved journal entries re-admitted through the normal "
            "admission path after a crash-restart.",
        )
        self._m_integrity = reg.counter(
            "serve_wal_integrity_errors_total",
            "WAL integrity violations detected (resolved-twice appends, "
            "replay result-hash mismatches).",
        )
        self._m_unresolved = reg.gauge(
            "serve_wal_unresolved",
            "Admitted-but-unresolved requests currently in the journal "
            "(in-flight work that a crash right now would replay).",
        )

        self._acquire_lease()

        # Recover prior state BEFORE opening the writer: per-request-id
        # lifecycle ("admitted" / "resolved") and whether the previous
        # life sealed cleanly.
        self._state: Dict[str, str] = {}
        self._recovered_unresolved: List[Dict[str, Any]] = []
        self._resolved_hashes: Dict[str, Optional[str]] = {}
        prior_sealed = False
        pending: Dict[str, Dict[str, Any]] = {}
        for record in read_journal(self.path, schema=WAL_SCHEMA):
            kind = record.get("type")
            rid = record.get("request_id", "")
            if kind == "admitted":
                self._state[rid] = "admitted"
                pending[rid] = record
                prior_sealed = False
            elif kind == "resolved":
                if self._state.get(rid) != "admitted":
                    self._m_integrity.inc()
                    raise WALIntegrityError(
                        f"journal {self.path} resolves request {rid!r} "
                        f"twice (no intervening admitted record)"
                    )
                self._state[rid] = "resolved"
                self._resolved_hashes[rid] = record.get("result_hash")
                pending.pop(rid, None)
            elif kind == "sealed":
                prior_sealed = True
        self.recovered_sealed = prior_sealed
        if not prior_sealed:
            # Unsealed journal == crash: everything admitted-without-
            # resolved is the replay plan, in admission order.
            self._recovered_unresolved = list(pending.values())
        self._m_unresolved.set(len(self._recovered_unresolved))

        self._writer = JournalWriter(self.path, schema=WAL_SCHEMA)

    # -- lease ------------------------------------------------------------

    def _acquire_lease(self) -> None:
        now = self._clock()
        if self.lease_path.exists():
            try:
                lease = json.loads(self.lease_path.read_text())
            except (ValueError, OSError):
                lease = {}
            expires = lease.get("expires_at", 0)
            holder = lease.get("owner", "")
            if (holder != self.owner and expires > now
                    and self._holder_alive(holder)):
                raise WALLeaseHeld(
                    f"journal {self.path} is leased to {holder!r} for "
                    f"another {expires - now:.1f}s; refusing to replay a "
                    f"journal another process may still be appending to"
                )
        self._write_lease(now)

    @staticmethod
    def _holder_alive(holder: str) -> bool:
        """Liveness of a default ``pid-<N>`` lease owner on this host: a
        SIGKILL'd server's lease would otherwise block its replacement
        for the full TTL, which is exactly the restart window durability
        exists to shrink.  Non-pid owners (explicit names, possibly on
        another host) can only go stale by wall-clock expiry."""
        if not holder.startswith("pid-"):
            return True
        try:
            pid = int(holder[4:])
        except ValueError:
            return True
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except OSError:
            return True
        return True

    def _write_lease(self, now: float) -> None:
        atomic_write_json(self.lease_path, {
            "owner": self.owner,
            "expires_at": now + self.lease_ttl_s,
        })

    def renew_lease(self) -> None:
        with self._lock:
            if not self.closed:
                self._write_lease(self._clock())

    def _release_lease(self) -> None:
        try:
            self.lease_path.unlink()
        except OSError:
            pass

    # -- appends -----------------------------------------------------------

    def record_admitted(self, request_id: str,
                        idempotency_key: Optional[str],
                        payload: Dict[str, Any]) -> None:
        """One fsync'd ``admitted`` record; the acceptance contract —
        once this returns (and therefore before ``submit`` returns), a
        kill cannot lose the request."""
        with self._lock:
            self._state[request_id] = "admitted"
            self._writer.append({
                "type": "admitted",
                "request_id": request_id,
                "idempotency_key": idempotency_key,
                "request": payload,
                "t": self._clock(),
            })
            self._m_appends.labels("admitted").inc()
            self._m_unresolved.set(self._unresolved_count_locked())

    def record_resolved(self, request_id: str, outcome: str,
                        idempotency_key: Optional[str],
                        value_hash: Optional[str]) -> None:
        """One fsync'd terminal record.  Rejects a second resolution of
        an already-resolved request — the double-resolve a replay bug
        would produce — as :class:`WALIntegrityError`."""
        with self._lock:
            if self._state.get(request_id) != "admitted":
                self._m_integrity.inc()
                raise WALIntegrityError(
                    f"request {request_id!r} resolved without an open "
                    f"admitted record (state="
                    f"{self._state.get(request_id)!r})"
                )
            self._state[request_id] = "resolved"
            self._resolved_hashes[request_id] = value_hash
            self._writer.append({
                "type": "resolved",
                "request_id": request_id,
                "outcome": outcome,
                "idempotency_key": idempotency_key,
                "result_hash": value_hash,
                "t": self._clock(),
            })
            self._m_appends.labels("resolved").inc()
            self._m_unresolved.set(self._unresolved_count_locked())
            self._write_lease(self._clock())

    def _unresolved_count_locked(self) -> int:
        return sum(1 for s in self._state.values() if s == "admitted")

    # -- recovery ----------------------------------------------------------

    def unresolved(self) -> List[Dict[str, Any]]:
        """The replay plan: admitted records from the previous (crashed)
        life with no terminal outcome, in admission order."""
        return list(self._recovered_unresolved)

    def recorded_hash(self, request_id: str) -> Optional[str]:
        """The journal's ``result_hash`` for a resolved request id (None
        when unresolved or resolved without a hashable value)."""
        with self._lock:
            return self._resolved_hashes.get(request_id)

    def verify_replay(self, request_id: str,
                      value: Any) -> None:
        """Cross-check a replayed/cached result against the journal.

        If the journal recorded a ``result_hash`` for this request in a
        previous life, the value being served now must hash identically —
        a mismatch means the durable snapshot and the journal disagree
        about what the answer WAS, and serving either silently would
        violate the byte-identical-replay contract."""
        recorded = self.recorded_hash(request_id)
        if recorded is None:
            return
        actual = result_hash(value)
        if actual != recorded:
            self._m_integrity.inc()
            raise WALIntegrityError(
                f"replay of request {request_id!r} hashes to {actual}, "
                f"but the journal recorded {recorded} — refusing to "
                f"serve a result that differs from the journaled one"
            )

    def note_replayed(self, n: int = 1) -> None:
        with self._lock:
            self.replayed += n
        self._m_replays.inc(n)

    # -- lifecycle ---------------------------------------------------------

    def seal(self) -> None:
        """Mark a clean shutdown: drain completed, nothing unresolved is
        in flight (anything still admitted was failed by the drain).  A
        sealed journal replays nothing on the next start."""
        with self._lock:
            if self.sealed or self.closed:
                return
            self.sealed = True
            self._writer.append({"type": "sealed", "t": self._clock()})
            self._m_appends.labels("sealed").inc()
            self._writer.close()
            self.closed = True
        self._release_lease()

    def close(self) -> None:
        """Close WITHOUT sealing (test hook: simulates the file state a
        SIGKILL leaves behind — the lease stays on disk too)."""
        with self._lock:
            if self.closed:
                return
            self._writer.close()
            self.closed = True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": str(self.path),
                "schema": WAL_SCHEMA,
                "sealed": self.sealed,
                "unresolved": self._unresolved_count_locked(),
                "replayed": self.replayed,
                "recovered_unresolved": len(self._recovered_unresolved),
                "recovered_sealed": self.recovered_sealed,
                "lease_owner": self.owner,
                "lease_ttl_s": self.lease_ttl_s,
            }


def replay_unresolved(wal: RequestWAL, scheduler) -> int:
    """Re-admit every unresolved journal entry through ``scheduler`` (the
    normal admission path — bounded queue, deadlines, brownout, all of
    it).  Returns the number of requests re-admitted.

    Results are not waited on here: each replay resolves through the
    scheduler's ordinary ``_finish`` path, which journals the terminal
    outcome and records it in the durable idempotency cache — a client
    re-asking with the same ``request_id`` then gets the byte-identical
    answer as an ``idempotent_replay``."""
    from consensus_tpu_torch.serve.service import ConsensusRequest

    replayed = 0
    for record in wal.unresolved():
        payload = dict(record.get("request") or {})
        if not payload:
            continue
        try:
            request = ConsensusRequest(**payload)
        except TypeError:
            # A record from a future/past schema variant: refusing one
            # replay must not abort the rest of the recovery.
            continue
        try:
            scheduler.submit(request)
        except Exception:
            continue
        replayed += 1
    if replayed:
        wal.note_replayed(replayed)
    return replayed
