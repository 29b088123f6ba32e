"""Host-side content-addressed store of prefix-KV page runs: the warm

PyTorch port of ``consensus_tpu/serve/pagestore.py``: the same classes, metric
families and JSON fields, so either package's output reads the same.
handoff seam between fleet replicas — now shipped over the transport seam.

A replica's :class:`~consensus_tpu_torch.ops.kv_pages.PrefixCache` holds
device-resident KV pages keyed by chained blake2b content keys over
(model identity, page-aligned prompt-token prefix).  Those keys make KV
state PORTABLE: any replica with the same ``kv_cache_identity()`` computes
the same key for the same tokens, so a page run captured from one replica
can be adopted by another — PagedAttention block tables plus
RadixAttention content addressing taken across the replica seam.

Publishing and fetching cross :mod:`consensus_tpu_torch.serve.transport`:

* **Shipping is chunked and resumable.**  A run serializes to one blob;
  the client ships it as ``begin`` / ``chunk``* / ``commit`` messages.
  ``begin`` returns the chunk indices the store already holds, so a
  transfer interrupted by drops resumes instead of restarting; each chunk
  carries its own hash (rejected chunks are re-sent), and ``commit``
  verifies the END-TO-END content hash before admission.
* **Corrupt or truncated runs are never admitted.**  Admission —
  including the local, non-transport path — goes through
  :meth:`PageStore.admit_blob`, which re-verifies the blob's content hash
  and raises the typed :class:`PageIntegrityError` (counted in
  ``pagestore_integrity_rejects_total``) on any mismatch, BEFORE the blob
  is ever deserialized.
* **Runs carry a lease.**  With ``lease_s`` set, a published run expires
  that many seconds after its last (re-)admission; an expired run can
  vanish mid-fetch, and the client aborts that adoption cleanly (counted
  in ``pagestore_fetch_aborts_total``) rather than seeding a partial run.
* **Degradation is graceful.**  When the seam is down — peer partitioned,
  transport erroring past its retry budget — a client marks itself
  degraded (``pagestore_degraded`` gauge; enter/exit windows surfaced in
  :meth:`PageStore.stats`), fast-fails capture/seed with a single probe
  instead of hanging, and recovers automatically when a probe succeeds.

The store keeps, per run: the chained content ``key``, the ``tokens``
prefix, block-table metadata (``n_tokens``, ``page_size``, page count),
and the page PAYLOAD — raw KV bytes via the backend's optional
``export_kv_pages`` / ``import_kv_pages`` hooks; backends without the
hooks (the fake backend) store an empty payload: for them the tokens ARE
the state, and adoption reconstructs byte-identical results by
construction — what the warm-handoff byte-identity test pins.

Adoption rules (enforced in :meth:`PageStoreClient.seed_engine`):

* identity must match the adopting cache's identity EXACTLY — a different
  model tier, quantization mode, or tp width names different KV bytes for
  the same tokens, and the store refuses (counted, never silent);
* page_size must match the adopting pool's;
* runs seed most-recently-captured first, so when the adopting cache's
  LRU budget is smaller than the store, the hottest prefixes win.

The :class:`~consensus_tpu_torch.serve.fleet.ReplicaManager` harvests healthy
replicas' caches into one fleet-wide store on its monitor cadence (each
replica through its OWN named transport client, so per-replica partitions
bite) and pre-seeds every replica it spawns BEFORE registering it with
the router — so a respawned replica's first requests hit warm prefixes
instead of re-prefilling.
"""

from __future__ import annotations

import hashlib
import math
import os
import pathlib
import pickle
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from consensus_tpu_torch.obs.metrics import Registry, get_registry
from consensus_tpu_torch.ops.kv_pages import PagePoolExhausted
from consensus_tpu_torch.serve.transport import LoopbackTransport, TransportError
from consensus_tpu_torch.utils.io_atomic import atomic_write_bytes

#: Default bound on retained runs — LRU over capture recency.  Sized so a
#: scenario-heavy loadgen run (dozens of distinct prompts) fits whole.
DEFAULT_MAX_RUNS = 256

#: Default shipping chunk size.  Small enough that a multi-page KV payload
#: spans several chunks (so resume/partial-transfer paths are real), large
#: enough that loopback shipping stays one or two calls for fake payloads.
DEFAULT_CHUNK_BYTES = 64 * 1024

#: The store's well-known transport peer name.
STORE_PEER = "pagestore"


class PageIntegrityError(RuntimeError):
    """Serialized run bytes failed content-hash verification."""


def _content_hash(blob: bytes) -> str:
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _serialize_run(run: Dict[str, Any]) -> bytes:
    """Canonical blob for one run (stable field order, protocol pinned)."""
    record = (
        tuple(run["identity"]),
        bytes(run["key"]),
        tuple(run["tokens"]),
        int(run["n_tokens"]),
        int(run["page_size"]),
        int(run["n_pages"]),
        bytes(run["payload"]),
    )
    return pickle.dumps(record, protocol=4)


def _deserialize_run(blob: bytes) -> Dict[str, Any]:
    identity, key, tokens, n_tokens, page_size, n_pages, payload = (
        pickle.loads(blob)
    )
    return {
        "identity": tuple(identity),
        "key": key,
        "tokens": tuple(tokens),
        "n_tokens": int(n_tokens),
        "page_size": int(page_size),
        "n_pages": int(n_pages),
        "payload": payload,
    }


def _chunks_of(blob: bytes, chunk_bytes: int) -> List[bytes]:
    if not blob:
        return [b""]
    return [blob[i:i + chunk_bytes] for i in range(0, len(blob), chunk_bytes)]


class PageStore:
    """Fleet-wide LRU of exported prefix-KV runs, keyed by
    ``(kv_cache_identity, chained content key)``, published and fetched
    over a message transport.

    The store registers itself on the transport as peer ``"pagestore"``
    with ``ship`` / ``fetch`` / ``probe`` handlers;
    :meth:`client` mints named :class:`PageStoreClient` endpoints whose
    traffic crosses the transport — and therefore any
    :class:`~consensus_tpu_torch.serve.transport.FaultyTransport` wrapped
    around it.  The legacy direct API (``capture_engine`` /
    ``capture_cache`` / ``seed_engine``) delegates to the ``"local"``
    client, so existing callers transparently ride the seam.
    """

    def __init__(
        self,
        max_runs: int = DEFAULT_MAX_RUNS,
        registry: Optional[Registry] = None,
        transport: Any = None,
        lease_s: Optional[float] = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        clock: Callable[[], float] = time.monotonic,
        peer: str = STORE_PEER,
        spill_dir=None,
        disk_budget_bytes: Optional[int] = None,
    ):
        self.max_runs = max(1, int(max_runs))
        self.lease_s = None if lease_s is None else float(lease_s)
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.peer = peer
        self._clock = clock
        self._lock = threading.Lock()
        #: Disk backing (None = memory-only, the pre-durability store).
        #: Every admitted run is also atomically spilled as
        #: ``<spill_dir>/<content-hash>.run`` under an LRU byte budget; a
        #: NEW store over the same directory re-indexes the files (each
        #: verified against the hash its name claims) and serves them
        #: lazily — a respawned or upgraded replica warm-seeds from disk
        #: instead of re-prefilling cold.  Memory eviction never deletes
        #: disk files; only the disk budget does.
        self.spill_dir = pathlib.Path(spill_dir) if spill_dir else None
        self.disk_budget_bytes = (
            None if disk_budget_bytes is None else max(1, int(disk_budget_bytes))
        )
        #: content hash -> {path, size, meta}; insertion order == spill /
        #: touch recency (LRU for the disk budget).
        self._disk: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        #: (identity, key) -> content hash, for lazy restore lookups.
        self._disk_by_key: Dict[Tuple[Tuple, bytes], str] = {}
        self._disk_bytes = 0
        self._n_spilled = 0
        self._n_restored = 0
        self._n_disk_evicted = 0
        #: (identity, key) -> run dict; insertion order == capture recency
        #: (move_to_end on re-capture), so iteration from the END yields
        #: most-recently-seen first.
        self._runs: "OrderedDict[Tuple[Tuple, bytes], Dict[str, Any]]" = (
            OrderedDict()
        )
        #: In-flight ship transfers: transfer id -> {hash, n_chunks,
        #: blob_len, chunks}.
        self._transfers: Dict[str, Dict[str, Any]] = {}
        self._registry = registry if registry is not None else get_registry()
        reg = self._registry
        self._m_captured = reg.counter(
            "pagestore_runs_captured_total",
            "Prefix-KV runs harvested from replica caches into the "
            "fleet PageStore (re-captures of a known run count too).",
        )
        self._m_adopted = reg.counter(
            "pagestore_runs_adopted_total",
            "Stored runs adopted into a joining replica's prefix cache "
            "(the warm-handoff seeding path).",
        )
        self._m_rejected = reg.counter(
            "pagestore_identity_rejects_total",
            "Runs refused at adoption because the joining cache's "
            "kv_cache_identity (model tier / quant / tp width) did not "
            "match the run's — mismatched identities name different KV "
            "bytes for the same tokens.",
        )
        self._m_integrity = reg.counter(
            "pagestore_integrity_rejects_total",
            "Run blobs refused at admission because their serialized "
            "bytes failed content-hash verification (corrupt or "
            "truncated transfers; never admitted).",
        )
        self._m_aborts = reg.counter(
            "pagestore_fetch_aborts_total",
            "Run fetches aborted cleanly because the run expired or was "
            "evicted mid-transfer (no partial run is ever adopted).",
        )
        self._m_runs = reg.gauge(
            "pagestore_runs",
            "Prefix-KV runs currently retained by the fleet PageStore.",
        )
        self._m_degraded = reg.gauge(
            "pagestore_degraded",
            "PageStore transport clients currently degraded (seam down "
            "or peer partitioned; replicas fall back to cold prefill).",
        )
        self._m_spilled = reg.counter(
            "pagestore_spilled_runs_total",
            "Prefix-KV runs spilled to the on-disk store (admission-time "
            "write-through under the disk LRU budget).",
        )
        self._m_restored = reg.counter(
            "pagestore_disk_restores_total",
            "Runs restored from disk into the in-memory store (lazy, at "
            "first fetch after a restart).",
        )
        self._m_disk_evicted = reg.counter(
            "pagestore_disk_evictions_total",
            "Spilled run files evicted (LRU) to stay under the disk "
            "byte budget.",
        )
        self._m_disk_runs = reg.gauge(
            "pagestore_disk_runs",
            "Run files currently in the on-disk store.",
        )
        self._m_disk_bytes = reg.gauge(
            "pagestore_disk_bytes",
            "Bytes currently held by the on-disk store.",
        )
        if self.spill_dir is not None:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            self._index_spill_dir()
        self.transport = (
            transport if transport is not None else LoopbackTransport()
        )
        self.transport.register(self.peer, {
            "ship": self._handle_ship,
            "fetch": self._handle_fetch,
            "probe": self._handle_probe,
        })
        self._clients: Dict[str, "PageStoreClient"] = {}

    def __len__(self) -> int:
        with self._lock:
            self._expire_locked()
            return len(self._runs)

    # -- disk backing ---------------------------------------------------------

    def _index_spill_dir(self) -> None:
        """Re-index spilled run files at construction (restart path).

        Each ``<hash>.run`` file's bytes are verified against the hash
        its NAME claims — a torn or tampered file is deleted and counted,
        never indexed.  Files are indexed oldest-first (mtime) so disk
        LRU order survives the restart; runs are NOT loaded into memory
        here — restore is lazy, at first fetch."""
        files = sorted(
            self.spill_dir.glob("*.run"),
            key=lambda p: (p.stat().st_mtime, p.name),
        )
        for path in files:
            claimed = path.stem
            try:
                blob = path.read_bytes()
            except OSError:
                continue
            if _content_hash(blob) != claimed:
                self._m_integrity.inc()
                try:
                    path.unlink()
                except OSError:
                    pass
                continue
            try:
                run = _deserialize_run(blob)
            except Exception:
                self._m_integrity.inc()
                try:
                    path.unlink()
                except OSError:
                    pass
                continue
            self._disk[claimed] = {
                "path": path,
                "size": len(blob),
                "meta": {
                    "identity": run["identity"],
                    "key": run["key"],
                    "page_size": run["page_size"],
                    "n_tokens": run["n_tokens"],
                    "n_pages": run["n_pages"],
                    "hash": claimed,
                    "blob_len": len(blob),
                },
            }
            self._disk_by_key[(run["identity"], run["key"])] = claimed
            self._disk_bytes += len(blob)
        self._m_disk_runs.set(len(self._disk))
        self._m_disk_bytes.set(self._disk_bytes)

    def _spill_locked(self, run: Dict[str, Any]) -> None:
        """Write-through one admitted run to disk (caller holds _lock).
        A run already on disk is just touched (LRU recency); budget
        overflow evicts coldest files first."""
        if self.spill_dir is None:
            return
        blob_hash = run["hash"]
        if blob_hash in self._disk:
            self._disk.move_to_end(blob_hash)
            return
        path = self.spill_dir / f"{blob_hash}.run"
        atomic_write_bytes(path, run["blob"])
        self._disk[blob_hash] = {
            "path": path,
            "size": len(run["blob"]),
            "meta": {
                "identity": run["identity"],
                "key": run["key"],
                "page_size": run["page_size"],
                "n_tokens": run["n_tokens"],
                "n_pages": run["n_pages"],
                "hash": blob_hash,
                "blob_len": len(run["blob"]),
            },
        }
        self._disk_by_key[(run["identity"], run["key"])] = blob_hash
        self._disk_bytes += len(run["blob"])
        self._n_spilled += 1
        self._m_spilled.inc()
        if self.disk_budget_bytes is not None:
            while (self._disk_bytes > self.disk_budget_bytes
                   and len(self._disk) > 1):
                evicted_hash, entry = self._disk.popitem(last=False)
                self._disk_by_key.pop(
                    (entry["meta"]["identity"], entry["meta"]["key"]), None)
                self._disk_bytes -= entry["size"]
                try:
                    os.unlink(entry["path"])
                except OSError:
                    pass
                self._n_disk_evicted += 1
                self._m_disk_evicted.inc()
        self._m_disk_runs.set(len(self._disk))
        self._m_disk_bytes.set(self._disk_bytes)

    def _restore_locked(self, identity: Tuple,
                        key: bytes) -> Optional[Dict[str, Any]]:
        """Lazily restore one spilled run into the in-memory table
        (caller holds _lock).  The file's bytes are hash-verified again
        at restore time (bit rot between index and use); restored runs
        get a fresh lease.  Returns the run, or None."""
        blob_hash = self._disk_by_key.get((identity, key))
        if blob_hash is None:
            return None
        entry = self._disk.get(blob_hash)
        if entry is None:
            return None
        try:
            blob = entry["path"].read_bytes()
        except OSError:
            return None
        if _content_hash(blob) != blob_hash:
            self._m_integrity.inc()
            self._disk.pop(blob_hash, None)
            self._disk_by_key.pop((identity, key), None)
            self._disk_bytes -= entry["size"]
            self._m_disk_runs.set(len(self._disk))
            self._m_disk_bytes.set(self._disk_bytes)
            try:
                os.unlink(entry["path"])
            except OSError:
                pass
            return None
        run = _deserialize_run(blob)
        run["hash"] = blob_hash
        run["blob"] = blob
        if self.lease_s is not None:
            run["expires_s"] = self._clock() + self.lease_s
        store_key = (run["identity"], run["key"])
        self._runs[store_key] = run
        self._runs.move_to_end(store_key)
        while len(self._runs) > self.max_runs:
            self._runs.popitem(last=False)
        self._m_runs.set(len(self._runs))
        self._disk.move_to_end(blob_hash)
        self._n_restored += 1
        self._m_restored.inc()
        return run

    # -- admission (shared by transport and local paths) ---------------------

    def admit_blob(self, blob: bytes, expected_hash: str) -> Dict[str, Any]:
        """Verify-then-admit one serialized run.  EVERY admission — local
        capture or transport commit — lands here: the hash is re-checked
        against the actual bytes and a mismatch raises
        :class:`PageIntegrityError` BEFORE deserialization, so corrupt or
        truncated blobs never reach the run table (nor the unpickler)."""
        actual = _content_hash(blob)
        if actual != expected_hash:
            self._m_integrity.inc()
            raise PageIntegrityError(
                f"run blob hash mismatch: expected {expected_hash}, "
                f"got {actual} ({len(blob)} bytes)"
            )
        try:
            run = _deserialize_run(blob)
        except Exception as exc:
            self._m_integrity.inc()
            raise PageIntegrityError(
                f"run blob failed to deserialize: {exc}"
            ) from exc
        run["hash"] = expected_hash
        run["blob"] = blob
        with self._lock:
            if self.lease_s is not None:
                run["expires_s"] = self._clock() + self.lease_s
            store_key = (run["identity"], run["key"])
            self._runs[store_key] = run
            self._runs.move_to_end(store_key)
            while len(self._runs) > self.max_runs:
                self._runs.popitem(last=False)
            self._m_runs.set(len(self._runs))
            self._spill_locked(run)
        self._m_captured.inc()
        return run

    def _expire_locked(self) -> None:
        if self.lease_s is None:
            return
        now = self._clock()
        expired = [
            key for key, run in self._runs.items()
            if run.get("expires_s") is not None and run["expires_s"] <= now
        ]
        for key in expired:
            del self._runs[key]
        if expired:
            self._m_runs.set(len(self._runs))

    # -- transport handlers ---------------------------------------------------

    def _handle_probe(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._expire_locked()
            return {"ok": True, "runs": len(self._runs)}

    def _handle_ship(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        phase = msg.get("phase")
        if phase == "begin":
            with self._lock:
                self._expire_locked()
                for run in self._runs.values():
                    if run.get("hash") == msg["hash"]:
                        self._runs.move_to_end(
                            (run["identity"], run["key"]))
                        return {"ok": True, "done": True, "have": []}
                if msg["hash"] in self._disk:
                    # Known content already durable on disk (e.g. spilled
                    # before a restart evicted it from memory): no bytes
                    # need to move.
                    self._disk.move_to_end(msg["hash"])
                    return {"ok": True, "done": True, "have": []}
                transfer = self._transfers.setdefault(msg["transfer"], {
                    "hash": msg["hash"],
                    "n_chunks": int(msg["n_chunks"]),
                    "blob_len": int(msg["blob_len"]),
                    "chunks": {},
                })
                if (transfer["hash"] != msg["hash"]
                        or transfer["n_chunks"] != int(msg["n_chunks"])):
                    # Same transfer id, different content: restart clean.
                    transfer = {
                        "hash": msg["hash"],
                        "n_chunks": int(msg["n_chunks"]),
                        "blob_len": int(msg["blob_len"]),
                        "chunks": {},
                    }
                    self._transfers[msg["transfer"]] = transfer
                return {
                    "ok": True,
                    "done": False,
                    "have": sorted(transfer["chunks"]),
                }
        if phase == "chunk":
            with self._lock:
                transfer = self._transfers.get(msg["transfer"])
            if transfer is None:
                return {"ok": False, "reason": "unknown_transfer"}
            data = bytes(msg["data"])
            if _content_hash(data) != msg["chunk_hash"]:
                return {"ok": False, "reason": "chunk_integrity"}
            with self._lock:
                transfer["chunks"][int(msg["index"])] = data
            return {"ok": True}
        if phase == "commit":
            with self._lock:
                transfer = self._transfers.get(msg["transfer"])
                if transfer is None:
                    return {"ok": False, "reason": "unknown_transfer"}
                missing = [
                    i for i in range(transfer["n_chunks"])
                    if i not in transfer["chunks"]
                ]
            if missing:
                return {
                    "ok": False, "reason": "missing_chunks",
                    "missing": missing,
                }
            blob = b"".join(
                transfer["chunks"][i] for i in range(transfer["n_chunks"])
            )
            with self._lock:
                self._transfers.pop(msg["transfer"], None)
            try:
                self.admit_blob(blob, transfer["hash"])
            except PageIntegrityError:
                return {"ok": False, "reason": "integrity"}
            return {"ok": True}
        return {"ok": False, "reason": "bad_phase"}

    def _handle_fetch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        phase = msg.get("phase")
        if phase == "list":
            with self._lock:
                self._expire_locked()
                metas = [
                    {
                        "identity": run["identity"],
                        "key": run["key"],
                        "page_size": run["page_size"],
                        "n_tokens": run["n_tokens"],
                        "n_pages": run["n_pages"],
                        "hash": run["hash"],
                        "blob_len": len(run["blob"]),
                        "n_chunks": len(
                            _chunks_of(run["blob"], self.chunk_bytes)),
                    }
                    for run in reversed(self._runs.values())
                ]
                # Disk-only runs (spilled before a restart or evicted
                # from memory) list AFTER the in-memory ones: memory
                # order encodes capture recency, disk is the cold tier.
                in_memory = {
                    (run["identity"], run["key"])
                    for run in self._runs.values()
                }
                for entry in reversed(self._disk.values()):
                    meta = entry["meta"]
                    if (meta["identity"], meta["key"]) in in_memory:
                        continue
                    metas.append(dict(
                        meta,
                        n_chunks=max(
                            1,
                            math.ceil(meta["blob_len"] / self.chunk_bytes)),
                    ))
            return {"ok": True, "runs": metas, "chunk_bytes": self.chunk_bytes}
        if phase == "chunk":
            with self._lock:
                self._expire_locked()
                run = self._runs.get((tuple(msg["identity"]), msg["key"]))
                if run is None:
                    # Not resident: lazily restore from the disk tier
                    # (hash-verified) before declaring the run gone.
                    run = self._restore_locked(
                        tuple(msg["identity"]), msg["key"])
                if run is None:
                    # Expired or evicted mid-transfer: the client must
                    # abort this adoption, never assemble a partial run.
                    return {"ok": False, "reason": "gone"}
                index = int(msg["index"])
                chunks = _chunks_of(run["blob"], self.chunk_bytes)
                if not 0 <= index < len(chunks):
                    return {"ok": False, "reason": "bad_index"}
                data = chunks[index]
            return {
                "ok": True,
                "data": data,
                "chunk_hash": _content_hash(data),
            }
        return {"ok": False, "reason": "bad_phase"}

    # -- clients --------------------------------------------------------------

    def client(self, name: str) -> "PageStoreClient":
        """The named transport client for one endpoint (one per replica,
        plus ``"local"`` for the legacy direct API).  Cached per name so
        degradation state and per-client fault addressing persist."""
        with self._lock:
            existing = self._clients.get(name)
        if existing is not None:
            return existing
        created = PageStoreClient(
            self.transport,
            name,
            store_peer=self.peer,
            registry=self._registry,
            chunk_bytes=self.chunk_bytes,
            clock=self._clock,
            on_degraded=self._on_client_degraded,
        )
        with self._lock:
            return self._clients.setdefault(name, created)

    def _on_client_degraded(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
        self._m_degraded.set(sum(1 for c in clients if c.degraded))

    # -- legacy direct API (rides the "local" client) -------------------------

    def capture_engine(self, engine: Any) -> int:
        """Harvest every dp shard's prefix cache of ``engine``.  Returns
        runs captured (including refreshes of already-known runs)."""
        return self.client("local").capture_engine(engine)

    def capture_cache(self, cache: Any, inner: Any = None) -> int:
        return self.client("local").capture_cache(cache, inner)

    def seed_engine(self, engine: Any) -> int:
        return self.client("local").seed_engine(engine)

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            self._expire_locked()
            runs = list(self._runs.values())
            identities = sorted({repr(r["identity"]) for r in runs})
            clients = dict(self._clients)
        windows: List[Dict[str, Any]] = []
        for name, client in sorted(clients.items()):
            for enter_s, exit_s in client.degradation_windows():
                windows.append({
                    "client": name, "enter_s": enter_s, "exit_s": exit_s,
                })
        windows.sort(key=lambda w: w["enter_s"])
        stats = {
            "runs": len(runs),
            "max_runs": self.max_runs,
            "pages": sum(r["n_pages"] for r in runs),
            "tokens": sum(r["n_tokens"] for r in runs),
            "payload_bytes": sum(len(r["payload"]) for r in runs),
            "identities": identities,
            "lease_s": self.lease_s,
            "degraded_clients": sorted(
                name for name, c in clients.items() if c.degraded),
            "degradation_windows": windows,
        }
        if self.spill_dir is not None:
            with self._lock:
                stats["disk"] = {
                    "spill_dir": str(self.spill_dir),
                    "runs": len(self._disk),
                    "bytes": self._disk_bytes,
                    "budget_bytes": self.disk_budget_bytes,
                    "spilled": self._n_spilled,
                    "restored": self._n_restored,
                    "evicted": self._n_disk_evicted,
                }
        return stats

    def runs(self) -> List[Dict[str, Any]]:
        """Point-in-time copy of retained runs, most recent first (blob
        bytes elided — the hash names them)."""
        with self._lock:
            self._expire_locked()
            return [
                {k: v for k, v in run.items() if k != "blob"}
                for run in reversed(self._runs.values())
            ]


class PageStoreClient:
    """One endpoint's view of the PageStore across the transport seam.

    All capture/seed traffic goes through :meth:`_call`, which retries
    transient transport failures with a small backoff and flips the
    client into DEGRADED mode when the budget is exhausted — from then on
    capture/seed fast-fail behind a single probe (cold prefill instead of
    hanging) until a probe succeeds and the degradation window closes.
    """

    def __init__(
        self,
        transport: Any,
        name: str,
        store_peer: str = STORE_PEER,
        registry: Optional[Registry] = None,
        retries: int = 3,
        retry_backoff_s: float = 0.005,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_degraded: Optional[Callable[[], None]] = None,
    ):
        self.transport = transport
        self.name = name
        self.store_peer = store_peer
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.retries = max(0, int(retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self._clock = clock
        self._sleep = sleep
        self._on_degraded = on_degraded
        self._lock = threading.Lock()
        self._degraded = False
        self._windows: List[List[Optional[float]]] = []
        reg = registry if registry is not None else get_registry()
        self._m_adopted = reg.counter(
            "pagestore_runs_adopted_total",
            "Stored runs adopted into a joining replica's prefix cache "
            "(the warm-handoff seeding path).",
        )
        self._m_rejected = reg.counter(
            "pagestore_identity_rejects_total",
            "Runs refused at adoption because the joining cache's "
            "kv_cache_identity (model tier / quant / tp width) did not "
            "match the run's — mismatched identities name different KV "
            "bytes for the same tokens.",
        )
        self._m_aborts = reg.counter(
            "pagestore_fetch_aborts_total",
            "Run fetches aborted cleanly because the run expired or was "
            "evicted mid-transfer (no partial run is ever adopted).",
        )

    # -- degradation state ----------------------------------------------------

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def degradation_windows(self) -> List[Tuple[float, Optional[float]]]:
        """Closed and open ``(enter_s, exit_s)`` windows on this client's
        clock (``exit_s`` is None while still degraded)."""
        with self._lock:
            return [(w[0], w[1]) for w in self._windows]

    def _mark_degraded(self) -> None:
        with self._lock:
            if self._degraded:
                return
            self._degraded = True
            self._windows.append([self._clock(), None])
            if len(self._windows) > 64:
                del self._windows[:-64]
        if self._on_degraded is not None:
            self._on_degraded()

    def _mark_healthy(self) -> None:
        with self._lock:
            if not self._degraded:
                return
            self._degraded = False
            self._windows[-1][1] = self._clock()
        if self._on_degraded is not None:
            self._on_degraded()

    # -- transport plumbing ---------------------------------------------------

    def _call(self, op: str, msg: Dict[str, Any],
              attempts: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """One store RPC with retries.  Returns the response dict, or
        None when the transport stayed down past the retry budget (the
        client is then degraded)."""
        total = attempts if attempts is not None else self.retries + 1
        for attempt in range(total):
            try:
                response = self.transport.call(
                    self.name, self.store_peer, op, msg)
            except TransportError:
                if attempt + 1 < total:
                    self._sleep(self.retry_backoff_s * (attempt + 1))
                continue
            self._mark_healthy()
            return response
        self._mark_degraded()
        return None

    def probe(self, attempts: int = 1) -> bool:
        """Is the store reachable from this endpoint right now?  A
        success clears the degraded flag (closing the window)."""
        return self._call("probe", {}, attempts=attempts) is not None

    def _fast_fail(self) -> bool:
        """Degraded clients pay ONE probe per operation instead of the
        full retry ladder — cold prefill beats hanging on a dead seam."""
        return self.degraded and not self.probe(attempts=1)

    # -- capture (publish) ----------------------------------------------------

    def capture_engine(self, engine: Any) -> int:
        caches = getattr(engine, "prefix_caches", None) or []
        inner = getattr(engine, "inner", None)
        captured = 0
        for cache in caches:
            if cache is not None:
                captured += self.capture_cache(cache, inner)
        return captured

    def capture_cache(self, cache: Any, inner: Any = None) -> int:
        """Serialize and ship one :class:`PrefixCache`'s runs to the
        store.  ``inner`` is the backend owning the cache's device pages;
        when it exposes ``export_kv_pages(page_ids) -> bytes`` the run's
        payload is the real KV bytes, otherwise the payload is empty and
        the tokens carry the state (fake/CPU backends)."""
        if self._fast_fail():
            return 0
        identity = tuple(getattr(cache, "identity", ()))
        exporter = getattr(inner, "export_kv_pages", None)
        captured = 0
        for run in cache.export_runs():
            payload = b""
            if callable(exporter):
                try:
                    payload = exporter(run["pages"])
                except Exception:
                    # A replica dying mid-harvest must not poison the
                    # store — skip the run, keep what we have.
                    continue
            blob = _serialize_run({
                "identity": identity,
                "key": run["key"],
                "tokens": tuple(run["tokens"]),
                "n_tokens": int(run["n_tokens"]),
                "page_size": int(run["page_size"]),
                "n_pages": len(run["pages"]),
                "payload": payload,
            })
            if self._ship_blob(blob, _content_hash(blob)):
                captured += 1
            elif self.degraded:
                break  # seam is down; stop burning the probe budget
        return captured

    def _ship_blob(self, blob: bytes, blob_hash: str) -> bool:
        """Chunked, resumable, verified publish of one run blob."""
        chunks = _chunks_of(blob, self.chunk_bytes)
        transfer = f"{self.name}:{blob_hash}"
        for _pass in range(self.retries + 1):
            begun = self._call("ship", {
                "phase": "begin",
                "transfer": transfer,
                "hash": blob_hash,
                "n_chunks": len(chunks),
                "blob_len": len(blob),
            })
            if begun is None:
                return False
            if begun.get("done"):
                return True
            have = set(begun.get("have", ()))
            for index, data in enumerate(chunks):
                if index in have:
                    continue
                sent = None
                for _try in range(self.retries + 1):
                    sent = self._call("ship", {
                        "phase": "chunk",
                        "transfer": transfer,
                        "index": index,
                        "data": data,
                        "chunk_hash": _content_hash(data),
                    })
                    if sent is None:
                        return False
                    if sent.get("ok"):
                        break
                    # chunk_integrity: the bytes were corrupted in flight
                    # — re-send this chunk.
                if sent is None or not sent.get("ok"):
                    break
            committed = self._call("ship", {
                "phase": "commit", "transfer": transfer,
            })
            if committed is None:
                return False
            if committed.get("ok"):
                return True
            # missing_chunks / integrity / unknown_transfer: next pass
            # resumes (begin returns what the store holds) or restarts.
        return False

    # -- adoption (fetch + seed) ----------------------------------------------

    def seed_engine(self, engine: Any) -> int:
        """Fetch stored runs over the transport and pre-seed a joining
        replica's prefix caches, hottest runs first, round-robin over the
        engine's dp shards (a run's pages live in ONE shard's pool;
        spreading runs balances the per-shard LRU budgets).  Returns runs
        adopted.  Identity/page-size checks happen on the METADATA before
        any chunk moves; assembled blobs are hash-verified before
        deserialization; a run that expires mid-fetch aborts cleanly."""
        caches = [
            c for c in (getattr(engine, "prefix_caches", None) or [])
            if c is not None
        ]
        if not caches:
            return 0
        if self._fast_fail():
            return 0
        inner = getattr(engine, "inner", None)
        importer = getattr(inner, "import_kv_pages", None)
        listing = self._call("fetch", {"phase": "list"})
        if listing is None or not listing.get("ok"):
            return 0
        adopted = 0
        shard = 0
        for meta in listing["runs"]:
            cache = caches[shard % len(caches)]
            if tuple(meta["identity"]) != tuple(cache.identity):
                self._m_rejected.inc()
                continue
            if meta["page_size"] != cache.pool.page_size:
                self._m_rejected.inc()
                continue
            blob = self._fetch_blob(meta)
            if blob is None:
                if self.degraded:
                    break
                continue
            run = _deserialize_run(blob)
            try:
                pages = cache.pool.alloc(run["n_pages"], owner=self)
            except PagePoolExhausted:
                break
            if cache.insert(run["tokens"], pages):
                if callable(importer):
                    try:
                        importer(pages, run["payload"])
                    except Exception:
                        pass
                adopted += 1
                self._m_adopted.inc()
                shard += 1
            # Drop the seeding reference either way: on success the cache
            # holds its own reference (pages stay resident); on a dup/
            # over-budget refusal the pages go straight back to the pool.
            cache.pool.free(pages)
        return adopted

    def _fetch_blob(self, meta: Dict[str, Any]) -> Optional[bytes]:
        """Fetch + verify one run blob; None on abort (gone mid-transfer,
        transport down, or unrecoverable corruption)."""
        for _pass in range(self.retries + 1):
            parts: List[Optional[bytes]] = [None] * int(meta["n_chunks"])
            aborted = False
            for index in range(int(meta["n_chunks"])):
                got = None
                for _try in range(self.retries + 1):
                    got = self._call("fetch", {
                        "phase": "chunk",
                        "identity": meta["identity"],
                        "key": meta["key"],
                        "index": index,
                    })
                    if got is None:
                        return None
                    if not got.get("ok"):
                        # gone: expired/evicted mid-transfer — abort this
                        # run cleanly, never assemble a partial blob.
                        self._m_aborts.inc()
                        return None
                    data = bytes(got["data"])
                    if _content_hash(data) == got["chunk_hash"]:
                        parts[index] = data
                        break
                    # corrupted in flight: re-fetch this chunk
                if parts[index] is None:
                    aborted = True
                    break
            if aborted:
                continue
            blob = b"".join(parts)  # type: ignore[arg-type]
            if _content_hash(blob) == meta["hash"]:
                return blob
            # End-to-end mismatch (e.g. per-chunk hashes corrupted in the
            # same message as their data): refuse and re-fetch the run.
        return None
