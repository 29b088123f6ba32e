"""The port's request WAL (``serve/wal.py``) against the JAX package's.

Both packages keep the schema ``consensus_tpu.serve.wal.v1``.  Tolerance:
exact.  A journal written by the JAX WAL is replayed by the port's and
back (the same replay plan, sealed flag and recorded hashes), the same
response gives the same ``result_hash`` (responses made from a seed with
numpy), a torn tail is skipped, a dead pid's lease is taken over while a
live foreign lease is refused, and a resolved-twice append is a
``WALIntegrityError`` in both."""

import json
import os

import numpy as np
import pytest

from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.serve import wal as jax_wal
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import wal

PACKAGES = {"port": (wal, Registry), "jax": (jax_wal, JaxRegistry)}


def _open(which, path, **kwargs):
    module, registry = PACKAGES[which]
    return module.RequestWAL(path, registry=registry(), **kwargs)


def _response(rng):
    value = {
        "statement": "".join(chr(int(c)) for c in rng.randint(97, 123, size=40)),
        "method": "best_of_n",
        "utilities": {f"Agent {i}": {"cosine_similarity": float(rng.uniform())} for i in range(3)},
        "welfare": {"egalitarian_welfare_cosine": float(rng.uniform())},
        "request_id": f"r-{rng.randint(1000)}",
    }
    for key in sorted(wal.VOLATILE_RESULT_KEYS):
        value[key] = float(rng.uniform())
    return value


def test_schema_and_volatile_keys_equal_jax():
    assert wal.WAL_SCHEMA == jax_wal.WAL_SCHEMA == "consensus_tpu.serve.wal.v1"
    assert wal.VOLATILE_RESULT_KEYS == jax_wal.VOLATILE_RESULT_KEYS
    assert (wal.WAL_FILENAME, wal.LEASE_FILENAME) == (jax_wal.WAL_FILENAME, jax_wal.LEASE_FILENAME)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_response_same_result_hash(seed):
    rng = np.random.RandomState(seed)
    value = _response(rng)
    assert wal.result_hash(value) == jax_wal.result_hash(value) is not None
    changed = dict(value, **{k: -1.0 for k in wal.VOLATILE_RESULT_KEYS})
    assert wal.result_hash(changed) == wal.result_hash(value)
    assert wal.result_hash(dict(value, statement="other")) != wal.result_hash(value)
    assert wal.result_hash("text") is None


def _write_history(which, path, rng, seal=False):
    """Admit six requests, resolve four (two with hashes), maybe seal."""
    journal = _open(which, path, clock=lambda: 1000.0)
    for i in range(6):
        journal.record_admitted(f"r-{i}", f"k{i}", {"issue": f"issue {i}", "seed": i})
    for i in (0, 2, 3, 5):
        value = _response(rng) if i % 2 == 0 else None
        journal.record_resolved(f"r-{i}", "ok", f"k{i}", wal.result_hash(value))
    if seal:
        journal.seal()
    else:
        journal.close()


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("seal", [False, True])
def test_journal_written_by_one_package_replays_in_the_other(tmp_path, writer, reader, seal):
    _write_history(writer, tmp_path / writer, np.random.RandomState(4), seal=seal)
    _write_history(reader, tmp_path / reader, np.random.RandomState(4), seal=seal)
    crossed = _open(reader, tmp_path / writer, clock=lambda: 1000.0)
    native = _open(reader, tmp_path / reader, clock=lambda: 1000.0)
    assert crossed.unresolved() == native.unresolved()
    assert [r["request_id"] for r in crossed.unresolved()] == ([] if seal else ["r-1", "r-4"])
    assert crossed.recovered_sealed is seal
    for i in range(6):
        assert crossed.recorded_hash(f"r-{i}") == native.recorded_hash(f"r-{i}")
    stats = {k: v for k, v in crossed.stats().items() if k not in ("path",)}
    native_stats = {k: v for k, v in native.stats().items() if k not in ("path",)}
    assert stats == native_stats


@pytest.mark.parametrize("which", ["port", "jax"])
def test_torn_tail_is_skipped(tmp_path, which):
    journal = _open("jax" if which == "port" else "port", tmp_path)
    journal.record_admitted("r-1", "k1", {"issue": "a"})
    journal.record_admitted("r-2", "k2", {"issue": "b"})
    journal.close()
    path = tmp_path / wal.WAL_FILENAME
    lines = path.read_bytes().splitlines(keepends=True)
    path.write_bytes(b"".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2])
    recovered = _open(which, tmp_path)
    assert [r["request_id"] for r in recovered.unresolved()] == ["r-1"]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_dead_pid_lease_is_taken_over_and_a_live_one_refused(tmp_path, which):
    module = PACKAGES[which][0]
    _open("jax" if which == "port" else "port", tmp_path).close()
    lease = json.loads((tmp_path / wal.LEASE_FILENAME).read_text())
    assert lease["owner"] == f"pid-{os.getpid()}"
    dead = 2 ** 22 + (os.getpid() % 1000)  # beyond the default pid_max
    (tmp_path / wal.LEASE_FILENAME).write_text(json.dumps(
        {"owner": f"pid-{dead}", "expires_at": lease["expires_at"]}))
    taken = _open(which, tmp_path)
    assert taken.stats()["lease_owner"] == f"pid-{os.getpid()}"
    taken.close()
    (tmp_path / wal.LEASE_FILENAME).write_text(json.dumps(
        {"owner": "server-B", "expires_at": lease["expires_at"] + 3600}))
    with pytest.raises(module.WALLeaseHeld):
        _open(which, tmp_path)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_resolved_twice_and_replay_mismatch_are_integrity_errors(tmp_path, which):
    module = PACKAGES[which][0]
    journal = _open(which, tmp_path)
    value = _response(np.random.RandomState(9))
    journal.record_admitted("r-1", "k1", {"issue": "a"})
    journal.record_resolved("r-1", "ok", "k1", module.result_hash(value))
    with pytest.raises(module.WALIntegrityError):
        journal.record_resolved("r-1", "ok", "k1", "h")
    journal.verify_replay("r-1", value)
    with pytest.raises(module.WALIntegrityError):
        journal.verify_replay("r-1", dict(value, statement="diverged"))
