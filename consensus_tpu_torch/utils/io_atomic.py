"""Crash-safe artifact IO: atomic writes and a fsync'd append-only journal
(PyTorch port of ``consensus_tpu/utils/io_atomic.py``).

* **Atomic replace** (:func:`atomic_write_text` / ``_bytes`` / ``_json``):
  write to a ``.tmp-*`` sibling in the same directory, fsync, then
  ``os.replace`` onto the destination: readers see either the old complete
  file or the new one, never a prefix.
* **Journal** (:class:`JournalWriter` / :func:`read_journal`): an
  append-only JSONL log where each line is one fsync'd record (schema
  ``consensus_tpu.journal.v1``, the JAX package's, so either package reads
  the other's journals).  A crash can lose at most the line being written;
  a torn final line is detected and skipped on read.  This is what makes
  ``Experiment.run`` resumable.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Union

PathLike = Union[str, os.PathLike]

#: Journal line schema identifier (bump on incompatible change).
JOURNAL_SCHEMA = "consensus_tpu.journal.v1"


def atomic_write_bytes(path: PathLike, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp-file + fsync + atomic rename."""
    target = pathlib.Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=f".tmp-{target.name}-", dir=str(target.parent))
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp_name, target)
    except BaseException:
        # The destination is untouched; remove the partial tmp file.
        try:
            os.unlink(tmp_name)
        except OSError:
            pass
        raise


def atomic_write_text(path: PathLike, text: str, encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))


def atomic_write_json(path: PathLike, payload: Any, indent: int = 2) -> None:
    atomic_write_text(path, json.dumps(payload, indent=indent))


def sanitize_frame_for_csv(frame):
    """Replace NUL characters in a DataFrame's string cells with U+FFFD (CSV
    cannot carry ``\\x00``; random-weight models emit them)."""
    object_columns = [c for c in frame.columns if frame[c].dtype == object]
    dirty = [
        c for c in object_columns
        if frame[c].map(lambda v: isinstance(v, str) and "\x00" in v).any()
    ]
    if not dirty:
        return frame
    frame = frame.copy()
    for column in dirty:
        frame[column] = frame[column].map(
            lambda v: v.replace("\x00", "�") if isinstance(v, str) else v
        )
    return frame


class JournalWriter:
    """Append-only JSONL journal with per-record fsync.

    Thread-safe: worker threads of a concurrent experiment append completed
    rows as they finish.  Each record lands as one line
    ``{"schema": ..., **record}``; once :meth:`append` returns, the record
    survives a kill."""

    def __init__(self, path: PathLike, schema: str = JOURNAL_SCHEMA):
        self.path = pathlib.Path(path)
        self.schema = schema
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps({"schema": self.schema, **record}, ensure_ascii=False)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def read_journal(path: PathLike, schema: Optional[str] = JOURNAL_SCHEMA) -> List[Dict[str, Any]]:
    """All intact records from a journal file (missing file -> ``[]``).

    A torn final line (the one a crash interrupted) fails to parse and is
    skipped: only the LAST line can be torn, and its record was never
    acknowledged, so skipping is lossless."""
    journal_path = pathlib.Path(path)
    if not journal_path.exists():
        return []
    records: List[Dict[str, Any]] = []
    with open(journal_path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a mid-append crash
            if schema is not None and record.get("schema") != schema:
                continue
            records.append(record)
    return records


def iter_journal(path: PathLike) -> Iterator[Dict[str, Any]]:
    yield from read_journal(path)
