"""Crash-safe artifact writes (the subset of ``consensus_tpu/utils/io_atomic.py``
the port uses).

Write to a ``.tmp-*`` sibling in the same directory, fsync, then
``os.replace`` onto the destination: readers see either the old complete
file or the new one, never a prefix.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Any, Union

PathLike = Union[str, os.PathLike]


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
