"""JSONL sink and its readers: ``cdrs_tpu/obs/sink.py``.

Thread-safe and append-only: every event is one line written by a single
``write()`` under a lock and flushed at once, so a tailing reader never
sees half a record and a killed writer leaves at worst a repeated tail
(readers take the last record per window).  A torn final line is skipped
by the readers.

Rotation is opt-in: ``JsonlSink(path, max_bytes=N)`` shifts the live file
to ``path.1`` (``path.1`` to ``path.2``, ...; larger suffix = older) when
the next line would take it past ``max_bytes``.  A line is never split
across files, and a line larger than ``max_bytes`` lands whole.
``read_events`` and ``iter_events`` read the rotated set oldest first, as
one stream; ``iter_events(follow=True)`` also drains the just-rotated
``path.1`` when a rotation lands between two polls (more than one
rotation inside one poll can skip the middle file).  The files are the
reference's byte for byte for the same events.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["JsonlSink", "read_events", "iter_events", "rotated_paths"]


class JsonlSink:
    """Append one JSON object per line; safe to share across threads."""

    def __init__(self, path: str, max_bytes: int | None = None):
        self.path = path
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = max_bytes
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self._size = self._f.tell()

    def _rotate(self) -> None:
        """Shift-rotate under the held lock: every existing suffix up by one
        (highest first), the live file to ``.1``, then reopen it empty."""
        self._f.close()
        n = 1
        while os.path.exists(f"{self.path}.{n}"):
            n += 1
        for i in range(n - 1, 0, -1):
            os.replace(f"{self.path}.{i}", f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def emit(self, event: dict) -> None:
        line = json.dumps(event, default=_coerce, ensure_ascii=False) + "\n"
        n_bytes = len(line.encode("utf-8"))
        with self._lock:
            if self._f is None:
                return  # emitted after close
            if (self.max_bytes is not None and self._size > 0
                    and self._size + n_bytes > self.max_bytes):
                self._rotate()
            self._f.write(line)
            self._f.flush()
            self._size += n_bytes

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _coerce(obj):
    """JSON fallback for numpy scalars and arrays (``tolist``), else ``str``."""
    fn = getattr(obj, "tolist", None)
    if callable(fn):
        return fn()
    return str(obj)


def rotated_paths(path: str) -> list[str]:
    """The rotated predecessors of ``path``, oldest first (``path.N`` ..
    ``path.1``); empty when the file never rotated."""
    out = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        out.append(f"{path}.{n}")
        n += 1
    out.reverse()
    return out


def _read_one(path: str) -> list[dict]:
    events: list[dict] = []
    # errors="replace": a character torn by a killed writer fails the JSON
    # parse below and is skipped like any torn line.
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


def read_events(path: str) -> list[dict]:
    """Every event of a JSONL stream, rotated predecessors first; torn
    lines are skipped."""
    events: list[dict] = []
    for p in rotated_paths(path):
        events.extend(_read_one(p))
    events.extend(_read_one(path))
    return events


def iter_events(path: str, *, follow: bool = False, poll: float = 0.5, stop=None):
    """Yield the events of a (possibly growing) stream as they land.

    The file is read in binary and only complete lines are decoded, so a
    partial final line waits for its newline.  With ``follow`` a missing
    file is waited for, and the reader polls every ``poll`` seconds until
    ``stop()`` returns true; a file that shrank below the read offset was
    rotated (its unread tail is drained from ``path.1``) or truncated
    (the buffered partial line is dropped).
    """
    for p in rotated_paths(path):
        yield from _read_one(p)
    buf = b""
    pos = 0
    while True:
        try:
            with open(path, "rb") as f:
                if os.fstat(f.fileno()).st_size < pos:
                    drained = False
                    try:
                        if os.path.getsize(path + ".1") >= pos:
                            with open(path + ".1", "rb") as pf:
                                pf.seek(pos)
                                buf += pf.read()
                            drained = True
                    except OSError:
                        pass
                    if not drained:
                        buf = b""
                    pos = 0
                f.seek(pos)
                chunk = f.read()
                pos = f.tell()
        except FileNotFoundError:
            if not follow:
                raise
            chunk = b""
        buf += chunk
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            raw, buf = buf[:nl], buf[nl + 1:]
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
        if not follow:
            return
        if stop is not None and stop():
            return
        time.sleep(poll)
