"""JSONL sink: ``JsonlSink`` of ``cdrs_tpu/obs/sink.py``.

Thread-safe and append-only: every event is one line written by a single
``write()`` under a lock and flushed at once, so a tailing reader never
sees half a record and a killed writer leaves at worst a repeated tail
(readers take the last record per window).  The reference's size-capped
rotation (``max_bytes``) has no caller here and is not ported.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["JsonlSink"]


class JsonlSink:
    """Append one JSON object per line; safe to share across threads."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, event: dict) -> None:
        line = json.dumps(event, default=_coerce, ensure_ascii=False) + "\n"
        with self._lock:
            if self._f is None:
                return  # emitted after close
            self._f.write(line)
            self._f.flush()

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
