"""Atomic npz snapshots: the port of ``save_state``/``load_state`` of
``cdrs_tpu/utils/checkpoint.py``.

A snapshot is an npz of host arrays plus a ``__meta__`` entry holding a
JSON blob, the JAX package's layout, so either package loads what the
other saved.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

__all__ = ["CheckpointError", "save_state", "load_state"]


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be read (corrupt or truncated)."""


def save_state(path: str, arrays: dict, meta: dict | None = None) -> dict:
    """Write ``arrays`` and ``meta`` to ``path`` atomically.

    The npz goes to a temporary file in the same directory, is fsynced,
    and replaces ``path`` by rename, so ``path`` always holds a whole
    snapshot.  The previous snapshot is kept as ``<path>.prev`` (a hard
    link, or a copy where links fail).  Returns ``{"bytes", "seconds"}``.
    """
    t_start = time.perf_counter()
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            prev = path + ".prev"
            try:
                if os.path.exists(prev):
                    os.unlink(prev)
                os.link(path, prev)
            except OSError:
                shutil.copyfile(path, prev + ".cp")
                os.replace(prev + ".cp", prev)
        os.replace(tmp, path)
        try:
            dirfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:  # pragma: no cover - a platform without directory fsync
            pass
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return {"bytes": int(os.path.getsize(path)),
            "seconds": round(time.perf_counter() - t_start, 6)}


def load_state(path: str) -> tuple[dict, dict]:
    """(arrays, meta); FileNotFoundError when absent, CheckpointError when
    present but unreadable."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = (json.loads(bytes(z["__meta__"].tobytes()).decode())
                    if "__meta__" in z.files else {})
    except FileNotFoundError:
        raise
    except Exception as e:  # numpy and zipfile raise many types on a torn file
        raise CheckpointError(
            f"checkpoint {path!r} is corrupt or truncated ({type(e).__name__}: {e}); "
            "delete it to start over"
            + (f" or restore the retained snapshot {path + '.prev'!r}"
               if os.path.exists(path + ".prev") else "")) from e
    return arrays, meta
