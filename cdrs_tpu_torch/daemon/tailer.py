"""Follow-mode tailer over a growing binary event log (``.cdrsb``):
``cdrs_tpu/daemon/tailer.py`` on the port's reader.

To a reader, a log being appended to looks like a corrupt one: the
writer's last block is still in flight.  The tailer reads the torn tail
as "wait for more bytes" and only ever yields whole blocks:

* a missing file is waited for under ``follow`` and raises otherwise;
* a torn tail (a header or a final block still being written) is left
  unconsumed until its bytes land; without ``follow`` it is the reader's
  canonical corruption error;
* rotation (``path`` -> ``path + ".1"``) shows as the file shrinking below
  the read offset: the predecessor is drained from that offset, then the
  new file is followed from its header;
* ``stop()`` is asked once per poll round and after each round of blocks.

Yields :class:`TailBatch`: a block's events and its byte extent, from
which the daemon builds its resume cursor.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

from ..io.events import _BINARY_ROW_BYTES, BINARY_MAGIC, EventLog, Manifest

__all__ = ["TailBatch", "tail_binary_log"]


class TailBatch(NamedTuple):
    """One whole block of the log."""

    events: EventLog
    offset: int        # byte offset of the block's first byte
    next_offset: int   # byte just past the block: a valid later start


def _wait(poll: float, stop) -> bool:
    """One poll round; True when ``stop()`` asks to return."""
    if stop is not None and stop():
        return True
    time.sleep(poll)
    return False


def _probe_header(path: str):
    """``(clients, paths, first_block)`` when the header and vocabulary
    tables are on disk, None while the file is still a prefix of them;
    a header that cannot become valid raises the reader's ValueError."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(BINARY_MAGIC))
    except FileNotFoundError:
        raise FileNotFoundError(f"missing event log {path!r}: no such file") from None
    if len(head) < len(BINARY_MAGIC) and BINARY_MAGIC.startswith(head):
        return None
    try:
        return EventLog._read_binary_header(path)
    except ValueError as e:
        if "file ends inside" in str(e):
            return None
        raise


def tail_binary_log(path: str, manifest: Manifest, *, follow: bool = False,
                    poll: float = 0.5, stop=None, start_offset: int = 0,
                    ingest_box: dict | None = None):
    """Yield :class:`TailBatch` per complete block of a ``.cdrsb`` log.

    ``follow=False`` reads to the current end of the file and returns;
    ``follow=True`` polls every ``poll`` seconds for appended blocks until
    ``stop()`` is true.  ``start_offset`` resumes at a block boundary
    reported earlier as ``next_offset`` (0 = the first block).
    ``ingest_box``, when given, is stamped ``{"ns": perf_counter_ns}`` as
    each block is read: the origin of the decision trace's ``tail``.
    """
    header = None
    while header is None:
        try:
            header = _probe_header(path)
        except FileNotFoundError:
            if not follow:
                raise
        if header is None:
            if not follow:
                raise ValueError(f"truncated/corrupt header of {path!r}: file ends "
                                 f"inside the header/vocabulary tables")
            if _wait(poll, stop):
                return
    file_clients, file_paths, first_block = header
    plut, clut, clients = EventLog._binary_luts(file_clients, file_paths, manifest)
    pos = int(start_offset) if start_offset else first_block
    if pos < first_block:
        raise ValueError(f"start_offset {pos} outside the block region of {path!r} "
                         f"(first block at byte {first_block})")

    def batch(ts, pid, op, cid) -> EventLog:
        if ingest_box is not None:
            ingest_box["ns"] = time.perf_counter_ns()
        if plut is not None:
            pid = plut[pid]
        return EventLog(ts=ts, path_id=pid, op=op, client_id=clut[cid], clients=list(clients))

    while True:
        try:
            size = os.path.getsize(path)
        except OSError:
            if not follow:
                raise FileNotFoundError(f"missing event log {path!r}: no such file") from None
            if _wait(poll, stop):
                return
            continue
        if size < pos:
            # Rotated: drain the predecessor from our offset (offsets of
            # these blocks refer to ``path + ".1"``), then restart on the
            # new file from its header.
            prev = path + ".1"
            if os.path.exists(prev) and os.path.getsize(prev) >= pos:
                psize = os.path.getsize(prev)
                with open(prev, "rb") as f:
                    f.seek(pos)
                    while pos < psize:
                        blk = pos
                        ts, pid, op, cid, pos = EventLog._read_block(
                            f, pos, psize, prev, len(file_paths), len(file_clients))
                        if ts is not None:
                            yield TailBatch(batch(ts, pid, op, cid), blk, pos)
            header = _probe_header(path)
            if header is None:
                if _wait(poll, stop):
                    return
                continue
            file_clients, file_paths, first_block = header
            plut, clut, clients = EventLog._binary_luts(file_clients, file_paths, manifest)
            pos = first_block
            continue

        progressed = False
        with open(path, "rb") as f:
            f.seek(pos)
            while pos < size:
                # Probe the block's length before parsing: a count or a
                # column that runs past ``size`` is the writer's tail.
                head = f.read(8)
                if len(head) < 8:
                    break
                bn = int(np.frombuffer(head, dtype=np.int64)[0])
                if bn < 0:
                    raise ValueError(f"truncated/corrupt block at byte {pos} of {path!r}")
                if pos + 8 + bn * _BINARY_ROW_BYTES > size:
                    break
                f.seek(pos)
                blk = pos
                ts, pid, op, cid, pos = EventLog._read_block(
                    f, pos, size, path, len(file_paths), len(file_clients))
                progressed = True
                if ts is not None:
                    yield TailBatch(batch(ts, pid, op, cid), blk, pos)
        if not follow:
            if pos < size:
                raise ValueError(f"truncated/corrupt block at byte {pos} of {path!r}")
            return
        if not progressed and _wait(poll, stop):
            return
        if progressed and stop is not None and stop():
            return
