"""Time windows over a globally sorted event stream: the port of
``cdrs_tpu/control/windows.py``.

``iter_windows`` re-slices any batch stream onto the grid
``[t0 + w*W, t0 + (w+1)*W)`` (``t0`` = floor of the first event second),
yielding empty windows too: the controller's scheduler ticks on every
window, events or not.  A window may span several read batches and one
batch several windows; the result does not depend on ``batch_size``.

Sources: a log path (CSV ``access.log`` or ``.cdrsb``, through
``io/events.EventLog.read_csv_batches``), an ``EventLog``, or an iterable of
``EventLog`` batches.  The stream must be time-sorted (checked batch by
batch); a window of one batch is a view of it, not a copy.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.events import EventLog, Manifest

__all__ = ["iter_windows"]


def _slice(ev: EventLog, lo: int, hi: int) -> EventLog:
    return EventLog(ts=ev.ts[lo:hi], path_id=ev.path_id[lo:hi], op=ev.op[lo:hi],
                    client_id=ev.client_id[lo:hi], clients=ev.clients)


def _concat(parts: list[EventLog], manifest: Manifest) -> EventLog:
    if not parts:
        return EventLog(ts=np.zeros(0), path_id=np.zeros(0, dtype=np.int32),
                        op=np.zeros(0, dtype=np.int8), client_id=np.zeros(0, dtype=np.int32),
                        clients=list(manifest.nodes))
    return EventLog.concat(parts)


def iter_windows(source, manifest: Manifest, window_seconds: float, *,
                 batch_size: int = 1_000_000, t0: float | None = None,
                 t0_out: dict | None = None):
    """Yield ``(window_index, EventLog)`` for consecutive windows.

    Empty windows between events are yielded with zero-row logs; the final
    partial window is yielded, windows after the last event are not.
    ``t0_out`` receives the grid origin under ``"t0"`` as soon as it is
    known, so a resumed run can replay the same grid.
    """
    W = float(window_seconds)
    if W <= 0:
        raise ValueError(f"window_seconds must be > 0, got {window_seconds}")
    if isinstance(source, EventLog):
        batches = iter([source])
    elif isinstance(source, (str, bytes, os.PathLike)):
        batches = EventLog.read_csv_batches(source, manifest, batch_size=batch_size)
    else:
        batches = iter(source)

    w = 0
    parts: list[EventLog] = []
    last_ts = -np.inf
    if t0 is not None and t0_out is not None:
        t0_out["t0"] = float(t0)
    for ev in batches:
        n = len(ev)
        if n == 0:
            continue
        if float(ev.ts[0]) < last_ts or not bool(np.all(np.diff(ev.ts) >= 0)):
            raise ValueError("window carving requires a globally time-sorted log "
                             "(the simulator's output contract)")
        last_ts = float(ev.ts[-1])
        if t0 is None:
            t0 = float(np.floor(ev.ts[0]))
            if t0_out is not None:
                t0_out["t0"] = t0
        pos = 0
        while pos < n:
            hi = int(np.searchsorted(ev.ts, t0 + (w + 1) * W, side="left"))
            if hi >= n:
                parts.append(_slice(ev, pos, n))
                pos = n
            else:
                if hi > pos:
                    parts.append(_slice(ev, pos, hi))
                yield w, _concat(parts, manifest)
                parts = []
                w += 1
                pos = hi
    if parts:
        yield w, _concat(parts, manifest)
