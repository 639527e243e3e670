"""Decision tracing of the daemon: the context and span-tree part of
``cdrs_tpu/obs/trace.py``.

Each ingested event batch gets a :class:`TraceContext` at the tailer
(its resumable cursor and the ``perf_counter_ns`` of the read), and each
processed window one ``decision_trace`` event in the metrics sink: the
trace id, the per-segment durations, the published epoch and the cursor.
Segments are consecutive deltas of one integer clock, so their sum equals
the event's ``total_ns`` exactly.  The slowest decisions (the daemon's
``trace_exemplars``) also embed the full span tree of
:func:`build_span_tree`.

:func:`chrome_trace` turns decisions into the Chrome/Perfetto
``trace_event`` JSON that the daemon's ``/debug/trace`` endpoint serves.
The ``cdrs trace`` reader and its export CLI are not ported yet (ROADMAP
A10b).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

__all__ = ["SEGMENT_ORDER", "STAGE_ORDER", "TraceContext", "mint_batch",
           "decision_trace_id", "build_span_tree", "chrome_trace"]

#: Segment order of a decision, for rendering.
SEGMENT_ORDER = ("tail", "decide", "observe", "publish", "minibatch")

#: Controller stages inside the ``decide`` segment (the record's
#: ``seconds`` keys in pipeline order; ``total`` is never a stage).
STAGE_ORDER = ("fold", "hotspot", "drift", "recluster", "faults", "repair", "rebalance",
               "scrub", "schedule", "serve", "evaluate", "plan")


@dataclass
class TraceContext:
    """Span context of one ingested batch: its cursor (byte offset of its
    block and events to skip there, or the global event index of a feed)
    and the ``perf_counter_ns`` of its read."""

    offset: int
    skip: int
    ingest_ns: int


def mint_batch(offset: int, skip: int, ingest_ns: int | None = None) -> TraceContext:
    """The per-batch context; ``ingest_ns`` defaults to now."""
    return TraceContext(int(offset), int(skip),
                        int(ingest_ns if ingest_ns is not None else time.perf_counter_ns()))


def decision_trace_id(window: int) -> str:
    """The decision's trace id: the window index, so a double run and a
    checkpoint/resume stitch give the same ids."""
    return f"d{int(window):06d}"


def build_span_tree(decision: dict, window_rec: dict | None = None) -> list[dict]:
    """The decision's span tree as a flat parent-indexed list: row 0 the
    root (``total_ns``), then one row per segment, and under ``decide``
    the record's per-stage seconds scaled to the segment's nanoseconds.
    An event that already embeds its tree returns that tree."""
    if decision.get("spans"):
        return list(decision["spans"])
    segs = decision.get("segments_ns") or {}
    rows = [{"name": "decision", "parent": None, "dur_ns": int(decision.get("total_ns", 0))}]
    decide_idx = None
    for name in SEGMENT_ORDER:
        if name not in segs:
            continue
        rows.append({"name": name, "parent": 0, "dur_ns": int(segs[name])})
        if name == "decide":
            decide_idx = len(rows) - 1
    secs = (window_rec or {}).get("seconds")
    if decide_idx is not None and isinstance(secs, dict):
        stage_sum = sum(float(secs[k]) for k in STAGE_ORDER if k in secs)
        decide_ns = int(segs.get("decide", 0))
        if stage_sum > 0 and decide_ns > 0:
            for k in STAGE_ORDER:
                if k in secs:
                    rows.append({"name": f"controller.{k}", "parent": decide_idx,
                                 "dur_ns": int(round(float(secs[k]) / stage_sum * decide_ns))})
    return rows


def _reconcile(d: dict) -> bool:
    segs = d.get("segments_ns") or {}
    return sum(int(v) for v in segs.values()) == int(d.get("total_ns", -1))


def chrome_trace(events) -> dict:
    """Deterministic Chrome/Perfetto ``trace_event`` JSON of the stream's
    ``decision_trace`` events: one complete (``ph: "X"``) event per decision,
    per segment and per controller stage, in window order, on one pid/tid;
    only ``ts``/``dur`` vary between runs.  Raises ``ValueError`` when the
    stream holds no decision."""
    from .aggregate import dedup_windows

    decisions = dedup_windows(events, "decision_trace")
    if not decisions:
        raise ValueError("the stream carries no decision_trace events (tracing rides "
                         "the daemon's metrics sink)")
    windows = {w.get("window"): w for w in dedup_windows(events)}
    decisions = sorted(decisions, key=lambda d: int(d.get("window", 0)))
    base = min(int(d.get("ref_ns", 0)) for d in decisions)
    out = [{"ph": "M", "pid": 1, "tid": 1, "name": "process_name",
            "args": {"name": "cdrs daemon"}}]
    for d in decisions:
        w = int(d.get("window", 0))
        t0 = (int(d.get("ref_ns", 0)) - base) / 1e3
        args = {"trace": d.get("trace"), "window": w, "n_events": d.get("n_events"),
                "epoch_id": d.get("epoch_id"), "reconciled": _reconcile(d)}
        out.append({"ph": "X", "pid": 1, "tid": 1, "cat": "decision", "name": f"decision w{w}",
                    "ts": t0, "dur": int(d.get("total_ns", 0)) / 1e3, "args": args})
        cursor = t0
        segs = d.get("segments_ns") or {}
        for name in SEGMENT_ORDER:
            if name not in segs:
                continue
            dur = int(segs[name]) / 1e3
            out.append({"ph": "X", "pid": 1, "tid": 1, "cat": "segment", "name": name,
                        "ts": cursor, "dur": dur, "args": {"window": w}})
            if name == "decide":
                sub = cursor
                for row in build_span_tree(d, windows.get(w)):
                    if not str(row["name"]).startswith("controller."):
                        continue
                    sdur = int(row.get("dur_ns", 0)) / 1e3
                    out.append({"ph": "X", "pid": 1, "tid": 1, "cat": "stage",
                                "name": row["name"], "ts": sub, "dur": sdur,
                                "args": {"window": w}})
                    sub += sdur
            cursor += dur
    return {"displayTimeUnit": "ms", "traceEvents": out}
