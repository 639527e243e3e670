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

The ``cdrs trace`` reader, the Chrome-trace export and its CLI are not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

__all__ = ["SEGMENT_ORDER", "STAGE_ORDER", "TraceContext", "mint_batch",
           "decision_trace_id", "build_span_tree"]

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
