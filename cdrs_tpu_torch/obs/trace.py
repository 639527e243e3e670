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

The ``cdrs trace`` reader (:func:`main`) reads a stream back: ``list``
tabulates decisions slowest first, ``show`` renders one decision's span
tree with the epoch and lineage it produced, and ``export`` writes the
Chrome JSON (``--canonical`` zeroes the wall-clock fields, so two runs
export the same bytes).  Its output is the reference's byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

__all__ = ["SEGMENT_ORDER", "STAGE_ORDER", "TraceContext", "mint_batch",
           "decision_trace_id", "build_span_tree", "chrome_trace", "list_decisions",
           "show_decision", "export_trace", "main"]

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


def chrome_trace(events, canonical: bool = False) -> dict:
    """Deterministic Chrome/Perfetto ``trace_event`` JSON of the stream's
    ``decision_trace`` events: one complete (``ph: "X"``) event per decision,
    per segment and per controller stage, in window order, on one pid/tid;
    only ``ts``/``dur`` vary between runs, and ``canonical`` zeroes them.
    Raises ``ValueError`` when the stream holds no decision."""
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
    if canonical:
        for ev in out:
            if "ts" in ev:
                ev["ts"] = 0.0
                ev["dur"] = 0.0
    return {"displayTimeUnit": "ms", "traceEvents": out}


# -- the ``cdrs trace`` reader ------------------------------------------------------


def _load_events(path: str):
    from .sink import read_events

    try:
        events = read_events(path)
    except OSError as e:
        raise SystemExit(f"error: cannot read metrics stream {path!r}: {e.strerror or e}")
    if not events:
        raise SystemExit(f"error: no telemetry events in {path!r} "
                         f"(empty or not a metrics JSONL stream)")
    return events


def _decisions_and_windows(events):
    from .aggregate import dedup_windows

    decisions = dedup_windows(events, "decision_trace")
    if not decisions:
        raise SystemExit(
            "error: stream carries no decision_trace events — produce "
            "one with `cdrs daemon ... --metrics FILE` (tracing rides "
            "the metrics sink)")
    windows = {w.get("window"): w for w in dedup_windows(events)}
    return decisions, windows


def _fmt_ns(ns: int) -> str:
    s = ns / 1e9
    if s >= 1.0:
        return f"{s:.3f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def list_decisions(events, out=None, limit: int | None = None) -> None:
    """Every traced decision, slowest first: its top segment, epoch,
    whether its segments add up to its total, and exemplar marks."""
    out = out or sys.stdout
    decisions, _ = _decisions_and_windows(events)
    rows = sorted(decisions, key=lambda d: -int(d.get("total_ns", 0)))
    if limit:
        rows = rows[:limit]
    print(f"{'trace':<10} {'window':>6} {'total':>10} {'top stage':>18} "
          f"{'epoch':>6} {'ok':>3} {'ex':>3}", file=out)
    for d in rows:
        segs = d.get("segments_ns") or {}
        top = max(segs, key=segs.get) if segs else "?"
        print(f"{d.get('trace', '?'):<10} {d.get('window'):>6} "
              f"{_fmt_ns(int(d.get('total_ns', 0))):>10} "
              f"{top + ' ' + _fmt_ns(int(segs.get(top, 0))):>18} "
              f"{d.get('epoch_id', '—'):>6} "
              f"{'y' if _reconcile(d) else 'N':>3} "
              f"{'*' if d.get('exemplar') else '':>3}", file=out)


def show_decision(events, which: str | None = None, out=None) -> None:
    """One decision's span tree, its segments' shares, and the epoch and
    lineage it produced.  ``which`` is a window index or a trace id
    (``d000007``); by default the slowest decision."""
    out = out or sys.stdout
    decisions, windows = _decisions_and_windows(events)
    if which is None:
        w = int(max(decisions, key=lambda d: int(d.get("total_ns", 0))).get("window", -1))
    else:
        key = which.lstrip("d").lstrip("0") or "0"
        try:
            w = int(key)
        except ValueError:
            raise SystemExit(f"error: {which!r} is not a window index "
                             f"or trace id (want e.g. 7 or d000007)")
    match = [d for d in decisions if int(d.get("window", -1)) == w]
    if not match:
        have = [int(d.get("window", -1)) for d in decisions]
        raise SystemExit(f"error: no traced decision for window {w} "
                         f"(stream has windows {min(have)}..{max(have)})")
    d = match[0]
    rec = windows.get(w)
    print(f"decision {d.get('trace')}  window {w}  "
          f"total {_fmt_ns(int(d.get('total_ns', 0)))}  "
          f"events {d.get('n_events')}  "
          f"{'reconciled' if _reconcile(d) else 'RECONCILIATION BROKEN'}"
          f"{'  [exemplar]' if d.get('exemplar') else ''}", file=out)
    tree = build_span_tree(d, rec)
    total = max(1, int(d.get("total_ns", 1)))
    children: dict = {}
    for i, row in enumerate(tree):
        children.setdefault(row.get("parent"), []).append(i)

    def render(idx: int, depth: int) -> None:
        row = tree[idx]
        dur = int(row.get("dur_ns", 0))
        print(f"  {'  ' * depth}{row['name']:<{28 - 2 * depth}} "
              f"{_fmt_ns(dur):>10}  {dur / total:>6.1%}", file=out)
        for c in children.get(idx, ()):
            render(c, depth + 1)

    for root in children.get(None, ()):
        render(root, 0)
    if d.get("epoch_id") is not None:
        print(f"  -> published epoch {d['epoch_id']} "
              f"(map revision {d.get('map_epoch_id')}, "
              f"plan {str(d.get('plan_hash', ''))[:16]})", file=out)
    causes = (rec or {}).get("causes") or {}
    for name in sorted(causes):
        c = causes[name]
        print(f"  -> lineage {name}: {c.get('files', 0)} files / "
              f"{c.get('bytes', 0)} bytes", file=out)
    batch = d.get("batch") or {}
    if batch:
        print(f"  ingested from cursor offset={batch.get('offset')} "
              f"skip={batch.get('skip')}", file=out)
    print(f"  (full story: cdrs explain window {w} --metrics <stream>)", file=out)


def export_trace(events, out_path: str | None, out=None, canonical: bool = False) -> None:
    """The Chrome JSON of the stream's decisions, to ``out_path`` or ``out``."""
    out = out or sys.stdout
    _decisions_and_windows(events)   # the reader's error for a stream without decisions
    doc = chrome_trace(events, canonical=canonical)
    text = json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
        print(f"wrote {len(doc['traceEvents'])} trace events to {out_path}", file=out)
    else:
        out.write(text)


def main(argv: list[str] | None = None) -> int:
    """``cdrs trace list|show|export`` over a metrics JSONL stream."""
    parser = argparse.ArgumentParser(
        prog="cdrs trace",
        description="per-decision causal traces of the streaming daemon "
                    "(read back from the metrics JSONL stream)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="every traced decision, slowest first, with stage "
                                    "attribution")
    p.add_argument("file", help="metrics JSONL stream")
    p.add_argument("--limit", type=int, default=None, help="show only the N slowest")
    p = sub.add_parser("show", help="one decision's span tree, stage durations and "
                                    "epoch/lineage ids")
    p.add_argument("file", help="metrics JSONL stream")
    p.add_argument("which", nargs="?", default=None,
                   help="window index or trace id (d000007); default = the slowest decision")
    p = sub.add_parser("export", help="Chrome/Perfetto trace_event JSON (chrome://tracing, "
                                      "ui.perfetto.dev)")
    p.add_argument("file", help="metrics JSONL stream")
    p.add_argument("--out", default=None, help="output path (default stdout)")
    p.add_argument("--canonical", action="store_true",
                   help="zero the wall-clock ts/dur fields: double runs become "
                        "byte-identical")
    args = parser.parse_args(argv)
    events = _load_events(args.file)
    try:
        if args.cmd == "list":
            list_decisions(events, limit=args.limit)
        elif args.cmd == "show":
            show_decision(events, args.which)
        else:
            export_trace(events, args.out, canonical=args.canonical)
    except BrokenPipeError:
        # A reader that closed the pipe (``| head``) ends the session cleanly.
        try:
            sys.stdout.close()
        except Exception:
            pass
    return 0
