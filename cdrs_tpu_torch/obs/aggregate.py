"""What a telemetry stream means, for every reader: ``cdrs_tpu/obs/aggregate.py``.

``cdrs metrics summarize`` (text), ``report`` (HTML) and ``watch`` only
render what this module folds: the span forest, last-wins window, audit
and decision dedup, counters summed over runs, the window-record digests
(pacing, integrity, serving, storage, scenario cells, the daemon's
critical path) and the roofline rows of the ``kernel`` events
(``obs/kprof.py``).  Unknown kinds are ignored; torn lines never reach
here (``obs/sink.py``).
"""

from __future__ import annotations

import hashlib

__all__ = ["collect", "span_forest", "ordered_span_paths", "percentile",
           "bucket_percentile", "merge_hist_buckets", "dedup_windows", "final_counters",
           "roofline_rows", "fmt_bytes", "serve_digest", "storage_digest", "pacing_digest",
           "integrity_digest", "cells_digest", "coverage_fingerprint",
           "critical_path_digest", "daemon_digest"]


def fmt_bytes(b, sep: str = " ") -> str:
    """Human-readable byte count of every renderer (``sep`` between value
    and unit: the HTML report spaces it, the terminal packs it)."""
    if b is None:
        return "—"
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.3g}{sep}{unit}"
        b /= 1024
    return f"{b:g}{sep}B"  # pragma: no cover - the loop always returns


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile on a sorted copy."""
    s = sorted(values)
    if not s:
        return float("nan")
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def _norm_le(le) -> float:
    """Bucket upper bound from its JSON form (``"+Inf"`` -> inf)."""
    return float("inf") if le in ("+Inf", "inf", None) else float(le)


def merge_hist_buckets(target: dict, event: dict) -> None:
    """Fold one ``hist_bulk`` event into a per-name aggregate
    ``{"count", "sum", "min", "max", "buckets": {le: count}}``."""
    n = int(event.get("count", 0))
    if n <= 0:
        return
    target["count"] = target.get("count", 0) + n
    target["sum"] = target.get("sum", 0.0) + float(event.get("sum", 0.0))
    vmin, vmax = float(event.get("min", 0.0)), float(event.get("max", 0.0))
    target["min"] = vmin if "min" not in target else min(target["min"], vmin)
    target["max"] = vmax if "max" not in target else max(target["max"], vmax)
    buckets = target.setdefault("buckets", {})
    for le, c in event.get("buckets", ()):
        key = _norm_le(le)
        buckets[key] = buckets.get(key, 0) + int(c)


def bucket_percentile(agg: dict, q: float) -> float:
    """Percentile of a bucket aggregate: the upper bound of the first
    bucket whose cumulative count reaches q x total (the overflow bucket
    reports the observed max)."""
    total = agg.get("count", 0)
    if not total:
        return float("nan")
    target = max(1, int(round(q * total)))
    cum = 0
    for le in sorted(agg.get("buckets", {})):
        cum += agg["buckets"][le]
        if cum >= target:
            return agg.get("max", le) if le == float("inf") else le
    return agg.get("max", float("nan"))  # pragma: no cover - counts agree


def span_forest(events: list[dict]):
    """Span events aggregated by their name path from the root:
    ``{path_tuple: {"count", "total"}}``.  Ids are scoped by the event's
    ``run``, so runs appended to one stream aggregate together."""
    by_id = {(e.get("run"), e["id"]): e for e in events if e.get("kind") == "span"}
    agg: dict[tuple, dict] = {}
    for e in by_id.values():
        run = e.get("run")
        path = [e["name"]]
        parent = e.get("parent")
        depth = 0
        while parent is not None and depth < 100:
            pe = by_id.get((run, parent))
            if pe is None:
                break
            path.append(pe["name"])
            parent = pe.get("parent")
            depth += 1
        node = agg.setdefault(tuple(reversed(path)), {"count": 0, "total": 0.0})
        node["count"] += 1
        node["total"] += float(e.get("dur", 0.0))
    return agg


def ordered_span_paths(agg) -> list[tuple]:
    """Depth-first order of a span forest: parents before children,
    siblings by total descending, orphans appended flat."""
    paths = sorted(agg, key=lambda p: (len(p), -agg[p]["total"]))
    ordered: list[tuple] = []

    def add_children(prefix):
        kids = [p for p in paths if len(p) == len(prefix) + 1 and p[:len(prefix)] == prefix]
        for p in sorted(kids, key=lambda p: -agg[p]["total"]):
            ordered.append(p)
            add_children(p)

    add_children(())
    for p in paths:
        if p not in ordered:
            ordered.append(p)
    return ordered


def dedup_windows(events: list[dict], kind: str = "window") -> list[dict]:
    """Per-window records of one ``kind``, last-wins per window index (a
    resumed run's append-only tail may repeat windows), in window order."""
    by_index: dict = {}
    for e in events:
        if e.get("kind") == kind:
            by_index[e.get("window")] = e
    return [by_index[w] for w in sorted(by_index, key=lambda x: (x is None, x))]


def final_counters(events: list[dict]) -> dict[str, float]:
    """Final counter values: the last event of each (run, name) wins, and
    separate runs (each restarting at zero) add."""
    per_run: dict[tuple, float] = {}
    for e in events:
        if e.get("kind") == "counter":
            per_run[(e.get("run"), e["name"])] = e["value"]
    totals: dict[str, float] = {}
    for (_, name), v in per_run.items():
        totals[name] = totals.get(name, 0.0) + v
    return totals


def collect(events: list[dict]) -> dict:
    """One digest of a stream: ``spans`` (forest), ``counters`` (final),
    ``gauges`` (last) and ``gauge_series`` (every value), ``hists``,
    ``hist_buckets``, ``traces`` ({(run, call): kmeans_iter events}),
    ``windows``/``audits``/``decisions`` (last-wins per window),
    ``epoch_pins``, ``cells``, ``kernels`` (one row per (kernel, sig)
    from the ``kernel`` events, the fastest timed launch kept as
    ``exec_seconds``, None when no launch was timed) and ``meta`` (the
    last run stamp)."""
    gauges: dict[str, float] = {}
    gauge_series: dict[str, list[float]] = {}
    hists: dict[str, list[float]] = {}
    hist_buckets: dict[str, dict] = {}
    traces: dict[tuple, list[dict]] = {}
    kernels: dict[tuple, dict] = {}
    meta: dict = {}
    cells: dict[str, dict] = {}
    for e in events:
        kind = e.get("kind")
        if kind == "gauge":
            gauges[e["name"]] = e["value"]
            gauge_series.setdefault(e["name"], []).append(float(e["value"]))
        elif kind == "hist":
            hists.setdefault(e["name"], []).append(float(e["value"]))
        elif kind == "hist_bulk":
            merge_hist_buckets(hist_buckets.setdefault(e["name"], {}), e)
        elif kind == "kmeans_iter":
            traces.setdefault((str(e.get("run")), int(e.get("call", 0))), []).append(e)
        elif kind == "kernel":
            row = kernels.setdefault((e.get("kernel"), e.get("sig")),
                                     {"kernel": e.get("kernel"), "sig": e.get("sig"),
                                      "exec_seconds": None})
            for key in ("flops", "bytes", "dtype", "device", "devices",
                        "collective_bytes_per_iter"):
                if key in e:
                    row[key] = e[key]
            s = e.get("seconds")
            if s is not None and (row["exec_seconds"] is None or s < row["exec_seconds"]):
                row["exec_seconds"] = float(s)
        elif kind == "meta" and isinstance(e.get("run"), dict):
            meta = e["run"]
        elif kind == "cell":
            cells[str(e.get("cell"))] = e
    return {
        "spans": span_forest(events),
        "counters": final_counters(events),
        "gauges": gauges,
        "gauge_series": gauge_series,
        "hists": hists,
        "hist_buckets": hist_buckets,
        "traces": traces,
        "windows": dedup_windows(events, "window"),
        "audits": dedup_windows(events, "audit"),
        "decisions": dedup_windows(events, "decision_trace"),
        "epoch_pins": _dedup_pins(events),
        "cells": list(cells.values()),
        "kernels": [kernels[k] for k in sorted(kernels, key=lambda t: (str(t[0]), str(t[1])))],
        "meta": meta,
    }


def coverage_fingerprint(bits) -> str:
    """sha256 over the sorted, newline-joined distinct coverage bits: runs
    showing the same behaviour set hash alike whatever the order."""
    return hashlib.sha256("\n".join(sorted(set(map(str, bits)))).encode()).hexdigest()


def pacing_digest(windows: list[dict]) -> dict | None:
    """Windows per second of host wall-clock over the window records that
    carry a ``seconds`` dict with a nonzero ``total``, and the planning
    share of it; None when no record is timed.  The plan share is taken
    over the windows that record a ``plan`` slice."""
    secs = [w["seconds"] for w in windows
            if isinstance(w.get("seconds"), dict) and w["seconds"].get("total")]
    total = sum(s["total"] for s in secs)
    if not secs or total <= 0:
        return None
    out = {"windows": len(secs), "windows_per_sec": len(secs) / total}
    plan = [float(s["plan"]) for s in secs if "plan" in s]
    if plan:
        plan_total = sum(s["total"] for s in secs if "plan" in s)
        out["plan_p50_seconds"] = percentile(plan, 0.5)
        out["plan_seconds_fraction"] = sum(plan) / plan_total if plan_total > 0 else 0.0
    # Mesh runs stamp the shard count and the collective bytes an iteration,
    # so windows/sec reads against mesh size; other streams carry no key.
    mesh = [w["mesh"] for w in windows if isinstance(w.get("mesh"), dict)]
    if mesh:
        out["devices"] = int(mesh[-1].get("devices", 1))
        out["collective_bytes_per_iter"] = int(mesh[-1].get("collective_bytes_per_iter", 0))
    return out


def integrity_digest(windows: list[dict]) -> dict | None:
    """Digest of the records carrying ``integrity`` (a run with a corrupt
    fault or a scrubber); None when none does.  ``corrupt_copies`` and
    ``true_lost`` are ground truth; detections split by path (scrub scan,
    verified read, repair source check)."""
    iw = [w for w in windows if w.get("integrity")]
    if not iw:
        return None
    last = iw[-1]["integrity"]
    scrubs = [w["scrub"] for w in iw if w.get("scrub")]
    det = {path: sum(int(w["integrity"].get(f"detected_{path}", 0)) for w in iw)
           for path in ("scrub", "read", "repair")}
    return {
        "windows": len(iw),
        "corrupt_copies_final": last.get("corrupt_copies", 0),
        "corrupt_copies_max": max(int(w["integrity"].get("corrupt_copies", 0)) for w in iw),
        "files_corrupt_final": last.get("files_corrupt", 0),
        "true_lost_final": last.get("true_lost", 0),
        "true_lost_max": max(int(w["integrity"].get("true_lost", 0)) for w in iw),
        "detected_scrub": det["scrub"],
        "detected_read": det["read"],
        "detected_repair": det["repair"],
        "detected_total": det["scrub"] + det["read"] + det["repair"],
        "corrupt_reads_served": sum(int(w.get("reads_corrupt_served") or 0) for w in iw),
        "scrub_bytes_total": sum(int(s.get("bytes", 0)) for s in scrubs),
        "scrub_copies_verified": sum(int(s.get("copies_verified", 0)) for s in scrubs),
        "scrub_starved_windows": sum(1 for s in scrubs if s.get("starved")),
    }


def serve_digest(windows: list[dict]) -> dict | None:
    """Read-path SLO digest over the serving records (those carrying
    ``reads_routed``); None when there are none.  Latency fields are None
    when no window routed a read; outage windows still count toward the
    unavailable fraction."""
    sw = [w for w in windows if w.get("reads_routed") is not None]
    if not sw:
        return None
    routed = sum(int(w.get("reads_routed", 0)) for w in sw)
    unavail = sum(int(w.get("reads_unavailable", 0)) for w in sw)
    total = routed + unavail
    lat = [w for w in sw if w.get("latency_p99_ms") is not None]
    hot = [w for w in sw if w.get("hotspot_files")]
    last_lat = lat[-1] if lat else {}
    burns = [float(w.get("slo_burn", 0.0)) for w in sw]
    return {
        "windows": len(sw),
        "reads_routed": routed,
        "reads_unavailable": unavail,
        "unavailable_fraction": unavail / total if total else 0.0,
        "latency_p50_ms_last": last_lat.get("latency_p50_ms"),
        "latency_p99_ms_last": last_lat.get("latency_p99_ms"),
        "latency_p99_ms_max": max((float(w["latency_p99_ms"]) for w in lat), default=None),
        "slo_burn_max": max(burns),
        "slo_burn_mean": sum(burns) / len(burns),
        "utilization_max": max(float(w.get("utilization_max", 0.0)) for w in sw),
        "hotspot_windows": len(hot),
        "hotspot_files_last": list(hot[-1].get("hotspot_files", ())) if hot else [],
        "hotspot_reclusters": sum(1 for w in sw if w.get("recluster_trigger") == "hotspot"),
        "locality_last": sw[-1].get("serve_locality"),
        "reads_corrupt_served": sum(int(w.get("reads_corrupt_served") or 0) for w in sw),
        "reads_corrupt_detected": sum(int(w.get("reads_corrupt_detected") or 0) for w in sw),
    }


def storage_digest(windows: list[dict]) -> dict | None:
    """Byte and cost digest over the records carrying ``storage``; None when
    there are none.  The final window is the headline; the maximum overhead
    tracks the costliest window (a conversion can briefly hold both forms)."""
    sw = [w for w in windows if w.get("storage")]
    if not sw:
        return None
    last = sw[-1]["storage"]
    return {
        "windows": len(sw),
        "bytes_raw": last.get("bytes_raw"),
        "bytes_stored_final": last.get("bytes_stored"),
        "overhead_ratio_final": last.get("overhead_ratio"),
        "overhead_ratio_max": max(float(w["storage"].get("overhead_ratio", 0.0)) for w in sw),
        "cost_units_final": last.get("cost_units"),
        "ec_files_final": last.get("ec_files"),
        "per_tier_bytes_final": dict(last.get("per_tier_bytes") or {}),
        "per_category_bytes_final": dict(last.get("per_category_bytes") or {}),
    }


def cells_digest(cells: list[dict]) -> dict | None:
    """Scenario-matrix digest over sweep cell records (``kind: cell``);
    None when the stream has none."""
    if not cells:
        return None
    failed = [c for c in cells if not c.get("ok")]
    union = {b for c in cells for b in c.get("coverage") or ()}
    digest = {
        "cells": len(cells),
        "invariants_checked": sum(len(c.get("invariants") or {}) for c in cells),
        "failed": sorted(str(c.get("cell")) for c in failed),
        "failed_invariants": sorted({k for c in failed
                                     for k, v in (c.get("invariants") or {}).items() if not v}),
        "ok": not failed,
        "seconds_total": round(sum(float(c.get("seconds", 0.0)) for c in cells), 3),
    }
    if union:
        digest["coverage_bits"] = len(union)
        digest["fingerprint"] = coverage_fingerprint(union)
    return digest


def _dedup_pins(events: list[dict]) -> list[dict]:
    """``epoch_pin`` events, last-wins per epoch id."""
    by_eid: dict = {}
    for e in events:
        if e.get("kind") == "epoch_pin":
            by_eid[e.get("epoch_id")] = e
    return [by_eid[k] for k in sorted(by_eid, key=lambda x: (x is None, x))]


def critical_path_digest(decisions: list[dict],
                         windows: list[dict] | None = None) -> dict | None:
    """Latency attribution over ``decision_trace`` records (a traced
    daemon run); None without decisions.  Re-checks that each decision's
    integer-ns segments add up to its total and reports mismatches.  Stage
    shares are time-weighted over all decisions, ``decide`` split by the
    joined window record's controller stage seconds."""
    if not decisions:
        return None
    from .trace import SEGMENT_ORDER, STAGE_ORDER

    mismatches = [d for d in decisions
                  if sum(int(v) for v in (d.get("segments_ns") or {}).values())
                  != int(d.get("total_ns", -1))]
    totals = [int(d.get("total_ns", 0)) / 1e9 for d in decisions]
    grand_ns = sum(int(d.get("total_ns", 0)) for d in decisions)
    by_win = {w.get("window"): w for w in (windows or [])}
    acc: dict[str, float] = {}
    for d in decisions:
        segs = d.get("segments_ns") or {}
        for name, ns in segs.items():
            if name == "decide":
                w = by_win.get(d.get("window"))
                secs = (w or {}).get("seconds") \
                    if isinstance((w or {}).get("seconds"), dict) else None
                stage_sum = sum(float(secs[k]) for k in secs if k != "total") if secs else 0.0
                if secs and stage_sum > 0:
                    for k, v in secs.items():
                        if k != "total":
                            acc[k] = acc.get(k, 0.0) + float(v) / stage_sum * int(ns)
                    continue
            acc[name] = acc.get(name, 0.0) + int(ns)
    order = [s for s in SEGMENT_ORDER if s != "decide"] + list(STAGE_ORDER) + ["decide"]
    known = [k for k in order if k in acc] + sorted(k for k in acc if k not in order)
    shares = {k: acc[k] / grand_ns for k in known} if grand_ns else {}
    exemplars = sorted((d for d in decisions if d.get("exemplar")),
                       key=lambda d: -int(d.get("total_ns", 0)))
    return {
        "decisions": len(decisions),
        "reconciled": not mismatches,
        "reconcile_mismatches": len(mismatches),
        "total_p50_seconds": percentile(totals, 0.5),
        "total_p99_seconds": percentile(totals, 0.99),
        "stage_shares": shares,
        "exemplars": [{"trace": d.get("trace"), "window": d.get("window"),
                       "total_seconds": int(d.get("total_ns", 0)) / 1e9} for d in exemplars],
    }


def daemon_digest(decisions: list[dict], epoch_pins: list[dict] | None = None) -> dict | None:
    """Publications, pin coverage and the event-to-decision tail of a
    traced daemon stream; None without decisions.  ``epochs_published`` is
    the largest epoch id seen (exact across a resume)."""
    if not decisions:
        return None
    pins = epoch_pins or []
    totals = [int(d.get("total_ns", 0)) / 1e9 for d in decisions]
    p2p = [int(p["publish_to_pin_ns"]) / 1e9 for p in pins
           if p.get("publish_to_pin_ns") is not None]
    return {
        "decisions": len(decisions),
        "epochs_published": max(int(d.get("epoch_id", 0)) for d in decisions),
        "epochs_pinned": len(pins),
        "event_to_decision_p50_seconds": percentile(totals, 0.5),
        "event_to_decision_p99_seconds": percentile(totals, 0.99),
        "publish_to_pin_p50_seconds": percentile(p2p, 0.5) if p2p else None,
    }


def roofline_rows(digest: dict, peak_flops: float | None = None,
                  peak_gbps: float | None = None) -> list[dict]:
    """One roofline row per (kernel, signature) of the stream's ``kernel``
    events.

    Each row extends ``collect``'s with ``intensity`` (operations a
    byte), the achieved ``gflops`` and ``gbps`` of the timed launch, and,
    where the card's peaks are known (``obs/kprof.resolve_peaks`` of the
    row's card, else of the run stamp's ``device_name``; ``peak_flops``
    in operations/s and ``peak_gbps`` override either side), the least
    time of the work (``bound_seconds``: the larger of bytes over the
    memory rate and operations over the peak rate of the row's type),
    which bound that is (``bound``: "bytes" or "operations") and the
    share of it the launch reached (``peak_fraction`` = bound / time).
    A row whose launch was not timed (a CPU run) has no achieved rates
    and no share."""
    from .kprof import bound_seconds, resolve_peaks

    rows = []
    for x in digest.get("kernels", []):
        row = dict(x)
        flops, n_bytes = x.get("flops"), x.get("bytes")
        if flops and n_bytes:
            row["intensity"] = flops / n_bytes
        secs = x.get("exec_seconds")
        if secs and flops:
            row["gflops"] = flops / secs / 1e9
        if secs and n_bytes:
            row["gbps"] = n_bytes / secs / 1e9
        peaks = resolve_peaks(x.get("device") or digest.get("meta", {}).get("device_name"),
                              x.get("dtype", "float32"))
        p_ops = peak_flops if peak_flops is not None else (peaks[0] if peaks else None)
        p_bw = peak_gbps * 1e9 if peak_gbps else (peaks[1] if peaks else None)
        if p_ops and p_bw and flops is not None and n_bytes is not None:
            row["bound_seconds"], row["bound"] = bound_seconds(
                {"flops": flops, "bytes": n_bytes}, (p_ops, p_bw))
            if secs:
                row["peak_fraction"] = row["bound_seconds"] / secs
        rows.append(row)
    return rows
