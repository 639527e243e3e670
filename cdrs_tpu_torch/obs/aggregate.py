"""Stream aggregation of ``cdrs_tpu/obs/aggregate.py``: the window-record
digests (``pacing_digest`` with its ``percentile``, ``integrity_digest``,
``serve_digest``, ``storage_digest``), the stream folds the Prometheus renderer reads
(``final_counters``, ``merge_hist_buckets``, ``dedup_windows``) and the
scenario cells' ``coverage_fingerprint``."""

from __future__ import annotations

import hashlib

__all__ = ["percentile", "pacing_digest", "integrity_digest", "serve_digest",
           "storage_digest", "merge_hist_buckets", "dedup_windows", "final_counters",
           "coverage_fingerprint"]


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
