"""Window-record digests of ``cdrs_tpu/obs/aggregate.py``: ``pacing_digest``
(with its ``percentile``) and ``integrity_digest``."""

from __future__ import annotations

__all__ = ["percentile", "pacing_digest", "integrity_digest"]


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile on a sorted copy."""
    s = sorted(values)
    if not s:
        return float("nan")
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


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
