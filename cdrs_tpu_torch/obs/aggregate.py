"""Window-record digests: ``pacing_digest`` of ``cdrs_tpu/obs/aggregate.py``
(with its ``percentile``)."""

from __future__ import annotations

__all__ = ["percentile", "pacing_digest"]


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
