"""Decision-quality audit of the controller: ``cdrs_tpu/obs/audit.py``.

Per processed window the auditor scores what the controller decided, from
quantities the loop already holds:

* **Clustering quality** — a simplified silhouette (per point: distance to
  its own accepted centroid against the nearest other one) and a
  Davies-Bouldin index over the same (n, k) distance block, taken on the
  controller's device in float64 over a deterministic stride sample of
  the window's feature snapshot (``AuditConfig.sample_rows``).  It is
  plain PyTorch: the reference computes it in numpy, not in a TPU kernel.
* **Population health** — normalized entropy of the per-category population
  and its total-variation distance against the previous window.
* **Cost/benefit** — the applied plan's replication byte cost and its
  delta, next to the window's replayed locality.

Anomaly flags (the reference's): ``drift_no_gain``, ``budget_saturated``,
``locality_regressed``, ``durability_lost``, ``repair_backlogged``,
``domain_diversity_violated``, ``partition_stalled_repairs``,
``corruption_detected``, ``scrub_starved``, ``hotspot_recluster`` and
``slo_burning`` (thresholds in :class:`AuditConfig`).

One ``{"kind": "audit", ...}`` event per window, ``audit.*`` gauges and an
``audit.flags.<name>`` counter per raised flag.  The auditor only observes;
its window-to-window carry is not checkpointed, so a resumed controller
restarts the audit baseline at its first processed window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["AuditConfig", "DecisionAuditor", "silhouette_db_proxy"]


@dataclass(frozen=True)
class AuditConfig:
    """Anomaly thresholds (see module docstring for flag semantics)."""

    #: Silhouette drop (absolute, silhouette is in [-1, 1]) vs the previous
    #: audited window that makes a same-window re-cluster "no gain".
    silhouette_drop: float = 0.02
    #: Consecutive windows with budget-deferred moves before the budget
    #: counts as saturated.
    budget_windows: int = 3
    #: Before/after locality gap (absolute ratio points) that flags a
    #: window's applied moves as a regression.
    locality_drop: float = 0.01
    #: Consecutive windows with a non-empty repair backlog (fault mode,
    #: faults/repair.py) before the repair pipeline counts as backlogged —
    #: the churn budget is structurally too tight to re-replicate as fast
    #: as nodes fail.
    repair_backlog_windows: int = 3
    #: Row cap for the silhouette/Davies-Bouldin geometry (deterministic
    #: stride sample; None = all rows).  The metrics are means over rows,
    #: so a few thousand samples pin them to the third decimal while
    #: keeping the per-window audit cost flat in n — the audit must stay
    #: inside the telemetry budget at any population size.
    sample_rows: int | None = 4096


def silhouette_db_proxy(X, centroids, labels=None) -> tuple[float, float]:
    """(simplified silhouette, Davies-Bouldin) of X under ``centroids``,
    in float64 on ``X``'s device (a tensor stays where it lies; an array
    is taken on the CPU).

    One (n, k) squared-distance block serves both: silhouette compares each
    point's own-centroid distance with its nearest-other-centroid distance;
    Davies-Bouldin compares per-cluster mean dispersion with centroid
    separation.  ``labels`` defaults to the nearest-centroid assignment
    (first minimum).  Degenerate inputs (k < 2, or every point on one
    centroid) return 0.0 rather than raising.  Per-cluster sums are one-hot
    matmuls, deterministic on the card."""
    import torch

    X = torch.as_tensor(X)
    dev = X.device
    X = X.to(torch.float64)
    c = torch.as_tensor(np.asarray(centroids, dtype=np.float64), device=dev)
    n, k = X.shape[0], c.shape[0]
    if n == 0 or k < 2:
        return 0.0, 0.0
    csq = (c * c).sum(1)
    d2 = torch.clamp((X * X).sum(1)[:, None] - 2.0 * (X @ c.T) + csq[None, :], min=0.0)
    if labels is None:
        labels = torch.argmin(d2, dim=1)
    else:
        labels = torch.as_tensor(labels, device=dev).long()
    rows = torch.arange(n, device=dev)
    own = torch.sqrt(d2[rows, labels])
    d2[rows, labels] = torch.inf
    other = torch.sqrt(d2.min(dim=1).values)
    denom = torch.clamp(torch.maximum(own, other), min=1e-12)
    sil = float(((other - own) / denom).mean())

    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float64)
    counts = onehot.sum(0)
    disp = onehot.T @ own
    disp = torch.where(counts > 0, disp / torch.clamp(counts, min=1.0), 0.0)
    cd = torch.sqrt(torch.clamp(csq[:, None] - 2.0 * (c @ c.T) + csq[None, :], min=0.0))
    cd.fill_diagonal_(torch.inf)
    nonempty = counts > 0
    if int(nonempty.sum()) < 2:
        return sil, 0.0
    # R_ij = (S_i + S_j) / M_ij over nonempty pairs; DB = mean_i max_j R_ij.
    r = (disp[:, None] + disp[None, :]) / torch.clamp(cd, min=1e-12)
    r[:, ~nonempty] = -torch.inf
    per_i = r.max(dim=1).values[nonempty]
    db = float(torch.where(torch.isfinite(per_i), per_i, 0.0).mean())
    return sil, db


class DecisionAuditor:
    """Carries window-to-window audit state for one controller instance."""

    def __init__(self, sizes: np.ndarray, n_categories: int,
                 cfg: AuditConfig | None = None):
        self._sizes = np.asarray(sizes, dtype=np.int64)
        self._n_categories = int(n_categories)
        self.cfg = cfg or AuditConfig()
        self._prev_fractions: np.ndarray | None = None
        self._prev_silhouette: float | None = None
        self._prev_byte_cost: int | None = None
        self._budget_streak = 0
        self._repair_streak = 0

    def audit_window(self, tel, *, window: int, rec: dict,
                     X: np.ndarray | None,
                     centroids: np.ndarray | None,
                     rf: np.ndarray, cat: np.ndarray) -> dict | None:
        """Score one processed window and emit the audit event through
        ``tel``.  ``X`` is the window's feature snapshot when the loop
        already computed one (drift/re-cluster ran); None skips the
        geometry metrics but still audits population/cost/flags.  ``X``
        may be a tensor on the controller's device, where the geometry
        runs.  Returns the audit record (also appended to the stream)."""
        import time

        cfg = self.cfg
        event: dict = {"kind": "audit", "window": int(window),
                       "t": time.time()}

        sil = db = None
        if X is not None and centroids is not None and len(centroids) >= 2:
            cap = cfg.sample_rows
            if cap is not None and len(X) > cap:
                # Deterministic stride sample: same rows every window, so
                # the window-to-window silhouette TREND (what the flags
                # compare) carries no sampling jitter.
                X = X[::max(1, len(X) // cap)][:cap]
            sil, db = silhouette_db_proxy(X, centroids)
            event["silhouette"] = sil
            event["davies_bouldin"] = db

        planned = cat >= 0
        frac = np.bincount(cat[planned].astype(np.int64),
                           minlength=self._n_categories).astype(np.float64)
        total = max(int(planned.sum()), 1)
        frac /= total
        nz = frac[frac > 0]
        # + 0.0 normalizes the -0.0 a one-category population produces.
        entropy = float(-(nz * np.log(nz)).sum() /
                        np.log(max(self._n_categories, 2)) + 0.0)
        event["category_entropy"] = entropy
        event["category_fractions"] = [round(float(f), 6) for f in frac]
        if self._prev_fractions is not None:
            event["population_tv"] = float(
                0.5 * np.abs(frac - self._prev_fractions).sum())

        byte_cost = int((rf.astype(np.int64) * self._sizes).sum())
        event["replication_bytes"] = byte_cost
        if self._prev_byte_cost is not None:
            event["replication_bytes_delta"] = byte_cost - self._prev_byte_cost

        if rec.get("locality_after") is not None:
            event["locality"] = rec["locality_after"]

        flags: list[str] = []
        if (rec.get("recluster") and sil is not None
                and self._prev_silhouette is not None
                and sil < self._prev_silhouette - cfg.silhouette_drop):
            flags.append("drift_no_gain")
        if rec.get("deferred_budget"):
            self._budget_streak += 1
        else:
            self._budget_streak = 0
        if self._budget_streak >= cfg.budget_windows:
            flags.append("budget_saturated")
        before, after = rec.get("locality_before"), rec.get("locality_after")
        if (before is not None and after is not None
                and after < before - cfg.locality_drop):
            flags.append("locality_regressed")
        dur = rec.get("durability")
        if dur is not None:
            event["durability"] = {
                k: dur.get(k, 0) for k in
                ("under_replicated", "at_risk", "lost", "unreachable",
                 "correlated_risk")}
            if dur["lost"]:
                flags.append("durability_lost")
            if dur.get("correlated_risk"):
                flags.append("domain_diversity_violated")
        if rec.get("repair_deferred_partition"):
            flags.append("partition_stalled_repairs")
        integ = rec.get("integrity")
        if integ is not None:
            event["integrity"] = {
                k: integ.get(k, 0) for k in
                ("corrupt_copies", "true_lost", "detected_scrub",
                 "detected_read", "detected_repair")}
            if (integ.get("detected_scrub", 0)
                    + integ.get("detected_read", 0)
                    + integ.get("detected_repair", 0)):
                flags.append("corruption_detected")
        if (rec.get("scrub") or {}).get("starved"):
            flags.append("scrub_starved")
        if rec.get("recluster_trigger") == "hotspot":
            flags.append("hotspot_recluster")
        if rec.get("latency_p99_ms") is not None:
            event["latency_p99_ms"] = rec["latency_p99_ms"]
            event["slo_burn"] = rec.get("slo_burn")
            if (rec.get("slo_burn") or 0.0) > 1.0:
                flags.append("slo_burning")
        if rec.get("repair_backlog"):
            self._repair_streak += 1
        else:
            self._repair_streak = 0
        if self._repair_streak >= cfg.repair_backlog_windows:
            flags.append("repair_backlogged")
        event["flags"] = flags

        self._prev_fractions = frac
        if sil is not None:
            self._prev_silhouette = sil
        self._prev_byte_cost = byte_cost

        tel._emit(event)
        if sil is not None:
            tel.gauge("audit.silhouette", sil)
            tel.gauge("audit.davies_bouldin", db)
        tel.gauge("audit.category_entropy", entropy)
        tel.gauge("audit.replication_bytes", float(byte_cost))
        for f in flags:
            tel.counter_inc(f"audit.flags.{f}")
        return event
