"""Cluster scoring and classification on tensors: the port of
``cdrs_tpu/ops/scoring_jax.py`` (``classify_jax``), single device.

* **Sort medians** — two stable sorts per column (by value, then by label)
  put every cluster's values in one contiguous sorted run; the two middle
  elements are gathered from the run offsets and averaged.  Global medians
  from data average the two middle values too (``jnp.median``'s midpoint
  rule, not ``torch.median``'s lower middle).
* **Histogram medians** — a (k, bins) histogram per feature from one
  integer ``bincount`` over (label, bin) keys; both middle ranks are read
  off the cumulative counts with in-bin linear interpolation.
* **Bisection medians** — ``iters = max(8, ceil(log2(bins)) + 1)`` rounds
  of per-(rank, cluster, feature) threshold counting on
  ``ops/seg_count.label_threshold_count`` (the CUDA kernel on the card),
  both middle ranks at once; the global medians' counts come from the
  same call (its global table over every row with a valid label), so an
  iteration is one pass over x.
* **Score table** and the replication-factor tie-break ``_pick_winner``.
* **Score terms** (``score_table_terms``) — the (k, C, d) gated
  per-feature terms whose feature-axis sum is the score table, host
  float64 numpy off the device path; ``explain category`` reads them.

Empty clusters get NaN medians, which score 0 everywhere.

With an active instrument ``classify`` counts ``kernel.calls.classify``
and spans its median stage (``classify.medians``).

**Mesh** (``classify(mesh_shape=)``): rows and labels split into the
mesh's contiguous data shards (padding rows get label -1, no cluster).
Histogram medians add the shards' integer (k, bins) histograms; bisection
runs the counting kernel once a shard an iteration and adds the int32
(k, 2d) and (2, d) tables; ranges and counts are exact pmin/pmax/psums.
Both are therefore bit-identical to one device.  The exact sort is
one-device only, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScoringConfig
from ..obs import current
from ..obs.devtools import signature
from ..parallel.mesh import data_mesh
from ..utils.logging import stage_span
from .seg_count import label_threshold_count

__all__ = ["HIST_MEDIAN_THRESHOLD", "resolve_median_method", "scoring_tables",
           "cluster_medians_sort", "hist_medians", "bisect_medians",
           "score_table", "score_table_terms", "pick_winner", "classify"]

#: Row count past which "auto" leaves the exact sort medians.
HIST_MEDIAN_THRESHOLD = 2_000_000


def resolve_median_method(method: str, n_rows: int, device, ndata: int = 1) -> str:
    """"auto": exact sort up to ``HIST_MEDIAN_THRESHOLD`` rows on one
    device; past it, or on a sharded mesh, bisection on CUDA (its counting
    kernel) and histograms on the CPU.  "sort" raises on a sharded mesh."""
    if ndata > 1 and method == "sort":
        raise ValueError(
            "median_method='sort' is single-device; sharded scoring "
            "(mesh_shape data > 1) uses histogram or bisection medians "
            "— pass median_method='hist', 'bisect', or 'auto'")
    if method == "auto":
        if ndata == 1 and n_rows <= HIST_MEDIAN_THRESHOLD:
            return "sort"
        return "bisect" if torch.device(device).type == "cuda" else "hist"
    if method not in ("sort", "hist", "bisect"):
        raise ValueError(f"unknown median_method {method!r}")
    return method


def scoring_tables(cfg: ScoringConfig) -> dict[str, torch.Tensor]:
    """The scoring config as float64/bool CPU tensors: W, D (C, d),
    rf, is_moderate (C,), band (), global_medians (d,)."""
    f64 = torch.float64
    return {
        "W": torch.tensor(cfg.weight_matrix(), dtype=f64),
        "D": torch.tensor(cfg.direction_matrix(), dtype=f64),
        "rf": torch.tensor(cfg.rf_vector(), dtype=f64),
        "is_moderate": torch.tensor([c == "Moderate" for c in cfg.categories]),
        "band": torch.tensor(float(cfg.moderate_band), dtype=f64),
        "global_medians": torch.tensor(
            [cfg.global_medians[f] for f in cfg.features], dtype=f64),
    }


def _middle_pair(vals: torch.Tensor, lo, hi) -> torch.Tensor:
    return (vals[lo] + vals[hi]) * 0.5


def cluster_medians_sort(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) exact per-cluster medians; NaN rows for empty clusters."""
    n = x.shape[0]
    lab = labels.long()
    counts = torch.bincount(lab, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    lo = torch.clamp(starts + (counts - 1) // 2, 0, n - 1)
    hi = torch.clamp(starts + counts // 2, 0, n - 1)
    vals, order = torch.sort(x, dim=0, stable=True)
    _, by_label = torch.sort(lab[order], dim=0, stable=True)
    vals = torch.gather(vals, 0, by_label)
    med = _middle_pair(vals, lo, hi)
    return torch.where(counts[:, None] > 0, med, torch.nan)


def global_medians_sort(x: torch.Tensor) -> torch.Tensor:
    """(d,) column medians, the two middle values averaged."""
    n = x.shape[0]
    vals = torch.sort(x, dim=0).values
    return _middle_pair(vals, (n - 1) // 2, n // 2)


def _medians_from_hist(H, counts, lo_f, w_f, bins, ftype):
    """(k,) medians from a (k, bins) histogram: both middle-rank values off
    the cumulative counts, linearly interpolated inside the bin."""
    cum = torch.cumsum(H, dim=1)
    r0 = (counts - 1) // 2
    r1 = counts // 2

    def value_at(r):
        # First bin whose cumulative count exceeds rank r holds it.
        j = torch.argmax((cum > r[:, None]).to(torch.uint8), dim=1)
        before = torch.gather(cum, 1, torch.clamp(j - 1, min=0)[:, None])[:, 0]
        cum_before = torch.where(j > 0, before, 0)
        h = torch.gather(H, 1, j[:, None])[:, 0]
        frac = ((r - cum_before).double() + 0.5) / torch.clamp(h, min=1).double()
        return (j.to(ftype) + frac.to(ftype)) * (w_f / bins)

    med = lo_f + 0.5 * (value_at(r0) + value_at(r1))
    return torch.where(counts > 0, med, torch.nan)


def _row_shards(mesh, x: torch.Tensor, labels: torch.Tensor):
    """[(rows, labels)] of each local data shard (padding labelled -1), and
    the sum/min/max reductions over the shards; one shard without a mesh."""
    if mesh is None:
        def one(parts):
            return parts[0]

        return [(x, labels)], one, one, one
    _, xs = mesh.split(x)
    _, ls = mesh.split(labels, fill=-1)
    return list(zip(xs, ls)), mesh.psum, mesh.pmin, mesh.pmax


def _label_counts_and_range(shards, k, psum, pmin, pmax):
    """(k,) counts of rows with a label in [0, k), and the per-feature min
    and max over those rows."""
    counts = psum([torch.bincount(lab[lab >= 0].long(), minlength=k) for _, lab in shards])
    lo = pmin([torch.where((lab >= 0)[:, None], xs, torch.inf).min(dim=0).values
               for xs, lab in shards])
    hi = pmax([torch.where((lab >= 0)[:, None], xs, -torch.inf).max(dim=0).values
               for xs, lab in shards])
    return counts, lo, hi


def hist_medians(x: torch.Tensor, labels: torch.Tensor, k: int, bins: int,
                 with_global: bool, mesh=None):
    """Per-cluster (k, d) and optionally global (d,) medians from fixed-bin
    histograms; error <= feature range / bins, constant columns exact.
    Labels < 0 mark rows of no cluster."""
    d = x.shape[1]
    ftype = x.dtype
    shards, psum, pmin, pmax = _row_shards(mesh, x, labels.long())
    counts, lo, hi = _label_counts_and_range(shards, k, psum, pmin, pmax)
    n_total = counts.sum().reshape(1)
    meds, gmeds = [], []
    for f in range(d):
        lo_f, hi_f = lo[f], hi[f]
        w_f = torch.where(hi_f > lo_f, hi_f - lo_f, 1.0)
        parts = []
        for xs, lab in shards:
            valid = lab >= 0
            b = torch.clamp(((xs[valid, f] - lo_f.to(xs.device)) / w_f.to(xs.device)
                             * bins).to(torch.int32), 0, bins - 1)
            parts.append(torch.bincount(lab[valid] * bins + b, minlength=k * bins))
        H = psum(parts).reshape(k, bins)
        const = hi_f <= lo_f
        meds.append(torch.where(const, lo_f,
                                _medians_from_hist(H, counts, lo_f, w_f, bins, ftype)))
        if with_global:
            g = _medians_from_hist(H.sum(0, keepdim=True), n_total, lo_f, w_f, bins, ftype)
            gmeds.append(torch.where(const, lo_f, g[0]))
    gm = torch.stack(gmeds) if with_global else None
    return torch.stack(meds, dim=1), gm


def bisect_medians(x: torch.Tensor, labels: torch.Tensor, k: int, bins: int,
                   with_global: bool, mesh=None):
    """Per-cluster (k, d) and optionally global (d,) medians by rank
    bisection on the threshold-counting kernel (one launch a shard an
    iteration).  Labels < 0 mark rows of no cluster.  Error <= feature
    range / 2^iters; constant columns exact."""
    d = x.shape[1]
    ftype = x.dtype
    iters = max(8, int(np.ceil(np.log2(max(bins, 2)))) + 1)
    shards, psum, pmin, pmax = _row_shards(mesh, x, labels.to(torch.int32).contiguous())
    counts, lo_f, hi_f = _label_counts_and_range(shards, k, psum, pmin, pmax)
    n_total = counts.sum()

    # The value at 0-indexed rank r is the smallest v with count(x <= v) >= r+1.
    targets = torch.stack([(counts - 1) // 2 + 1, counts // 2 + 1])        # (2, k)
    g_targets = torch.stack([(n_total - 1) // 2 + 1, n_total // 2 + 1])    # (2,)
    lo = lo_f.float().expand(2, k, d).clone()
    hi = hi_f.float().expand(2, k, d).clone()
    glo = lo_f.float().expand(2, d).clone()
    ghi = hi_f.float().expand(2, d).clone()
    for _ in range(iters):
        thr = (0.5 * (lo + hi)).contiguous()
        # One counting call a shard per iteration: the global ranks ride along.
        gthr = (0.5 * (glo + ghi)).contiguous() if with_global else None
        parts = []
        for xs, lab in shards:
            got = label_threshold_count(xs, lab, thr.to(xs.device),
                                        None if gthr is None else gthr.to(xs.device))
            parts.append(torch.cat([got[0].flatten(), got[1].flatten()]) if with_global
                         else got.flatten())
        tables = psum(parts)
        cb = tables[:k * 2 * d].view(k, 2 * d)
        ge = cb.view(k, 2, d).permute(1, 0, 2) >= targets[:, :, None]
        lo = torch.where(ge, lo, thr)
        hi = torch.where(ge, thr, hi)
        if with_global:
            gge = tables[k * 2 * d:].view(2, d) >= g_targets[:, None]
            glo = torch.where(gge, glo, gthr)
            ghi = torch.where(gge, gthr, ghi)

    const = hi_f <= lo_f
    med = (0.25 * (lo[0] + hi[0] + lo[1] + hi[1])).to(ftype)
    med = torch.where(const[None, :], lo_f[None, :], med)
    med = torch.where(counts[:, None] > 0, med, torch.nan)
    gm = None
    if with_global:
        gm = (0.25 * (glo[0] + ghi[0] + glo[1] + ghi[1])).to(ftype)
        gm = torch.where(const, lo_f, gm)
    return med, gm


def score_table(cluster_medians, global_medians, W, D, is_moderate, band):
    """(k, C) directional-deviation scores."""
    delta = cluster_medians - global_medians[None, :]
    valid = ~torch.isnan(delta)
    delta = torch.where(valid, delta, 0.0)
    abs_d = torch.abs(delta)[:, None, :]
    delta_b = delta[:, None, :]
    valid_b = valid[:, None, :]
    gate_dir = (D[None] == 0) | (torch.sign(delta_b) == D[None])
    term_dir = W[None] * abs_d ** 2
    gate_mod = abs_d < band
    term_mod = W[None] * (1.0 - abs_d) ** 2
    mod = is_moderate[None, :, None]
    gate = torch.where(mod, gate_mod, gate_dir) & valid_b
    term = torch.where(mod, term_mod, term_dir)
    return torch.where(gate, term, 0.0).sum(dim=2)


def score_table_terms(cluster_medians: np.ndarray, cfg: ScoringConfig,
                      global_medians: np.ndarray | None = None) -> np.ndarray:
    """(k, C, d) float64 gated per-feature score terms (host numpy): the
    score table is their sum over the feature axis.  A zero term is a
    closed gate (direction mismatch, or |delta| outside the Moderate band)
    or a NaN median (an empty cluster)."""
    W = np.asarray(cfg.weight_matrix(), dtype=np.float64)
    D = np.asarray(cfg.direction_matrix(), dtype=np.float64)
    if global_medians is None:
        global_medians = np.asarray([cfg.global_medians[f] for f in cfg.features],
                                    dtype=np.float64)
    delta = np.asarray(cluster_medians, dtype=np.float64) - global_medians[None, :]
    valid = ~np.isnan(delta)
    delta = np.where(valid, delta, 0.0)
    delta_b = delta[:, None, :]
    absd_b = np.abs(delta)[:, None, :]
    is_moderate = np.array([c == "Moderate" for c in cfg.categories])[None, :, None]
    gate_dir = (D[None] == 0) | (np.sign(delta_b) == D[None])
    gate_mod = absd_b < cfg.moderate_band
    gate = np.where(is_moderate, gate_mod, gate_dir) & valid[:, None, :]
    term = np.where(is_moderate, W[None] * (1.0 - absd_b) ** 2, W[None] * absd_b ** 2)
    return np.where(gate, term, 0.0)


def pick_winner(scores: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """Argmax score; score ties go to the largest replication factor (the
    first such category)."""
    tied = scores == scores.max(dim=1, keepdim=True).values
    return torch.argmax(torch.where(tied, rf[None, :], -torch.inf), dim=1)


def classify(x: torch.Tensor, labels: torch.Tensor, k: int,
             cfg: ScoringConfig | None = None, global_medians=None,
             tables: dict[str, torch.Tensor] | None = None, mesh_shape=None):
    """Medians -> scores -> categories.  Returns (category_idx (k,),
    scores (k, C), cluster_medians (k, d)) on ``x``'s device.

    ``tables`` (``scoring_tables(cfg)``, e.g. a model's buffers) default to
    ``cfg``'s; ``cfg`` still names the median method and whether the global
    medians come from the data.  ``mesh_shape`` shards the median stage
    over the mesh's data axis.
    """
    cfg = cfg or ScoringConfig()
    tables = scoring_tables(cfg) if tables is None else tables
    dev, ftype = x.device, x.dtype
    mesh = data_mesh(mesh_shape, dev)
    method = resolve_median_method(cfg.median_method, x.shape[0], dev,
                                   1 if mesh is None else mesh.n_data)
    bins = int(cfg.median_bins)
    want_global = global_medians is None and cfg.compute_global_medians_from_data
    tel = current()
    if tel is not None:
        tel.record_kernel_call("classify", signature(
            x, labels, static=(method, int(k), bins, bool(want_global),
                               None if mesh is None else mesh.n_data)))
    with stage_span("classify.medians", dev):
        if method == "bisect":
            medians, gm = bisect_medians(x, labels, k, bins, want_global, mesh)
        elif method == "hist":
            medians, gm = hist_medians(x, labels, k, bins, want_global, mesh)
        else:
            medians = cluster_medians_sort(x, labels, k)
            gm = global_medians_sort(x) if want_global else None
    if global_medians is not None:
        gm = torch.as_tensor(global_medians).to(device=dev, dtype=ftype)
    elif not want_global:
        gm = tables["global_medians"].to(device=dev, dtype=ftype)

    def t(name):
        return tables[name].to(device=dev, dtype=ftype)

    scores = score_table(medians, gm, t("W"), t("D"),
                         tables["is_moderate"].to(dev), t("band"))
    return pick_winner(scores, t("rf")), scores, medians
