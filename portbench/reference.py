"""The plain reference: Lloyd's k-means, its k-means|| init, the bisection
medians, the score table and the winning category, in plain PyTorch, and
the comparisons that judge the program's answers.

It imports neither JAX nor any part of the program; it takes the points and
the scoring tables from the benchmark and works out everything else again.
Distances and sums run in blocks of ``ROWS`` rows so that a pass at ten
million rows fits beside the points.  TF32 stays off in the backends: the
``tf32`` precision rounds both operands of a product to TF32 explicitly, so
the control computes alike on the CPU and on the card.

Two uses:

* the **judge** (float64): ``label_gap``, ``centroid_gap``, ``init_excess``,
  ``median_gap``, ``category_gap``;
* the **reference in the program's place** (``Reference``): the same
  solve and decision in float32, or in TF32 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import keyed

#: Rows a block of a distance or sum pass.
ROWS = 1 << 18


def no_tf32() -> None:
    """Keep every float32 product in float32 (the configuration's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    i = t.contiguous().view(torch.int32)
    i = (i + (1 << 12)) & ~((1 << 13) - 1)
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``: "float64", "float32" or "tf32"."""
    if precision == "float64":
        return a.double() @ b.double()
    a, b = a.float(), b.float()
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def _blocks(n: int):
    for i in range(0, n, ROWS):
        yield i, min(n, i + ROWS)


# -- Lloyd ------------------------------------------------------------------------


def assign(X: torch.Tensor, c: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """(n,) int32 label of each row's nearest centroid by ``|c|^2 - 2 x.c``,
    the first minimum winning."""
    ct = c.double() if precision == "float64" else c.float()
    csq = (ct * ct).sum(dim=1)
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for i, j in _blocks(X.shape[0]):
        out[i:j] = torch.argmin(csq[None, :] - 2.0 * _mm(X[i:j], ct.T, precision), dim=1)
    return out


def cluster_sums(X: torch.Tensor, labels: torch.Tensor, k: int, precision: str = "float32"):
    """(sums (k, d), counts (k,)) of the rows by label: sums as a one-hot
    product in ``precision``, counts exact."""
    dt = torch.float64 if precision == "float64" else torch.float32
    sums = torch.zeros((k, X.shape[1]), dtype=dt, device=X.device)
    for i, j in _blocks(X.shape[0]):
        onehot = torch.nn.functional.one_hot(labels[i:j].long(), k).to(dt)
        sums += _mm(onehot.T, X[i:j], precision).to(dt)
    counts = torch.bincount(labels.long(), minlength=k)
    return sums, counts


def reseed_rows(seed: int | None, it: int, k: int, n: int) -> torch.Tensor:
    """(k,) rows an empty cluster takes at iteration ``it``: uniform draws
    from the keyed reseed stream, made on the CPU."""
    return torch.randint(0, n, (k,), generator=keyed.generator(seed, keyed.RESEED, it, "cpu"))


def lloyd(X, c0, k, max_iter, tol=0.0, seed=None, precision="float32"):
    """Lloyd from ``c0``: (centroids, labels against the centroids before
    the last update, iterations).  An empty cluster takes its reseed row;
    ``tol <= 0`` runs exactly ``max_iter`` iterations."""
    c = c0.float()
    c_prev, it, shift = c, 0, math.inf
    n = X.shape[0]
    while it < max_iter and (tol <= 0 or it == 0 or shift >= tol):
        lab = assign(X, c, precision)
        sums, counts = cluster_sums(X, lab, k, precision)
        rows = X[reseed_rows(seed, it, k, n).to(X.device)].float()
        new = torch.where(counts[:, None] > 0,
                          sums.float() / counts.clamp(min=1)[:, None].float(), rows)
        shift = float(torch.sqrt(((new - c) ** 2).sum()))
        c_prev, c = c, new
        it += 1
    return c, assign(X, c_prev, precision), it


def _gumbel(seed, stream, index, n, device):
    gen = keyed.generator(seed, stream, index, device)
    return -torch.log(torch.empty(n, dtype=torch.float64, device=device).exponential_(generator=gen))


def _sq_to_row(x, x_sq, row, precision):
    return torch.clamp(x_sq - 2.0 * _mm(x, row[:, None], precision)[:, 0] + torch.dot(row, row),
                       min=0.0)


def _min_sq(x, x_sq, rows, precision):
    r_sq = (rows * rows).sum(dim=1)[None, :]
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for i, j in _blocks(x.shape[0]):
        out[i:j] = torch.clamp(x_sq[i:j, None] - 2.0 * _mm(x[i:j], rows.T, precision) + r_sq,
                               min=0.0).min(dim=1).values
    return out


def kmeans_par_init(X, k, seed, rounds, oversample, precision="float32", cand_iters=10):
    """k-means||: ``rounds`` passes each taking the top ``ceil(oversample k /
    rounds)`` rows of log(D^2) + Gumbel noise, candidate weights from one
    assignment, a weighted D^2 reduction to k, ``cand_iters`` weighted Lloyd
    steps on the candidates."""
    x = X.double() if precision == "float64" else X.float()
    n = x.shape[0]
    per_round = max(1, int(np.ceil(oversample * k / rounds)))
    x_sq = (x * x).sum(dim=1)
    cands = [x[torch.argmax(_gumbel(seed, keyed.KMEANS_INIT, 0, n, x.device))][None, :]]
    min_sq = _sq_to_row(x, x_sq, cands[0][0], precision)
    for r in range(rounds):
        logits = torch.where(min_sq.sum() > 0, torch.log(torch.clamp(min_sq, min=1e-38)), 0.0)
        idx = torch.topk(logits + _gumbel(seed, keyed.KMEANS_INIT, r + 1, n, x.device),
                         per_round).indices
        rows = x[idx]
        cands.append(rows)
        min_sq = torch.minimum(min_sq, _min_sq(x, x_sq, rows, precision))
    cands = torch.cat(cands)
    wts = torch.bincount(assign(x, cands, precision).long(),
                         minlength=cands.shape[0]).to(x.dtype)
    cent = _weighted_kmeanspp(cands, wts, seed, k, precision)
    return _weighted_lloyd(cands, wts, cent, cand_iters, precision)


def _weighted_kmeanspp(c, wts, seed, k, precision):
    n_cand = c.shape[0]
    c_sq = (c * c).sum(dim=1)
    wlog = torch.where(wts > 0, torch.log(wts), -math.inf)
    cent = c.new_empty((k, c.shape[1]))
    cent[0] = c[torch.argmax(wlog + _gumbel(seed, keyed.KMEANS_REDUCE, 0, n_cand, c.device))]
    min_sq = _sq_to_row(c, c_sq, cent[0], precision)
    for i in range(1, k):
        total = (min_sq * wts).sum()
        logits = torch.where(total > 0, wlog + torch.log(torch.clamp(min_sq, min=1e-38)), wlog)
        cent[i] = c[torch.argmax(logits + _gumbel(seed, keyed.KMEANS_REDUCE, i, n_cand, c.device))]
        min_sq = torch.minimum(min_sq, _sq_to_row(c, c_sq, cent[i], precision))
    return cent


def _weighted_lloyd(c, wts, cent, iters, precision):
    k = cent.shape[0]
    for _ in range(iters):
        dist = (cent * cent).sum(dim=1)[None, :] - 2.0 * _mm(c, cent.T, precision)
        onehot = torch.nn.functional.one_hot(torch.argmin(dist, dim=1), k).to(c.dtype)
        sums = _mm(onehot.T, c * wts[:, None], precision)
        counts = _mm(onehot.T, wts[:, None], precision)[:, 0]
        cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return cent


# -- scoring ----------------------------------------------------------------------


def bisect_medians(X, labels, k, bins):
    """Per-cluster (k, d) and global (d,) medians by rank bisection in
    float32, the two middle ranks at once: ``max(8, ceil(log2 bins) + 1)``
    halvings of [min, max] by exact counts of ``x <= threshold``; a constant
    column gives its value, an empty cluster NaN."""
    n, d = X.shape
    iters = max(8, int(np.ceil(np.log2(max(bins, 2)))) + 1)
    lab = labels.long()
    counts = torch.bincount(lab, minlength=k)
    lo_f = X.min(dim=0).values.float()
    hi_f = X.max(dim=0).values.float()
    targets = torch.stack([(counts - 1) // 2 + 1, counts // 2 + 1])
    g_targets = torch.tensor([(n - 1) // 2 + 1, n // 2 + 1], device=X.device)
    lo = lo_f.expand(2, k, d).clone()
    hi = hi_f.expand(2, k, d).clone()
    glo = lo_f.expand(2, d).clone()
    ghi = hi_f.expand(2, d).clone()
    for _ in range(iters):
        thr = 0.5 * (lo + hi)
        gthr = 0.5 * (glo + ghi)
        cb = torch.zeros((2, k, d), dtype=torch.int64, device=X.device)
        gc = torch.zeros((2, d), dtype=torch.int64, device=X.device)
        for i, j in _blocks(n):
            x, lb = X[i:j].float(), lab[i:j]
            for r in range(2):
                cb[r].index_add_(0, lb, (x <= thr[r][lb]).long())
                gc[r] += (x <= gthr[r]).sum(dim=0)
        ge = cb >= targets[:, :, None]
        lo = torch.where(ge, lo, thr)
        hi = torch.where(ge, thr, hi)
        gge = gc >= g_targets[:, None]
        glo = torch.where(gge, glo, gthr)
        ghi = torch.where(gge, gthr, ghi)
    const = hi_f <= lo_f
    med = 0.25 * (lo[0] + hi[0] + lo[1] + hi[1])
    med = torch.where(const[None, :], lo_f[None, :], med)
    med = torch.where(counts[:, None] > 0, med, torch.nan)
    gm = torch.where(const, lo_f, 0.25 * (glo[0] + ghi[0] + glo[1] + ghi[1]))
    return med, gm


def scores(med, gm, tables):
    """(k, C) directional-deviation scores in float64."""
    W = torch.tensor(tables["W"], dtype=torch.float64, device=med.device)
    D = torch.tensor(tables["D"], dtype=torch.float64, device=med.device)
    moderate = torch.tensor(tables["is_moderate"], device=med.device)[None, :, None]
    delta = med.double() - gm.double()[None, :]
    valid = ~torch.isnan(delta)
    delta = torch.where(valid, delta, 0.0)
    absd = torch.abs(delta)[:, None, :]
    gate_dir = (D[None] == 0) | (torch.sign(delta[:, None, :]) == D[None])
    gate = torch.where(moderate, absd < tables["band"], gate_dir) & valid[:, None, :]
    term = torch.where(moderate, W[None] * (1.0 - absd) ** 2, W[None] * absd ** 2)
    return torch.where(gate, term, 0.0).sum(dim=2)


def winner(s, rf):
    """The best category of each cluster; ties go to the largest rf, the
    first such category."""
    rf_t = torch.tensor(rf, dtype=torch.float64, device=s.device)
    tied = s == s.max(dim=1, keepdim=True).values
    return torch.argmax(torch.where(tied, rf_t[None, :], -torch.inf), dim=1)


class Reference:
    """The reference in the program's place (the control runs it in TF32)."""

    name = "reference"

    def __init__(self, precision: str = "float32"):
        self.precision = precision

    def solve(self, X, k, *, tol, max_iter, seed=None, init_centroids=None,
              init_method="kmeans||", init_oversample=2.0, init_rounds=5):
        c0 = init_centroids
        if c0 is None:
            c0 = kmeans_par_init(X, k, seed, init_rounds, init_oversample, self.precision)
        return lloyd(X, c0, k, max_iter, tol, seed, self.precision)

    def classify(self, X, labels, k, tables):
        med, gm = bisect_medians(X, labels, k, tables["bins"])
        return winner(scores(med, gm, tables), tables["rf"]), med

    def launches(self) -> dict:
        return {"b1": 0, "b2": 0}


# -- the judge (float64) ----------------------------------------------------------


def label_gap(X, c, labels) -> float:
    """Widest gap by which a row's squared distance to its labelled centroid
    lies above its distance to the nearest, in float64, over |x| |c_label|."""
    c64 = c.double()
    csq = (c64 * c64).sum(dim=1)
    cn = torch.sqrt(csq)
    worst = torch.zeros((), dtype=torch.float64, device=X.device)
    for i, j in _blocks(X.shape[0]):
        x = X[i:j].double()
        dist = csq[None, :] - 2.0 * (x @ c64.T)
        lab = labels[i:j].long()
        gap = torch.gather(dist, 1, lab[:, None])[:, 0] - dist.min(dim=1).values
        scale = torch.sqrt((x * x).sum(dim=1)) * cn[lab]
        worst = torch.maximum(worst, (gap / torch.clamp(scale, min=1e-300)).max())
    return float(worst)


def centroid_gap(X, labels, c, k, seed, last_it) -> float:
    """Widest distance between a returned centroid and the float64 mean of
    the rows labelled with it (the reseed row for an empty cluster), over
    the points' root-mean-square norm."""
    sums, counts = cluster_sums(X, labels, k, "float64")
    rows = X[reseed_rows(seed, last_it, k, X.shape[0]).to(X.device)].double()
    want = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None].double(), rows)
    rms = 0.0
    for i, j in _blocks(X.shape[0]):
        rms += float((X[i:j].double() ** 2).sum())
    rms = math.sqrt(rms / X.shape[0])
    return float(torch.linalg.vector_norm(c.double() - want, dim=1).max()) / rms


def inertia(X, c) -> float:
    """Sum over the rows of the squared distance to the nearest centroid, in
    float64."""
    c64 = c.double()
    csq = (c64 * c64).sum(dim=1)
    total = 0.0
    for i, j in _blocks(X.shape[0]):
        x = X[i:j].double()
        dist = (x * x).sum(dim=1)[:, None] - 2.0 * (x @ c64.T) + csq[None, :]
        total += float(torch.clamp(dist.min(dim=1).values, min=0.0).sum())
    return total


def init_excess(X, c_init, k, seed, rounds, oversample) -> float:
    """How far the inertia of a returned k-means|| init lies above that of
    the reference's init in float64 from the same keyed noise, as a share of
    the latter (below 0 where it is lower)."""
    ref = kmeans_par_init(X, k, seed, rounds, oversample, "float64")
    return inertia(X, c_init) / inertia(X, ref) - 1.0


def median_gap(med, ref_med) -> float:
    """Largest absolute difference of the per-cluster medians (NaN in both
    counts 0, NaN in one counts inf)."""
    a, b = med.double(), ref_med.double().to(med.device)
    diff = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, torch.abs(a - b))
    return float(torch.nan_to_num(diff, nan=math.inf).max())


def category_gap(cats, ref_med, ref_gm, tables) -> float:
    """Widest gap by which a returned category's float64 score lies below
    the best, over the best; 1 where it ties the best but loses the rf rule."""
    s = scores(ref_med, ref_gm, tables)
    best = winner(s, tables["rf"])
    cats = torch.as_tensor(np.asarray(cats), device=s.device).long()
    got = torch.gather(s, 1, cats[:, None])[:, 0]
    top = torch.gather(s, 1, best[:, None])[:, 0]
    gap = (top - got) / torch.clamp(torch.abs(top), min=1e-300)
    gap = torch.where((cats != best) & (got == top), 1.0, gap)
    return float(gap.max())
