"""KMeans++ / k-means|| init and the Lloyd loop on tensors: the port of
``cdrs_tpu/ops/kmeans_jax.py`` (``kmeans_jax_full`` / ``kmeans_jax``),
single device.

* **Lloyd step** — ``ops/lloyd.lloyd_assign_reduce``: the CUDA kernel on
  the card (f32/bf16 points), its plain PyTorch version on the CPU.  The
  loop condition is the reference's ``it < max_iter and (it == 0 or
  shift >= tol)``; ``tol <= 0`` runs exactly ``max_iter`` iterations.
  ``shift`` (the Frobenius centroid move) is the one host read per
  iteration.
* **Labels** come from one pass against the centroids *before* the last
  update (the reference's loop order).
* **Empty clusters** are reseeded to a uniformly drawn valid row, from a
  generator keyed by the global iteration ``iter_offset + it``, so a run
  resumed at ``iter_offset`` draws what an uninterrupted run would.  The
  draws of each block of 64 iterations are made together and their rows
  gathered on the device at once, so no iteration waits on the host for
  them.
* **D² init** — Gumbel-max over the valid prefix: the noise for all
  ``n_valid`` rows comes from one generator per round, so a later
  multi-device split of the rows leaves the draw unchanged.
* **k-means||** — ``rounds`` oversampling passes of Gumbel top-m, candidate
  weights from one assignment pass, a weighted D² reduction to k and a few
  weighted Lloyd steps on the candidates.

Noise comes from ``torch.Generator``s seeded from (seed, stream, index)
through numpy's ``SeedSequence``; it is not the JAX package's threefry
stream, so a cold init picks other rows than the reference on the same
seed (parity tests carry the reference's init across instead).  Reseed
draws use a CPU generator, so the CPU and the card reseed identically.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device, stat_dtype, torch_dtype
from .lloyd import lloyd_assign_reduce

__all__ = ["kmeans_full", "kmeans", "resolve_update", "resolve_init_method",
           "AUTO_INIT_KMEANS_PAR_MIN_K", "generator"]

#: "auto" init flips from d2 to kmeans|| at this k (the reference's rule).
AUTO_INIT_KMEANS_PAR_MIN_K = 256

# Generator streams: init rounds, the k-means|| candidate reduction, reseeds.
_INIT, _REDUCE, _RESEED = 0, 1, 2
#: Lloyd iterations whose reseed rows are drawn together: ``max_iter`` is
#: max(100, n // 100), 25,000 draws at 2.5M rows if all were made up front,
#: while the loop usually stops after tens of iterations.
_RESEED_BLOCK = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def generator(seed: int | None, stream: int, index: int, device) -> torch.Generator:
    """A fresh generator on ``device`` keyed by (seed, stream, index)."""
    words = [0 if seed is None else int(seed), int(stream), int(index)]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def _gumbel(seed, stream: int, index: int, n: int, device) -> torch.Tensor:
    """(n,) float64 Gumbel(0, 1) noise: -log of a unit exponential."""
    gen = generator(seed, stream, index, device)
    e = torch.empty(n, dtype=torch.float64, device=device).exponential_(generator=gen)
    return -torch.log(e)


def resolve_update(update: str, device: torch.device, dtype: torch.dtype) -> str:
    """"kernel" (the CUDA Lloyd kernel) or "matmul" (its plain version).

    "auto" picks the kernel on CUDA and the plain matmul path on the CPU.
    A CUDA tensor always runs the kernel, which takes f32 and bf16 points;
    other dtypes on CUDA raise.
    """
    if update not in ("auto", "kernel", "matmul"):
        raise ValueError(f"unknown update strategy {update!r}")
    if device.type == "cuda":
        if update == "matmul":
            raise ValueError("update='matmul' is the CPU reference path; CUDA "
                             "tensors run the Lloyd kernel")
        if dtype not in _KERNEL_DTYPES:
            raise TypeError(f"the Lloyd kernel takes float32 or bfloat16 points "
                            f"on CUDA, got {dtype}")
        return "kernel"
    return "matmul" if update == "auto" else update


def resolve_init_method(init_method: str, k: int) -> str:
    """"auto" -> "kmeans||" once k reaches ``AUTO_INIT_KMEANS_PAR_MIN_K``,
    "d2" below; explicit choices pass through."""
    if init_method not in ("auto", "d2", "kmeans||"):
        raise ValueError(f"unknown init_method {init_method!r}")
    if init_method != "auto":
        return init_method
    return "kmeans||" if int(k) >= AUTO_INIT_KMEANS_PAR_MIN_K else "d2"


def _sq_dist_to_row(x, x_sq, row):
    return torch.clamp(x_sq - 2.0 * (x @ row) + torch.dot(row, row), min=0.0)


def _d2_init(x: torch.Tensor, k: int, seed) -> torch.Tensor:
    """KMeans++ D² sampling over the valid rows ``x`` (stat dtype)."""
    n, d = x.shape
    x_sq = (x * x).sum(dim=1)

    def pick(i, logits):
        return x[torch.argmax(logits + _gumbel(seed, _INIT, i, n, x.device))]

    cent = x.new_empty((k, d))
    cent[0] = pick(0, torch.zeros_like(x_sq))
    min_sq = _sq_dist_to_row(x, x_sq, cent[0])
    for i in range(1, k):
        # p ∝ min_sq: logits log(min_sq), log(0) = -inf is probability 0;
        # all-zero residuals fall back to a uniform draw.
        logits = torch.where(min_sq.sum() > 0, torch.log(min_sq), 0.0)
        cent[i] = pick(i, logits)
        min_sq = torch.minimum(min_sq, _sq_dist_to_row(x, x_sq, cent[i]))
    return cent


def _weighted_kmeanspp(c, wts, seed, k):
    """Weighted D² reduction of the candidate set to k centroids;
    zero-weight candidates are never drawn."""
    n_cand, d = c.shape
    c_sq = (c * c).sum(dim=1)
    wlog = torch.where(wts > 0, torch.log(wts), -math.inf)

    def pick(i, logits):
        return c[torch.argmax(logits + _gumbel(seed, _REDUCE, i, n_cand, c.device))]

    cent = c.new_empty((k, d))
    cent[0] = pick(0, wlog)
    min_sq = _sq_dist_to_row(c, c_sq, cent[0])
    for i in range(1, k):
        total = (min_sq * wts).sum()
        logits = torch.where(total > 0,
                             wlog + torch.log(torch.clamp(min_sq, min=1e-38)), wlog)
        cent[i] = pick(i, logits)
        min_sq = torch.minimum(min_sq, _sq_dist_to_row(c, c_sq, cent[i]))
    return cent


def _weighted_lloyd_small(c, wts, cent, iters):
    """A few weighted Lloyd iterations on the candidate set."""
    k = cent.shape[0]
    for _ in range(iters):
        dist = (cent * cent).sum(dim=1)[None, :] - 2.0 * (c @ cent.T)
        onehot = torch.nn.functional.one_hot(torch.argmin(dist, dim=1), k).to(c.dtype)
        sums = onehot.T @ (c * wts[:, None])
        counts = onehot.T @ wts
        cent = torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return cent


def _kmeans_par_init(x, k, seed, rounds, per_round, cand_lloyd_iters=10):
    """k-means|| over the valid rows ``x`` (stat dtype): ``rounds`` passes,
    each taking the top ``per_round`` of log(D²) + Gumbel (sampling ∝ D²
    without replacement)."""
    n, d = x.shape
    x_sq = (x * x).sum(dim=1)
    cands = [x[torch.argmax(_gumbel(seed, _INIT, 0, n, x.device))][None, :]]
    min_sq = _sq_dist_to_row(x, x_sq, cands[0][0])
    for r in range(rounds):
        logits = torch.where(min_sq.sum() > 0,
                             torch.log(torch.clamp(min_sq, min=1e-38)), 0.0)
        idx = torch.topk(logits + _gumbel(seed, _INIT, r + 1, n, x.device),
                         per_round).indices
        rows = x[idx]
        cands.append(rows)
        d2new = torch.clamp(x_sq[:, None] - 2.0 * (x @ rows.T)
                            + (rows * rows).sum(dim=1)[None, :], min=0.0)
        min_sq = torch.minimum(min_sq, d2new.min(dim=1).values)
    cands = torch.cat(cands)
    # Candidate weights: how many points each owns (one Lloyd-step pass).
    _, _, wts = lloyd_assign_reduce(x, cands, n, with_labels=False)
    wts = wts.to(x.dtype)
    cent = _weighted_kmeanspp(cands, wts, seed, k)
    return _weighted_lloyd_small(cands, wts, cent, cand_lloyd_iters)


def _reseed_rows(seed, it_global: int, k: int, n_valid: int) -> torch.Tensor:
    gen = generator(seed, _RESEED, it_global, "cpu")
    return torch.randint(0, n_valid, (k,), generator=gen)


def _reseed_table(seed, iter_offset: int, iters: int, k: int, n_valid: int) -> torch.Tensor:
    """(iters, k) reseed rows of iterations ``iter_offset + it``, each the
    draw ``_reseed_rows`` makes for it (the draws share no state)."""
    if iters < 1:
        return torch.empty((0, k), dtype=torch.int64)
    return torch.stack([_reseed_rows(seed, iter_offset + it, k, n_valid)
                        for it in range(iters)])


def kmeans_full(
    X,
    k: int,
    tol: float = 1e-4,
    seed: int | None = None,
    max_iter: int = 100,
    init_centroids=None,
    dtype=None,
    n_valid: int | None = None,
    iter_offset: int = 0,
    init_method: str = "d2",
    init_oversample: float = 2.0,
    init_rounds: int = 5,
    device=None,
):
    """KMeans++ + Lloyd.  Returns (centroids (k, d), labels (n_valid,)
    int32, n_iter, shift).

    ``X`` is an (n, d) tensor (it stays on its device unless ``device`` is
    given) or an array (moved to ``device``: CUDA unless "cpu" is asked
    for).  Rows ``>= n_valid`` are padding: they are never sampled,
    counted or summed.  ``dtype`` is the points dtype (None keeps X's
    float dtype); centroids and statistics live in its stat dtype.
    """
    if torch.is_tensor(X):
        dev = X.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        X = torch.as_tensor(np.asarray(X))
    if dtype is None:
        dtype = X.dtype if X.is_floating_point() else torch.float32
    dtype = torch_dtype(dtype)
    acc = stat_dtype(dtype)
    xp = X.to(device=dev, dtype=dtype).contiguous()
    n, d = xp.shape
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} outside [0, {n}]")
    if k > n_valid:
        raise ValueError(f"k={k} exceeds number of valid samples {n_valid}")
    resolve_update("auto", dev, dtype)  # CUDA points the kernel does not take raise here

    if init_centroids is not None:
        if not torch.is_tensor(init_centroids):
            init_centroids = torch.from_numpy(np.array(init_centroids, dtype=np.float64))
        c = init_centroids.to(device=dev, dtype=acc)
        if tuple(c.shape) != (k, d):
            raise ValueError(f"init_centroids must be ({k}, {d}), got {tuple(c.shape)}")
    else:
        auto_init = init_method == "auto"
        method = resolve_init_method(init_method, k)
        xv = xp[:n_valid].to(acc)
        per_round = max(1, int(np.ceil(init_oversample * k / init_rounds)))
        if method == "kmeans||" and per_round > n_valid:
            if not auto_init:
                raise ValueError(
                    f"kmeans|| needs per-round sample {per_round} <= rows "
                    f"{n_valid}; use init_method='d2' at this scale")
            method = "d2"  # tiny inputs: the oversample does not fit, D² is cheap
        if method == "kmeans||":
            c = _kmeans_par_init(xv, k, seed, int(init_rounds), per_round)
        else:
            c = _d2_init(xv, k, seed)
        del xv

    # The reseed rows of a block of iterations are drawn when the loop
    # enters it and gathered on the device at once (from pinned memory, so
    # the copy does not wait for the card): an empty cluster is reseeded by
    # a device-side where, and the shift is the loop's only host read.
    c_prev, it, shift = c, 0, math.inf
    while it < max_iter and (tol <= 0 or it == 0 or shift >= tol):
        if it % _RESEED_BLOCK == 0:
            rows = _reseed_table(seed, iter_offset + it, min(_RESEED_BLOCK, max_iter - it),
                                 k, n_valid)
            if dev.type == "cuda":
                rows = rows.pin_memory()
            reseed = xp[rows.to(dev, non_blocking=True)].to(acc)
        _, sums, counts = lloyd_assign_reduce(xp, c, n_valid, with_labels=False)
        new_c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None],
                            reseed[it % _RESEED_BLOCK])
        shift_t = torch.sqrt(((new_c - c) ** 2).sum())
        if tol > 0:
            shift = float(shift_t)
        c_prev, c = c, new_c
        it += 1
    if tol <= 0 and it:
        shift = float(shift_t)
    labels, _, _ = lloyd_assign_reduce(xp, c_prev, n_valid, with_labels=True)
    return c, labels[:n_valid], it, shift


def kmeans(X, k: int, **kwargs):
    """Reference-shaped API: (centroids, labels)."""
    centroids, labels, _, _ = kmeans_full(X, k, **kwargs)
    return centroids, labels
