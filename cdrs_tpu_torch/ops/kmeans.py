"""KMeans++ / k-means|| init and the Lloyd loop on tensors: the port of
``cdrs_tpu/ops/kmeans_jax.py`` (``kmeans_jax_full`` / ``kmeans_jax``),
on one device or a mesh of shards.

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
* **k-means||** — ``rounds`` oversampling passes of Gumbel top-m (each
  pass's (rows x candidates) distances formed in row chunks of at most
  ``_PAR_BLOCK``), candidate weights from one assignment pass, a weighted
  D² reduction to k and a few weighted Lloyd steps on the candidates.

**Mesh** (``mesh_shape={"data": N, "model": M}``, ``parallel/mesh.py``):
rows split into N contiguous shards (zero-padded to a multiple of N, the
padding never counted), each shard running the kernels itself:

* D² init — each shard scores its rows against the same noise (drawn over
  all ``n_valid`` rows from one generator); the cross-shard argmax keeps
  the first maximum, the lowest shard winning, which is the global first
  index because shards are contiguous.  The ``total > 0`` predicate is a
  psum.  So a cold init equals the one-device init at any N.
* k-means|| — each shard's local top-m, gathered and merged into the
  global top-m by (value desc, global row asc); candidate weights from one
  Lloyd-kernel pass a shard and a psum.
* Lloyd — one kernel launch a shard an iteration with the shard-local
  valid count, then one shard-ordered psum of the (k, d + 1) statistics.
  Reseed rows are the one-device draws (global row indices), each row
  fetched from the shard that owns it.  Labels: one kernel pass a shard.
* model axis (M > 1) — each model shard holds k / M centroids; distances
  are a ``torch.matmul`` of (n_loc, k / M) a model shard (the reference
  computes them in XLA and refuses its fused kernel on a model-sharded
  mesh, so the Lloyd kernel does not launch here either); the global
  argmin is the min of the shard minima, then the lowest index among
  ties; sums from a one-hot matmul and counts from ``bincount`` a data
  shard, then the psum.

A 1 x 1 mesh is the one-device path.

**Telemetry** (``obs/``): with an active instrument each call counts
``kernel.calls.kmeans_full``, and with ``kmeans_trace`` on (and no model
axis, as in the reference) emits one ``kmeans_iter`` event per iteration
with its ``inertia`` and ``shift`` and the ``kmeans.iterations``
histogram.  The traced run keeps the Lloyd kernel (the reference swaps its
fused kernel for a matmul to see distances): an iteration's inertia against
the centroids it assigned to comes from the kernel's own (sums, counts) as
Σ‖x‖² − 2 Σ_j c_j·S_j + Σ_j n_j‖c_j‖² in float64, Σ‖x‖² taken once a call;
the values stay on the device until one fetch after the loop.  Tracing
changes no value of the run.

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
from ..obs import current as _obs_current
from ..obs.devtools import signature
from ..parallel.mesh import resolve_mesh, shard_valid
from .lloyd import centroid_operands, lloyd_assign_reduce, sharded_assign_reduce

__all__ = ["kmeans_full", "kmeans", "resolve_update", "resolve_init_method",
           "AUTO_INIT_KMEANS_PAR_MIN_K", "generator", "d2_init_mesh", "labels_mesh"]

#: "auto" init flips from d2 to kmeans|| at this k (the reference's rule).
AUTO_INIT_KMEANS_PAR_MIN_K = 256

# Generator streams: init rounds, the k-means|| candidate reduction, reseeds.
_INIT, _REDUCE, _RESEED = 0, 1, 2
#: Lloyd iterations whose reseed rows are drawn together: ``max_iter`` is
#: max(100, n // 100), 25,000 draws at 2.5M rows if all were made up front,
#: while the loop usually stops after tens of iterations.
_RESEED_BLOCK = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: Distances k-means|| forms at once (rows x a round's candidates): 2^27
#: float32, 512 MiB.  At 10M rows and k = 1024 a round's (n, 410) block
#: would take 16 GiB, three times over with its temporaries.
_PAR_BLOCK = 1 << 27


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


def _min_sq_dist(x, x_sq, rows):
    """(n,) squared distance of each row of ``x`` to its nearest of
    ``rows``, formed in row chunks of at most ``_PAR_BLOCK`` distances."""
    r_sq = (rows * rows).sum(dim=1)[None, :]
    step = max(1, _PAR_BLOCK // max(1, rows.shape[0]))
    return torch.cat([torch.clamp(x_sq[i:i + step, None] - 2.0 * (x[i:i + step] @ rows.T)
                                  + r_sq, min=0.0).min(dim=1).values
                      for i in range(0, x.shape[0], step)])


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
        min_sq = torch.minimum(min_sq, _min_sq_dist(x, x_sq, rows))
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


# -- the mesh -------------------------------------------------------------------


def _shard_views(mesh, shards, n_loc, n_valid):
    """(data shard, rows, valid rows) of each local shard."""
    return [(d, x, shard_valid(n_valid, n_loc, d)) for d, x in zip(mesh.local, shards)]


def _pick_sharded(mesh, views, n_loc, n_valid, seed, stream, index, logits):
    """The row of the global first argmax of ``logits + noise`` over the
    valid rows; ``logits`` holds each shard's (n_loc,) scores.  Each shard
    offers its first maximum; the lowest shard with the largest wins."""
    g = _gumbel(seed, stream, index, n_valid, mesh.home)
    vals, rows = [], []
    for (d, x, nv), lg in zip(views, logits):
        s = torch.full((x.shape[0],), -math.inf, dtype=torch.float64, device=x.device)
        if nv:
            s[:nv] = lg[:nv] + g[d * n_loc:d * n_loc + nv].to(x.device)
        j = torch.argmax(s)
        vals.append(s[j])
        rows.append(x[j])
    return mesh.all_gather(rows)[torch.argmax(mesh.all_gather(vals))]


def _positive_total(mesh, views, min_sq) -> torch.Tensor:
    """Whether any valid residual is positive (the one-device
    ``min_sq.sum() > 0``), as one psum."""
    return mesh.psum([m[:nv].sum() for (_, _, nv), m in zip(views, min_sq)]) > 0


def d2_init_mesh(mesh, shards, n_loc: int, n_valid: int, k: int, seed) -> torch.Tensor:
    """KMeans++ D² over the valid rows of the data shards ``shards`` (stat
    dtype): the one-device ``_d2_init``'s draws at any shard count."""
    views = _shard_views(mesh, shards, n_loc, n_valid)
    x_sq = [(x * x).sum(dim=1) for _, x, _ in views]
    cent = shards[0].new_empty((k, shards[0].shape[1]), device=mesh.home)
    cent[0] = _pick_sharded(mesh, views, n_loc, n_valid, seed, _INIT, 0,
                            [torch.zeros_like(q) for q in x_sq])
    min_sq = [_sq_dist_to_row(x, q, cent[0].to(x.device)) for (_, x, _), q in zip(views, x_sq)]
    for i in range(1, k):
        total = _positive_total(mesh, views, min_sq)
        logits = [torch.where(total.to(m.device), torch.log(m), 0.0) for m in min_sq]
        cent[i] = _pick_sharded(mesh, views, n_loc, n_valid, seed, _INIT, i, logits)
        min_sq = [torch.minimum(m, _sq_dist_to_row(x, q, cent[i].to(x.device)))
                  for m, (_, x, _), q in zip(min_sq, views, x_sq)]
    return cent


def _kmeans_par_init_mesh(mesh, shards, n_loc, n_valid, k, seed, rounds, per_round,
                          cand_lloyd_iters=10):
    """k-means|| over the data shards: local top-m a shard, merged into the
    global top-m by (value desc, global row asc), the one-device draws."""
    views = _shard_views(mesh, shards, n_loc, n_valid)
    x_sq = [(x * x).sum(dim=1) for _, x, _ in views]
    c0 = _pick_sharded(mesh, views, n_loc, n_valid, seed, _INIT, 0,
                       [torch.zeros_like(q) for q in x_sq])
    cands = [c0[None, :]]
    min_sq = [_sq_dist_to_row(x, q, c0.to(x.device)) for (_, x, _), q in zip(views, x_sq)]
    for r in range(rounds):
        total = _positive_total(mesh, views, min_sq)
        g = _gumbel(seed, _INIT, r + 1, n_valid, mesh.home)
        vals, rows, gidx = [], [], []
        for (d, x, nv), m in zip(views, min_sq):
            s = torch.full((x.shape[0],), -math.inf, dtype=torch.float64, device=x.device)
            if nv:
                lg = torch.where(total.to(x.device), torch.log(torch.clamp(m[:nv], min=1e-38)),
                                 0.0)
                s[:nv] = lg + g[d * n_loc:d * n_loc + nv].to(x.device)
            v, idx = torch.topk(s, per_round)
            vals.append(v)
            rows.append(x[idx])
            gidx.append(idx + d * n_loc)
        v = mesh.all_gather(vals).reshape(-1)
        rr = mesh.all_gather(rows).reshape(-1, shards[0].shape[1])
        gi = mesh.all_gather(gidx).reshape(-1)
        by_row = torch.argsort(gi, stable=True)
        order = by_row[torch.argsort(v[by_row], descending=True, stable=True)]
        new_rows = rr[order[:per_round]]
        cands.append(new_rows)
        nr = [new_rows.to(x.device) for _, x, _ in views]
        min_sq = [torch.minimum(m, _min_sq_dist(x, q, w))
                  for m, (_, x, _), q, w in zip(min_sq, views, x_sq, nr)]
    cands = torch.cat(cands)
    wts = sharded_assign_reduce(mesh, shards, n_loc, cands, n_valid)[2].to(cands.dtype)
    cent = _weighted_kmeanspp(cands, wts, seed, k)
    return _weighted_lloyd_small(cands, wts, cent, cand_lloyd_iters)


def _fetch_rows(mesh, shards, n_loc: int, rows: torch.Tensor) -> torch.Tensor:
    """Global rows ``rows`` (CPU int64), each from the shard that owns it,
    merged by a psum (the other shards add zeros)."""
    parts = []
    for d, x in zip(mesh.local, shards):
        rel = rows - d * n_loc
        owned = ((rel >= 0) & (rel < n_loc)).to(x.device)
        got = x[rel.clamp(0, n_loc - 1).to(x.device)]
        parts.append(torch.where(owned[:, None], got, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device)))
    return mesh.psum(parts)


def _step_model_axis(mesh, d: int, x: torch.Tensor, nv: int, c: torch.Tensor,
                     with_labels: bool):
    """One Lloyd step of data shard ``d`` on a model axis: labels (all rows)
    and (sums, counts) of its valid rows.  Model shard ``m`` holds
    centroids ``[m * k / M, (m + 1) * k / M)`` and scores them with one
    matmul; the argmin is the min of the shard minima, then the lowest
    index among ties."""
    k = c.shape[0]
    k_loc = k // mesh.n_model
    acc = stat_dtype(x.dtype)
    c_used, csq = centroid_operands(c, x.dtype)
    xf = x.to(acc)
    home = mesh.device(d, 0)
    mins, args = [], []
    for m in range(mesh.n_model):
        dev = mesh.device(d, m)
        sl = slice(m * k_loc, (m + 1) * k_loc)
        dist = csq[sl].to(dev)[None, :] - 2.0 * (xf.to(dev) @ c_used[sl].to(dev).T)
        j = torch.argmin(dist, dim=1)
        mins.append(torch.gather(dist, 1, j[:, None])[:, 0].to(home))
        args.append((j + m * k_loc).to(home))
    gmin = mins[0]
    for v in mins[1:]:
        gmin = torch.minimum(gmin, v)
    labels = torch.full_like(args[0], k)
    for v, j in zip(mins, args):
        labels = torch.minimum(labels, torch.where(v == gmin, j, k))
    lab_v = labels[:nv]
    onehot = torch.nn.functional.one_hot(lab_v, k).to(acc)
    sums = onehot.T @ xf[:nv]
    counts = torch.bincount(lab_v, minlength=k).to(acc)
    return (labels.to(torch.int32) if with_labels else None), sums, counts


def _mesh_step(mesh):
    """The per-shard step of ``sharded_assign_reduce`` on this mesh: the
    Lloyd kernel, or the matmul step on a model axis."""
    if mesh.n_model == 1:
        return None
    return lambda d, x, c, nv, wl: _step_model_axis(mesh, d, x, nv, c, wl)


def labels_mesh(mesh, shards, n_loc: int, c: torch.Tensor, n_valid: int) -> torch.Tensor:
    """(n_valid,) int32 labels against ``c``: one label pass a shard,
    gathered in shard order."""
    return sharded_assign_reduce(mesh, shards, n_loc, c, n_valid, with_labels=True,
                                 step=_mesh_step(mesh))[0]


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
    mesh_shape: dict[str, int] | None = None,
):
    """KMeans++ + Lloyd.  Returns (centroids (k, d), labels (n_valid,)
    int32, n_iter, shift).

    ``X`` is an (n, d) tensor (it stays on its device unless ``device`` is
    given) or an array (moved to ``device``: CUDA unless "cpu" is asked
    for).  Rows ``>= n_valid`` are padding: they are never sampled,
    counted or summed.  ``dtype`` is the points dtype (None keeps X's
    float dtype); centroids and statistics live in its stat dtype.
    ``mesh_shape`` (``{"data": N, "model": M}``) runs on a mesh of shards
    of ``X``'s device kind (module docstring); k must divide by M.
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
    mesh = resolve_mesh(mesh_shape, dev)
    if mesh is not None:
        if k % mesh.n_model:
            raise ValueError(f"k={k} must be divisible by the model axis size {mesh.n_model}")
        n_loc, shards = mesh.split(xp)

    if init_centroids is not None:
        if not torch.is_tensor(init_centroids):
            init_centroids = torch.from_numpy(np.array(init_centroids, dtype=np.float64))
        c = init_centroids.to(device=dev, dtype=acc)
        if tuple(c.shape) != (k, d):
            raise ValueError(f"init_centroids must be ({k}, {d}), got {tuple(c.shape)}")
    else:
        auto_init = init_method == "auto"
        method = resolve_init_method(init_method, k)
        per_round = max(1, int(np.ceil(init_oversample * k / init_rounds)))
        rows, what = (n_valid, "rows") if mesh is None else (n_loc, "shard rows")
        if method == "kmeans||" and per_round > rows:
            if not auto_init:
                raise ValueError(
                    f"kmeans|| needs per-round sample {per_round} <= {what} "
                    f"{rows}; use init_method='d2' at this scale")
            method = "d2"  # tiny inputs: the oversample does not fit, D² is cheap
        if mesh is not None:
            xs = [x.to(acc) for x in shards]
            if method == "kmeans||":
                c = _kmeans_par_init_mesh(mesh, xs, n_loc, n_valid, k, seed,
                                          int(init_rounds), per_round)
            else:
                c = d2_init_mesh(mesh, xs, n_loc, n_valid, k, seed)
            del xs
        else:
            xv = xp[:n_valid].to(acc)
            if method == "kmeans||":
                c = _kmeans_par_init(xv, k, seed, int(init_rounds), per_round)
            else:
                c = _d2_init(xv, k, seed)
            del xv
    if mesh is None:
        def step(c):
            return lloyd_assign_reduce(xp, c, n_valid, with_labels=False)[1:]

        def fetch(rows):
            # Gathered on the device at once, from pinned memory so the copy
            # does not wait for the card.
            if dev.type == "cuda":
                rows = rows.pin_memory()
            return xp[rows.to(dev, non_blocking=True)].to(acc)

        def label(c):
            return lloyd_assign_reduce(xp, c, n_valid, with_labels=True)[0][:n_valid]
    else:
        c = c.to(mesh.home)

        def step(c):
            return sharded_assign_reduce(mesh, shards, n_loc, c, n_valid,
                                         step=_mesh_step(mesh))[1:]

        def fetch(rows):
            got = _fetch_rows(mesh, shards, n_loc, rows.reshape(-1)).to(acc)
            return got.view(*rows.shape, d)

        def label(c):
            return labels_mesh(mesh, shards, n_loc, c, n_valid)
    tel = _obs_current()
    if tel is None:
        return _lloyd(step, fetch, label, c, n_valid, k, tol, seed, max_iter, iter_offset)[:4]
    x_sq = None
    if tel.kmeans_trace and (mesh is None or mesh.n_model == 1):
        x_sq = xp[:n_valid].to(torch.float64).square().sum()
    c, labels, it, shift, trace = _lloyd(step, fetch, label, c, n_valid, k, tol, seed,
                                         max_iter, iter_offset, x_sq)
    tel.record_kernel_call("kmeans_full", signature(
        xp, static=(n_valid, k, max_iter, float(tol), init_centroids is not None, init_method,
                    None if mesh is None else (mesh.n_data, mesh.n_model))))
    if trace is not None:
        tel.emit_kmeans_trace("kmeans_full", inertia=trace[0], shift=trace[1],
                              backend="torch", k=int(k), n=int(n_valid), update="lloyd")
    return c, labels, it, shift


def _lloyd(step, fetch, label, c, n_valid, k, tol, seed, max_iter, iter_offset, x_sq=None):
    """The Lloyd loop on one device or a mesh: ``step(c)`` gives the
    (sums, counts) of the valid rows, ``fetch(rows)`` the points of the
    (iters, k) global reseed rows, ``label(c)`` the (n_valid,) labels.
    Returns (centroids, labels, n_iter, shift, trace).

    The reseed rows of a block of iterations are drawn when the loop
    enters it and fetched at once: an empty cluster is reseeded by a
    device-side where, and the shift is the loop's only host read.  Given
    ``x_sq`` (Σ‖x‖² over the valid rows, float64), ``trace`` is the
    (inertia, shift) per iteration as float64 arrays; the loop only keeps
    each iteration's (centroids, sums, counts, shift) tensors, and the
    inertias come from them in one batched pass after it, fetched once.
    Otherwise ``trace`` is None."""
    c_prev, it, shift = c, 0, math.inf
    kept = []
    while it < max_iter and (tol <= 0 or it == 0 or shift >= tol):
        if it % _RESEED_BLOCK == 0:
            reseed = fetch(_reseed_table(seed, iter_offset + it,
                                         min(_RESEED_BLOCK, max_iter - it), k, n_valid))
        sums, counts = step(c)
        new_c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None],
                            reseed[it % _RESEED_BLOCK])
        shift_t = torch.sqrt(((new_c - c) ** 2).sum())
        if x_sq is not None:
            kept.append((c, sums, counts, shift_t))
        if tol > 0:
            shift = float(shift_t)
        c_prev, c = c, new_c
        it += 1
    if tol <= 0 and it:
        shift = float(shift_t)
    trace = None
    if x_sq is not None:
        trace = _inertia_trace(x_sq, kept) if kept else (np.zeros(0), np.zeros(0))
    return c, label(c_prev), it, shift, trace


def _inertia_trace(x_sq, kept):
    """(inertia, shift) per iteration as float64 arrays from the kept
    (centroids, sums, counts, shift) of each: Σ‖x‖² − 2 Σ_j c_j·S_j +
    Σ_j n_j‖c_j‖², clamped at 0, in float64."""
    cs, sums, counts, shifts = (torch.stack(t).to(torch.float64) for t in zip(*kept))
    inertia = torch.clamp(x_sq - 2.0 * (sums * cs).sum((1, 2))
                          + (counts * (cs * cs).sum(2)).sum(1), min=0.0)
    out = torch.stack([inertia, shifts]).cpu().numpy()
    return out[0], out[1]


def kmeans(X, k: int, **kwargs):
    """Reference-shaped API: (centroids, labels)."""
    centroids, labels, _, _ = kmeans_full(X, k, **kwargs)
    return centroids, labels
