"""Windowed drift detection against the last accepted model: the port of
``cdrs_tpu/control/drift.py``.

Two quantities of the feature snapshot ``X`` against the accepted model
(centroids, the category of each centroid, and the category fractions
recorded at acceptance):

* **centroid shift** — one Lloyd step from the accepted centroids (assign,
  per-cluster means; an empty cluster does not move) and the RMS L2 norm
  of the movement;
* **population delta** — total-variation distance between the current
  category fractions under the accepted mapping and the recorded ones.

``score = max(centroid_shift, population_delta)``.  Two versions:

* :func:`detect_drift` — numpy on the host in float64, the oracle, with its
  own copy of the JAX package's tiled ``assign_labels``;
* :func:`detect_drift_torch` — the counterpart of ``detect_drift_jax`` on
  one device: one launch of the fused Lloyd step without labels
  (``ops/lloyd.lloyd_assign_reduce``, the kernel that replaces the TPU's
  row-major ``lloyd_assign_reduce_pallas``), then k-sized tensor work.
  The category fractions come from the per-cluster counts, which are
  exact integers, so they equal the oracle's whenever the labels agree.
  Float32 points and sums, as the JAX version.  ``mesh_shape`` shards
  the rows: one launch a shard and one shard-ordered psum of the (k, d + 1)
  statistics (``detect_drift_jax(mesh_shape=)``; only the data axis).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.lloyd import lloyd_assign_reduce, rowmajor, sharded_assign_reduce
from ..parallel.mesh import data_mesh

__all__ = ["DriftReport", "assign_labels", "detect_drift", "detect_drift_torch"]

_TILE = 65536


@dataclass(frozen=True)
class DriftReport:
    score: float             # max(centroid_shift, population_delta)
    centroid_shift: float    # RMS L2 centroid movement of one Lloyd step
    population_delta: float  # total-variation distance of category fractions
    fractions: np.ndarray    # (n_categories,) current category fractions


def assign_labels(X: np.ndarray, centroids: np.ndarray, tile: int = _TILE) -> np.ndarray:
    """Nearest-centroid labels (first minimum of ``|c|^2 - 2 x.c``), tile
    by tile so the (n, k) distance block never exists whole."""
    n = X.shape[0]
    labels = np.empty(n, dtype=np.int64)
    c_sq = np.einsum("kd,kd->k", centroids, centroids)
    for start in range(0, n, tile):
        d = c_sq[None, :] - 2.0 * (X[start:start + tile] @ centroids.T)
        labels[start:start + tile] = np.argmin(d, axis=1)
    return labels


def _report(shift: float, frac: np.ndarray, accepted_fractions) -> DriftReport:
    pop_delta = float(0.5 * np.abs(frac - np.asarray(accepted_fractions)).sum())
    return DriftReport(score=max(shift, pop_delta), centroid_shift=shift,
                       population_delta=pop_delta, fractions=frac)


def detect_drift(X: np.ndarray, centroids: np.ndarray, category_idx: np.ndarray,
                 accepted_fractions: np.ndarray, n_categories: int) -> DriftReport:
    """Drift of the feature snapshot ``X`` against the accepted model (host
    oracle, float64)."""
    X = np.asarray(X, dtype=np.float64)
    c = np.asarray(centroids, dtype=np.float64)
    k = c.shape[0]
    labels = assign_labels(X, c)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.stack([np.bincount(labels, weights=X[:, j], minlength=k)
                     for j in range(X.shape[1])], axis=1)
    means = np.where((counts > 0)[:, None], sums / np.maximum(counts, 1.0)[:, None], c)
    shift = float(np.sqrt((((means - c) ** 2).sum(axis=1)).mean()))
    frac = np.bincount(np.asarray(category_idx)[labels],
                       minlength=n_categories).astype(np.float64)
    frac /= max(len(labels), 1)
    return _report(shift, frac, accepted_fractions)


def detect_drift_torch(X, centroids, category_idx, accepted_fractions,
                       n_categories: int, device=None, mesh_shape=None) -> DriftReport:
    """:func:`detect_drift` on one device with one fused Lloyd launch, or
    on a mesh with one launch a data shard.

    ``X`` is an (n, d) tensor (it stays on its device unless ``device`` is
    given) or an array (moved to ``device``: CUDA unless "cpu")."""
    if torch.is_tensor(X) and device is None:
        dev = X.device
    else:
        dev = resolve_device(device)
        X = X if torch.is_tensor(X) else torch.from_numpy(np.asarray(X))
    x = X.to(device=dev, dtype=torch.float32).contiguous()
    c = torch.as_tensor(np.asarray(centroids, dtype=np.float32), device=dev)
    n = x.shape[0]
    mesh = data_mesh(mesh_shape, dev)
    with rowmajor():
        if mesh is None:
            _, sums, counts = lloyd_assign_reduce(x, c, n, with_labels=False)
        else:
            n_loc, shards = mesh.split(x)
            _, sums, counts = sharded_assign_reduce(mesh, shards, n_loc, c, n)
    means = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], c)
    shift = float(torch.sqrt(((means - c) ** 2).sum(dim=1).mean()))
    # Category fractions from the exact integer counts: a (k, C) one-hot
    # product in float64, exact for any n below 2^53.
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(category_idx, dtype=np.int64), device=dev),
        int(n_categories)).to(torch.float64)
    frac = (counts.to(torch.float64) @ onehot).cpu().numpy() / max(n, 1)
    return _report(shift, frac, accepted_fractions)
