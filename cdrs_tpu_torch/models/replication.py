"""ReplicationPolicyModel: KMeans++ clustering, per-cluster median scoring,
one category per cluster — the port of ``cdrs_tpu/models/replication.py``.

The model is an ``nn.Module`` whose buffers are its state: the centroids
of the last fit and the scoring tables (W, D, rf, is_moderate, band,
global_medians; ``ops/scoring.scoring_tables``), so ``state_dict`` /
``load_state_dict`` carry a decision policy between processes and
``convert.params_from_reference`` builds one from the JAX package's state.
``mesh_shape`` (``{"data": N, "model": M}``) runs clustering and the
median stage on a mesh of shards (``parallel/mesh.py``); it is a runtime
choice, not state.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import (CATEGORIES, KMeansConfig, MetricsLog, ScoringConfig,
                      validate_replication_factors)
from ..ops.kmeans import kmeans_full
from ..ops.kmeans_stream import MiniBatchKMeans, MiniBatchState
from ..ops.scoring import classify, scoring_tables

__all__ = ["ClusterDecision", "ReplicationPolicyModel", "centroid_id"]


def centroid_id(centroid: np.ndarray) -> str:
    """String centroid ID, 4 decimals per component."""
    return "CENTROID_" + "_".join(f"{float(v):.4f}" for v in centroid)


@dataclass
class ClusterDecision:
    """Output of one pipeline run (host arrays)."""

    centroids: np.ndarray         # (k, d)
    labels: np.ndarray            # (n,) cluster index per file
    category_idx: np.ndarray      # (k,) index into CATEGORIES
    scores: np.ndarray            # (k, n_categories)
    cluster_medians: np.ndarray   # (k, d)
    feature_names: tuple[str, ...]

    @property
    def categories(self) -> list[str]:
        return [CATEGORIES[int(i)] for i in self.category_idx]

    def replication_factor_per_file(self, cfg: ScoringConfig) -> np.ndarray:
        rf = np.asarray(cfg.rf_vector())
        return rf[self.category_idx[self.labels]]

    def write_csv(self, path: str) -> None:
        """``final_categories.csv``: centroid_id, category, then the feature
        columns."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["centroid_id", "category", *self.feature_names])
            for j in range(self.centroids.shape[0]):
                w.writerow([
                    centroid_id(self.centroids[j]),
                    CATEGORIES[int(self.category_idx[j])],
                    *[repr(float(v)) for v in self.centroids[j]],
                ])

    def write_assignments_csv(self, path: str, paths: list[str]) -> None:
        """Per-file table: path, cluster, category."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "cluster", "category"])
            for i, p in enumerate(paths):
                c = int(self.labels[i])
                w.writerow([p, c, CATEGORIES[int(self.category_idx[c])]])


class ReplicationPolicyModel(nn.Module):
    """KMeans++ clustering + directional-deviation scoring."""

    def __init__(self, kmeans_cfg: KMeansConfig | None = None,
                 scoring_cfg: ScoringConfig | None = None,
                 mesh_shape: dict[str, int] | None = None):
        super().__init__()
        self.mesh_shape = mesh_shape
        self.kmeans_cfg = kmeans_cfg or KMeansConfig()
        self.scoring_cfg = scoring_cfg or ScoringConfig()
        validate_replication_factors(self.scoring_cfg)
        d = len(self.scoring_cfg.features)
        self.register_buffer(
            "centroids", torch.zeros(self.kmeans_cfg.k, d, dtype=torch.float64))
        for name, value in scoring_tables(self.scoring_cfg).items():
            self.register_buffer(name, value)
        self.n_iter = 0

    def tables(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name)
                for name in ("W", "D", "rf", "is_moderate", "band", "global_medians")}

    def cluster(self, X: torch.Tensor, init_centroids=None):
        """(centroids, labels) of a KMeans++ fit on ``X`` (mini-batch when
        ``batch_size`` is set); the centroids become the model's
        ``centroids`` buffer.  ``n_iter`` counts Lloyd iterations, or
        mini-batch updates."""
        cfg = self.kmeans_cfg
        n = X.shape[0]
        if n < cfg.k:
            raise ValueError(f"{n} samples found, but K={cfg.k} requested; cannot cluster")
        if cfg.batch_size is not None:
            centroids, labels = self._cluster_minibatch(X, init_centroids)
        else:
            centroids, labels, self.n_iter, _ = kmeans_full(
                X, cfg.k, tol=cfg.tol, seed=cfg.seed, max_iter=cfg.resolve_max_iter(n),
                init_centroids=init_centroids, init_method=cfg.init_method,
                dtype=cfg.dtype, mesh_shape=self.mesh_shape)
        self.centroids = centroids
        return centroids, labels

    def _cluster_minibatch(self, X: torch.Tensor, init_centroids=None):
        """Mini-batch KMeans over ``batch_epochs`` shuffled passes of
        ``batch_size`` rows, then a predict pass in chunks of
        ``batch_size``.  The shuffles are ``np.random.default_rng(seed)``
        permutations, the JAX package's, so both see the same batches;
        batches are gathered on ``X``'s device.  Always float32."""
        cfg = self.kmeans_cfg
        n = X.shape[0]
        bs = int(cfg.batch_size)
        if bs < 1:
            raise ValueError(f"batch_size must be >= 1, got {bs}")
        if cfg.dtype not in (None, "float32"):
            raise ValueError(f"dtype {cfg.dtype!r} is a full-batch Lloyd knob; mini-batch "
                             f"KMeans (batch_size) always runs float32")
        if bs < cfg.k and init_centroids is None:
            raise ValueError(
                f"batch_size={bs} must be >= k={cfg.k} (the first mini-batch seeds the "
                f"centroid init; pass init_centroids to warm-start with smaller batches)")
        mb = MiniBatchKMeans(k=cfg.k, seed=cfg.seed, device=X.device,
                             mesh_shape=self.mesh_shape)
        if init_centroids is not None:
            if not torch.is_tensor(init_centroids):
                init_centroids = torch.from_numpy(np.asarray(init_centroids, np.float64))
            mb.state = MiniBatchState(
                centroids=init_centroids.to(device=X.device, dtype=torch.float32),
                counts=torch.zeros(cfg.k, dtype=torch.int32, device=X.device))
        rng = np.random.default_rng(cfg.seed)
        self.n_iter = 0
        for _ in range(max(1, int(cfg.batch_epochs))):
            order = torch.from_numpy(rng.permutation(n)).to(X.device)
            for lo in range(0, n, bs):
                mb.partial_fit(X[order[lo:lo + bs]])
                self.n_iter += 1
        labels = torch.empty(n, dtype=torch.int32, device=X.device)
        for lo in range(0, n, bs):
            labels[lo:lo + bs] = mb.predict(X[lo:lo + bs])
        return mb.centroids, labels

    def score(self, X: torch.Tensor, labels: torch.Tensor):
        """(category_idx (k,), scores (k, C), cluster_medians (k, d))."""
        return classify(X, labels, self.kmeans_cfg.k, self.scoring_cfg,
                        tables=self.tables(), mesh_shape=self.mesh_shape)

    def run(self, X: torch.Tensor, feature_names: tuple[str, ...] | None = None,
            init_centroids=None, metrics: MetricsLog | None = None) -> ClusterDecision:
        """Cluster then score ``X`` on its device; only the k-sized tables
        and the labels come back to the host.  ``metrics`` gets the
        "kmeans" and "score" stage times."""
        metrics = metrics or MetricsLog()
        with metrics.timer("kmeans", X.device):
            centroids, labels = self.cluster(X, init_centroids=init_centroids)
        metrics.record("kmeans.n_iter", self.n_iter)
        with metrics.timer("score", X.device):
            winner, scores, medians = self.score(X, labels)
        return ClusterDecision(
            centroids=centroids.cpu().numpy(),
            labels=labels.cpu().numpy(),
            category_idx=winner.cpu().numpy(),
            scores=scores.cpu().numpy(),
            cluster_medians=medians.cpu().numpy(),
            feature_names=tuple(feature_names or self.scoring_cfg.features),
        )
