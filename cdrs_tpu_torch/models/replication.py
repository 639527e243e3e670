"""ReplicationPolicyModel: KMeans++ clustering, per-cluster median scoring,
one category per cluster — the port of ``cdrs_tpu/models/replication.py``.

The model is an ``nn.Module`` whose buffers are its state: the centroids
of the last fit and the scoring tables (W, D, rf, is_moderate, band,
global_medians; ``ops/scoring.scoring_tables``), so ``state_dict`` /
``load_state_dict`` carry a decision policy between processes and
``convert.params_from_reference`` builds one from the JAX package's state.
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
                 scoring_cfg: ScoringConfig | None = None):
        super().__init__()
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
        """(centroids, labels) of a KMeans++ fit on ``X``; the centroids
        become the model's ``centroids`` buffer."""
        cfg = self.kmeans_cfg
        n = X.shape[0]
        if n < cfg.k:
            raise ValueError(f"{n} samples found, but K={cfg.k} requested; cannot cluster")
        centroids, labels, self.n_iter, _ = kmeans_full(
            X, cfg.k, tol=cfg.tol, seed=cfg.seed, max_iter=cfg.resolve_max_iter(n),
            init_centroids=init_centroids, init_method=cfg.init_method,
            dtype=cfg.dtype)
        self.centroids = centroids
        return centroids, labels

    def score(self, X: torch.Tensor, labels: torch.Tensor):
        """(category_idx (k,), scores (k, C), cluster_medians (k, d))."""
        return classify(X, labels, self.kmeans_cfg.k, self.scoring_cfg,
                        tables=self.tables())

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
