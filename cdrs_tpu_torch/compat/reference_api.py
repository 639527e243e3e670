"""Drop-in reference API: the port of ``cdrs_tpu/compat/reference_api.py``.

Users of the reference import ``kmeans`` from ``kmeans_plusplus`` and
``ClusterClassifier`` from ``scoring``; the same signatures here run on the
port, so such a user switches with an import change:

    from cdrs_tpu_torch.compat.reference_api import kmeans, ClusterClassifier

``kmeans`` runs ``ops/kmeans.kmeans_full`` (the Lloyd kernel on the card)
on float32 points; ``ClusterClassifier`` scores medians with
``ops/scoring``.  Both take a keyword ``device`` (CUDA unless "cpu" is
asked for).  As in the JAX package, there is no crash past 10,000 rows,
empty clusters reseed from ``random_state``, and importing runs no demo.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScoringConfig, default_max_iter
from ..device import resolve_device
from ..ops.kmeans import kmeans_full
from ..ops.scoring import pick_winner, score_table, scoring_tables

__all__ = ["kmeans", "ClusterClassifier"]


def kmeans(X, k: int, number_of_files: int | None = None, tol: float = 1e-4,
           random_state: int | None = None, max_iter: int | None = None,
           init_centroids=None, *, device=None) -> tuple[np.ndarray, np.ndarray]:
    """KMeans++ + Lloyd with the reference's signature; returns host
    ``(centroids (k, d), labels (n,))``.  ``max_iter`` defaults to
    ``max(100, number_of_files // 100)``."""
    X = np.asarray(X)
    n = X.shape[0]
    if max_iter is None:
        max_iter = default_max_iter(n if number_of_files is None else number_of_files)
    centroids, labels, _, _ = kmeans_full(
        X, k, tol=tol, seed=random_state, max_iter=max_iter, init_centroids=init_centroids,
        dtype="float32", device=device)
    return centroids.cpu().numpy(), labels.cpu().numpy().astype(np.int64)


class ClusterClassifier:
    """Dict-in/dict-out classifier with the reference's methods
    (src/scoring.py:13-130)."""

    def __init__(self, global_medians, weights, directions, replication_factors, *,
                 device=None):
        self.global_medians = dict(global_medians)
        self.weights = {c: dict(w) for c, w in weights.items()}
        self.directions = {c: dict(d) for c, d in directions.items()}
        self.replication_factors = dict(replication_factors)
        self.features = tuple(global_medians.keys())
        self.categories = tuple(weights.keys())
        self.device = resolve_device(device)

    def _config(self) -> ScoringConfig:
        return ScoringConfig(features=self.features, global_medians=self.global_medians,
                             weights=self.weights, directions=self.directions,
                             replication_factors=self.replication_factors,
                             categories=self.categories)

    def f(self, x):
        return x ** 2

    def compute_cluster_medians(self, clusters):
        return {name: {p: float(np.median(v)) for p, v in feats.items()}
                for name, feats in clusters.items()}

    def score_category(self, cluster_medians, category):
        """One category's score, scalar as in the reference."""
        score = 0.0
        for p, m in cluster_medians.items():
            delta = m - self.global_medians[p]
            d = self.directions[category][p]
            if category == "Moderate":
                if abs(delta) < 0.1:
                    score += self.weights[category][p] * self.f(1 - abs(delta))
            elif d == 0 or np.sign(delta) == d:
                score += self.weights[category][p] * self.f(abs(delta))
        return score

    def classify_cluster(self, cluster_medians):
        tables = {name: t.to(self.device) for name, t in scoring_tables(self._config()).items()}
        medians = torch.tensor([[cluster_medians[f] for f in self.features]],
                               dtype=torch.float64, device=self.device)
        scores = score_table(medians, tables["global_medians"], tables["W"], tables["D"],
                             tables["is_moderate"], tables["band"])
        return self.categories[int(pick_winner(scores, tables["rf"])[0])]

    def classify(self, clusters):
        medians = self.compute_cluster_medians(clusters)
        return {name: self.classify_cluster(m) for name, m in medians.items()}
