"""End-to-end pipeline: generator -> simulator -> features -> cluster ->
scoring (-> evaluate), the port of ``cdrs_tpu/pipeline.py``
(``backend="jax"``).

The generator and simulator run on the host (numpy); features, KMeans and
scoring run on ``cfg.device`` (CUDA unless "cpu" is asked for), handing the
feature table to clustering without a host round trip.  With ``outdir``
the five stage files are written as the JAX package writes them.
``cfg.mesh_shape`` runs features, clustering and scoring on a mesh.  With
``cfg.evaluate`` the decided rf is placed and replayed against uniform
baselines on the host (``PipelineResult.evaluation``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .config import CATEGORIES, PLANTED_TO_CATEGORY, MetricsLog, PipelineConfig
from .device import deterministic, resolve_device
from .features.batch import compute_features_torch
from .features.table import FeatureTable
from .models.replication import ClusterDecision, ReplicationPolicyModel
from .sim.access import simulate_access
from .sim.generator import generate_population

__all__ = ["PipelineResult", "run_pipeline", "recovery_accuracy"]


@dataclass
class PipelineResult:
    decision: ClusterDecision
    metrics: MetricsLog
    n_files: int
    n_events: int
    planted_accuracy: float | None
    device: str
    table: FeatureTable
    evaluation: dict | None = None

    def summary(self) -> dict:
        out = {
            "n_files": self.n_files,
            "n_events": self.n_events,
            "device": self.device,
            "categories": {f"C{j}": c for j, c in enumerate(self.decision.categories)},
            "planted_accuracy": self.planted_accuracy,
            **self.metrics.records,
        }
        if self.evaluation is not None:
            out["evaluation"] = self.evaluation
        return out


def recovery_accuracy(decision: ClusterDecision, planted: list[str]) -> float | None:
    """Fraction of files whose recovered category matches the planted one;
    None when the manifest plants categories outside the canonical four."""
    names, codes = np.unique(np.asarray(planted), return_inverse=True)
    if any(c not in PLANTED_TO_CATEGORY for c in names):
        return None
    index = np.asarray([CATEGORIES.index(PLANTED_TO_CATEGORY[c]) for c in names])
    predicted = np.asarray(decision.category_idx)[np.asarray(decision.labels)]
    return float((predicted == index[codes]).mean())


def run_pipeline(cfg: PipelineConfig, outdir: str | None = None,
                 init_centroids=None) -> PipelineResult:
    """One batch run.  ``init_centroids`` (k, d) replaces the KMeans init."""
    dev = resolve_device(cfg.device)
    metrics = MetricsLog()
    with deterministic():
        with metrics.timer("gen"):
            manifest = generate_population(cfg.generator)
        with metrics.timer("simulate"):
            events = simulate_access(manifest, cfg.simulator)
        metrics.record("n_events", len(events))
        with metrics.timer("features", dev):
            table = compute_features_torch(manifest, events, device=dev, dtype=cfg.dtype,
                                           mesh_shape=cfg.mesh_shape)
        model = ReplicationPolicyModel(kmeans_cfg=cfg.kmeans, scoring_cfg=cfg.scoring,
                                       mesh_shape=cfg.mesh_shape)
        with metrics.timer("cluster", dev):
            decision = model.run(table.norm, init_centroids=init_centroids,
                                 metrics=metrics)

    with metrics.timer("accuracy"):
        accuracy = recovery_accuracy(decision, manifest.category)
    metrics.record("planted_accuracy", accuracy)

    evaluation = None
    if cfg.evaluate:
        from .cluster.evaluate import compare_policies
        from .cluster.placement import ClusterTopology

        with metrics.timer("evaluate"):
            rf = decision.replication_factor_per_file(cfg.scoring)
            evaluation = compare_policies(manifest, events, rf,
                                          topology=ClusterTopology(nodes=tuple(manifest.nodes)))

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with metrics.timer("io"):
            manifest.write_csv(os.path.join(outdir, "metadata.csv"))
            events.write_csv(os.path.join(outdir, "access.log"), manifest)
            table.write_csv(os.path.join(outdir, "part-00000-features.csv"))
            decision.write_csv(os.path.join(outdir, "final_categories.csv"))
            decision.write_assignments_csv(
                os.path.join(outdir, "assignments.csv"), table.paths)

    return PipelineResult(
        decision=decision, metrics=metrics, n_files=len(manifest),
        n_events=len(events), planted_accuracy=accuracy, device=str(dev),
        table=table, evaluation=evaluation)
