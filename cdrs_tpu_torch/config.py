"""Configuration of the PyTorch port: the slice of ``cdrs_tpu.config`` that the
batch pipeline needs, copied so the port never imports the JAX package.

Defaults, validation and field meanings match the JAX package's
(``cdrs_tpu/config.py``); the difference is the one the port's scope
forces: ``PipelineConfig`` names a torch ``device`` and the feature
``dtype`` in place of ``backend``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Mapping

__all__ = [
    "CATEGORIES", "CLUSTERING_FEATURES", "RAW_FEATURES", "PLANTED_TO_CATEGORY",
    "SEEDED_EPOCH", "ScoringConfig", "validated_scoring_config",
    "scoring_config_from_dict", "load_scoring_config",
    "validate_replication_factors", "KMeansConfig", "GeneratorConfig",
    "SimulatorConfig", "PipelineConfig", "default_max_iter", "MetricsLog",
]

#: Category order is load-bearing: scoring iterates in this order and the
#: replication-factor tie-break depends on it.
CATEGORIES: tuple[str, ...] = ("Hot", "Shared", "Moderate", "Archival")

CLUSTERING_FEATURES: tuple[str, ...] = (
    "access_freq_norm",
    "age_norm",
    "write_ratio_norm",
    "locality_norm",
    "concurrency_norm",
)

RAW_FEATURES: tuple[str, ...] = (
    "access_freq",
    "age_seconds",
    "write_ratio",
    "locality",
    "concurrency",
)

#: Ground-truth categories planted by the generator mapped to scoring names.
PLANTED_TO_CATEGORY: Mapping[str, str] = {
    "hot": "Hot",
    "shared": "Shared",
    "moderate": "Moderate",
    "archival": "Archival",
}

#: Wall-clock anchor of seeded workloads, so a seed fully determines the
#: generated timestamps (and with them the 1-second concurrency buckets).
SEEDED_EPOCH: float = 1_700_000_000.0


def default_max_iter(n: int) -> int:
    """Lloyd iteration cap ``max(100, n // 100)``."""
    return max(100, int(n) // 100)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _default_global_medians() -> dict[str, float]:
    return {f: 0.5 for f in CLUSTERING_FEATURES}


def _default_weights() -> dict[str, dict[str, float]]:
    return {
        "Hot": {"access_freq_norm": 1.0, "age_norm": 0.8, "write_ratio_norm": 0.5,
                "locality_norm": 0.5, "concurrency_norm": 1.0},
        "Shared": {"access_freq_norm": 0.7, "age_norm": 0.2, "write_ratio_norm": 1.0,
                   "locality_norm": 0.2, "concurrency_norm": 0.5},
        "Moderate": {"access_freq_norm": 0.5, "age_norm": 0.5, "write_ratio_norm": 0.5,
                     "locality_norm": 0.5, "concurrency_norm": 0.5},
        "Archival": {"access_freq_norm": 0.1, "age_norm": 1.0, "write_ratio_norm": 0.1,
                     "locality_norm": 0.5, "concurrency_norm": 0.1},
    }


def _default_directions() -> dict[str, dict[str, int]]:
    return {
        "Hot": {"access_freq_norm": +1, "age_norm": -1, "write_ratio_norm": +1,
                "locality_norm": +1, "concurrency_norm": +1},
        "Shared": {"access_freq_norm": +1, "age_norm": +1, "write_ratio_norm": +1,
                   "locality_norm": +1, "concurrency_norm": +1},
        "Moderate": {"access_freq_norm": 0, "age_norm": 0, "write_ratio_norm": 0,
                     "locality_norm": 0, "concurrency_norm": 0},
        "Archival": {"access_freq_norm": -1, "age_norm": +1, "write_ratio_norm": -1,
                     "locality_norm": -1, "concurrency_norm": -1},
    }


def _default_replication_factors() -> dict[str, int]:
    # Archival's rf=4 makes it the winner of all-zero-score ties.
    return {"Hot": 3, "Shared": 2, "Moderate": 1, "Archival": 4}


@dataclass
class ScoringConfig:
    """Weighted directional-deviation scoring rules."""

    features: tuple[str, ...] = CLUSTERING_FEATURES
    global_medians: dict[str, float] = field(default_factory=_default_global_medians)
    weights: dict[str, dict[str, float]] = field(default_factory=_default_weights)
    directions: dict[str, dict[str, int]] = field(default_factory=_default_directions)
    replication_factors: dict[str, int] = field(
        default_factory=_default_replication_factors)
    #: Moderate's "minimal deviation" band.
    moderate_band: float = 0.1
    #: Replace ``global_medians`` with medians computed from the data.
    compute_global_medians_from_data: bool = False
    #: Per-cluster median strategy: "sort" (exact), "hist" (fixed-bin
    #: histogram), "bisect" (rank bisection on the counting kernel), or
    #: "auto" (ops/scoring.resolve_median_method).
    median_method: str = "auto"
    #: Histogram resolution of "hist"; also sets bisection's iteration count.
    median_bins: int = 2048

    categories: tuple[str, ...] = CATEGORIES

    def weight_matrix(self):
        return [[self.weights[c][f] for f in self.features] for c in self.categories]

    def direction_matrix(self):
        return [[self.directions[c][f] for f in self.features] for c in self.categories]

    def rf_vector(self):
        return [self.replication_factors[c] for c in self.categories]


def validated_scoring_config() -> ScoringConfig:
    """Scoring tables validated against the simulator's workload: directions
    follow its rate profiles, age carries no planted signal (weight 0), and
    Moderate's weights and band shrink so directional evidence can outvote
    the in-band reward.  Medians come from the data."""
    features = CLUSTERING_FEATURES
    weights = {
        "Hot": (1.0, 0.0, 0.5, 0.3, 1.0),
        "Shared": (1.0, 0.0, 0.5, 2.5, 0.5),
        "Moderate": (0.15, 0.15, 0.15, 0.15, 0.15),
        "Archival": (2.0, 0.0, 0.5, 1.5, 1.0),
    }
    directions = {
        "Hot": (+1, 0, +1, +1, +1),
        "Shared": (+1, 0, -1, -1, +1),
        "Moderate": (0, 0, 0, 0, 0),
        "Archival": (-1, 0, -1, +1, -1),
    }
    return ScoringConfig(
        weights={c: dict(zip(features, w)) for c, w in weights.items()},
        directions={c: dict(zip(features, d)) for c, d in directions.items()},
        moderate_band=0.05,
        compute_global_medians_from_data=True,
    )


def validate_replication_factors(scoring_cfg: ScoringConfig) -> None:
    """Reject ``rf < 1`` for any category, naming the category."""
    for c in scoring_cfg.categories:
        rf = scoring_cfg.replication_factors.get(c)
        if rf is not None and int(rf) < 1:
            raise ValueError(
                f"replication factor for category {c!r} must be >= 1, "
                f"got {rf} (0 replicas means the file does not exist; "
                f"use an ec/tier strategy for cheap cold storage "
                f"instead)")


def scoring_config_from_dict(d: Mapping) -> ScoringConfig:
    """Build a ScoringConfig from a plain dict (e.g. parsed JSON).

    Unknown keys, unknown median methods, missing table entries and
    ``rf < 1`` are rejected here, before any tensor work starts.
    """
    allowed = {f.name for f in dataclasses.fields(ScoringConfig)}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown scoring config keys: {sorted(unknown)}")
    kwargs = dict(d)
    for key in ("features", "categories"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    cfg = ScoringConfig(**kwargs)
    if cfg.median_method not in ("auto", "sort", "hist", "bisect"):
        raise ValueError(
            f"median_method must be 'auto', 'sort', 'hist', or 'bisect'; "
            f"got {cfg.median_method!r}")
    if int(cfg.median_bins) < 2:
        raise ValueError(f"median_bins must be >= 2, got {cfg.median_bins}")
    for c in cfg.categories:
        for table, name in ((cfg.weights, "weights"),
                            (cfg.directions, "directions")):
            if c not in table:
                raise ValueError(f"{name} missing category {c!r}")
            missing = set(cfg.features) - set(table[c])
            if missing:
                raise ValueError(
                    f"{name}[{c!r}] missing features {sorted(missing)}")
        if c not in cfg.replication_factors:
            raise ValueError(f"replication_factors missing category {c!r}")
    missing = set(cfg.features) - set(cfg.global_medians)
    if missing:
        raise ValueError(f"global_medians missing features {sorted(missing)}")
    validate_replication_factors(cfg)
    return cfg


def load_scoring_config(path: str) -> ScoringConfig:
    with open(path) as f:
        return scoring_config_from_dict(json.load(f))


# ---------------------------------------------------------------------------
# KMeans
# ---------------------------------------------------------------------------

@dataclass
class KMeansConfig:
    """D² / k-means|| init + Lloyd loop knobs.

    ``max_iter=None`` resolves to ``max(100, n // 100)``.  ``dtype`` is the
    points dtype of the Lloyd loop (None keeps the feature table's):
    "bfloat16" halves the bytes each iteration reads; centroids and stats
    stay float32 (device.stat_dtype).
    """

    k: int = 4
    tol: float = 1e-4
    max_iter: int | None = None
    seed: int | None = 42
    #: Rows per mini-batch of incremental (Sculley) KMeans; None = full-batch
    #: Lloyd (ops/kmeans_stream.py).
    batch_size: int | None = None
    #: Shuffled passes over the data in mini-batch mode.
    batch_epochs: int = 5
    #: "d2", "kmeans||", or "auto" (kmeans|| from k >= 256, d2 below).
    init_method: str = "auto"
    dtype: str | None = None

    def __post_init__(self):
        if self.dtype not in (None, "float32", "bfloat16", "float16",
                              "float64"):
            raise ValueError(
                f"dtype must be one of float32/bfloat16/float16/float64 or "
                f"None; got {self.dtype!r}")
        if self.init_method not in ("auto", "d2", "kmeans||"):
            raise ValueError(
                f"init_method must be 'auto', 'd2' or 'kmeans||'; "
                f"got {self.init_method!r}")

    def resolve_max_iter(self, n: int) -> int:
        if self.max_iter is not None:
            return int(self.max_iter)
        return default_max_iter(n)


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

def _default_category_mix() -> dict[str, float]:
    return {"hot": 0.10, "shared": 0.20, "moderate": 0.50, "archival": 0.20}


def _default_rate_profiles() -> dict[str, dict[str, float]]:
    return {
        "hot": {"read_rate": 0.8, "write_rate": 0.2, "locality_bias": 0.7},
        "shared": {"read_rate": 0.6, "write_rate": 0.02, "locality_bias": 0.3},
        "moderate": {"read_rate": 0.1, "write_rate": 0.01, "locality_bias": 0.5},
        "archival": {"read_rate": 0.005, "write_rate": 0.001, "locality_bias": 0.9},
    }


@dataclass
class GeneratorConfig:
    """Synthetic file-population generator knobs."""

    n_files: int = 200
    base_dir: str = "/user/root/synth"
    min_size: int = 1024
    max_size: int = 1024 * 1024
    nodes: tuple[str, ...] = ("dn1", "dn2", "dn3")
    age_days_max: float = 365.0
    category_mix: dict[str, float] = field(default_factory=_default_category_mix)
    seed: int | None = None


@dataclass
class SimulatorConfig:
    """Poisson access-pattern simulator knobs: per-file Gaussian jitter of
    the category rates, read ~ N(mu, max(1e-4, 0.2 mu)), write ~ N(mu,
    max(1e-4, 0.5 mu)), locality_bias ~ N(mu, 0.2) clipped to [0, 1]."""

    duration_seconds: float = 300.0
    clients: tuple[str, ...] = ("dn1", "dn2", "dn3", "dn4")
    rate_profiles: dict[str, dict[str, float]] = field(
        default_factory=_default_rate_profiles)
    read_rate_jitter: float = 0.2
    write_rate_jitter: float = 0.5
    locality_jitter_std: float = 0.2
    seed: int | None = None


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineConfig:
    """generator -> simulator -> features -> kmeans -> scoring.

    ``device`` None means CUDA (device.resolve_device); ``dtype`` is the
    feature table's float type — "float64" runs on the CPU only, where it
    matches the JAX package under ``JAX_ENABLE_X64``.  ``evaluate`` adds
    the evaluate stage: the decided rf placed on the simulated cluster and
    replayed against uniform baselines (``cluster.evaluate.compare_policies``).
    ``mesh_shape`` (``{"data": N, "model": M}``) shards the features (data
    axis), clustering and the median stage over a mesh of shards.
    """

    device: str | None = None
    dtype: str = "float32"
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    kmeans: KMeansConfig = field(default_factory=KMeansConfig)
    scoring: ScoringConfig = field(default_factory=ScoringConfig)
    evaluate: bool = False
    mesh_shape: dict[str, int] | None = None

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"feature dtype must be float32 or float64; got {self.dtype!r}")
        if self.mesh_shape is not None:
            from .parallel.mesh import validate_mesh_shape

            self.mesh_shape = validate_mesh_shape(self.mesh_shape)


class _StageTimer:
    def __init__(self, name: str, metrics: "MetricsLog", device=None):
        self.name = name
        self.metrics = metrics
        self.device = device

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.metrics.record(f"{self.name}.seconds",
                            time.perf_counter() - self._t0)


@dataclass
class MetricsLog:
    """Flat metric record dict; a repeated key turns into a list."""

    records: dict[str, float | list[float]] = field(default_factory=dict)

    def record(self, key: str, value) -> None:
        value = value if value is None else float(value)
        if key in self.records:
            old = self.records[key]
            if isinstance(old, list):
                old.append(value)
            else:
                self.records[key] = [old, value]
        else:
            self.records[key] = value

    def timer(self, name: str, device=None) -> _StageTimer:
        """Host wall clock around a stage; on a CUDA ``device`` the stage
        ends with a synchronise, so its queued kernels count toward it."""
        return _StageTimer(name, self, device)
