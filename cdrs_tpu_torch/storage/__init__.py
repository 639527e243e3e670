"""Storage strategies (replicate or erasure-coded, on hot/warm/cold tiers):
the port of ``cdrs_tpu/storage``.  ``strategy.py`` holds the arithmetic;
``cluster.placement.place_stripes``, ``faults.ClusterState``,
``ControllerConfig.storage``, the serve plane's degraded-read penalty and
``cdrs_tpu_torch storage`` consume it."""

from .strategy import (
    DEFAULT_TIERS,
    StorageConfig,
    StorageTier,
    Strategy,
    StrategyVectors,
    load_storage_config,
    resolve_storage_config,
    storage_config_from_dict,
)

__all__ = [
    "DEFAULT_TIERS",
    "StorageConfig",
    "StorageTier",
    "Strategy",
    "StrategyVectors",
    "load_storage_config",
    "resolve_storage_config",
    "storage_config_from_dict",
]
