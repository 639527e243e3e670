"""Functional (hash) placement on a flat topology and the cluster-map
epochs the daemon publishes against."""

from .compute import compute_placement, file_keys, hash_priorities, node_salts
from .epoch import Epoch, EpochMap

__all__ = ["Epoch", "EpochMap", "compute_placement", "file_keys", "hash_priorities",
           "node_salts"]
