"""Functional (hash) placement on flat, rack and geo topologies, and the
cluster-map epochs the daemon publishes against."""

from .compute import (clip_shards_for_locality, compute_placement, file_keys, hash_priorities,
                      hierarchical_fill, node_salts)
from .epoch import Epoch, EpochMap

__all__ = ["Epoch", "EpochMap", "clip_shards_for_locality", "compute_placement", "file_keys",
           "hash_priorities", "hierarchical_fill", "node_salts"]
