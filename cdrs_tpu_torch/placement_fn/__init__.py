"""Functional (hash) placement on flat, rack and geo topologies: the stateless
chooser (compute.py), cluster-map epochs and the epoch diff (epoch.py), and
the cluster states whose checkpoints hold only the rows that differ from
the computed base (state.py).  ``explain_placement`` narrates one file's slots."""

from .compute import (clip_shards_for_locality, compute_placement, explain_placement, file_keys,
                      hash_priorities, hierarchical_fill, node_salts)
from .epoch import Epoch, EpochDiff, EpochMap, addition_moved
from .state import FunctionalClusterState, OverlayClusterState

__all__ = ["Epoch", "EpochDiff", "EpochMap", "FunctionalClusterState", "OverlayClusterState",
           "addition_moved", "clip_shards_for_locality", "compute_placement",
           "explain_placement", "file_keys",
           "hash_priorities", "hierarchical_fill", "node_salts"]
