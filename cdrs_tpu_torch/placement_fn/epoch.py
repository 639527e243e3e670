"""Cluster-map epochs: ``Epoch`` and the part of ``EpochMap`` of
``cdrs_tpu/placement_fn/epoch.py`` that the daemon's publication uses.

An ``EpochMap`` keeps the history of topologies; ``placement`` computes
the hash placement of any subset of files under one epoch, resolving the
manifest's primaries onto that epoch's topology by node name.  The epoch
diff (``diff``, ``EpochDiff``, ``addition_moved``) serves the elastic
path and is not ported yet (ROADMAP A8f, with elasticity).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cluster.placement import primary_on_topology
from .compute import compute_placement

__all__ = ["Epoch", "EpochMap"]


@dataclass(frozen=True)
class Epoch:
    """One immutable cluster-map revision."""

    epoch_id: int
    topology: object            # cluster.placement.ClusterTopology


class EpochMap:
    """The cluster's topology history.  ``vocab`` is the node-name
    vocabulary that the manifest's ``primary_node_id`` indexes."""

    def __init__(self, vocab, topology, seed: int = 0):
        self.vocab = tuple(vocab)
        self.seed = int(seed)
        self.epochs: list[Epoch] = [Epoch(0, topology)]

    @property
    def current(self) -> Epoch:
        return self.epochs[-1]

    def advance(self, topology) -> Epoch:
        """Install a new revision; returns it."""
        ep = Epoch(len(self.epochs), topology)
        self.epochs.append(ep)
        return ep

    def topology(self, epoch_id: int):
        return self.epochs[epoch_id].topology

    def placement(self, epoch_id: int, file_ids: np.ndarray, n_shards: np.ndarray,
                  primary_node_id: np.ndarray, out_width: int | None = None):
        """``compute_placement`` of ``file_ids`` under one epoch."""
        topo = self.topology(epoch_id)
        prim = primary_on_topology(self.vocab, np.asarray(primary_node_id), topo)
        return compute_placement(file_ids, n_shards, prim, topo, self.seed,
                                 out_width=out_width)
