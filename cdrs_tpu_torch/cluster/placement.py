"""Replica placement over a flat set of simulated datanodes: the part of
``cdrs_tpu/cluster/placement.py`` (and ``primary_on_topology`` of
``cdrs_tpu/placement_fn/compute.py``) that the controller's flat, rng
placement runs, host numpy, bit-identical to it for the same seed.

Replica 0 is the file's primary node, the rest distinct nodes in seeded
random priority order.  The reference also moves the best node outside the
primary's failure domain (and the second-best of that domain) to the
front; on a flat topology every node is its own domain, and that node is
already the best non-primary one, so the order is the same.  The rf is
capped at the node count, with a one-time warning.

Failure-domain hierarchies (rack and region parsers, the hierarchical
fill) are not ported yet (ROADMAP A8c, with the fault path), nor is the
stateless hash chooser (``method="hash"``, ROADMAP A8f): both raise
``ValueError`` naming their item.
"""

from __future__ import annotations

import warnings
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..io.events import Manifest

__all__ = ["ClusterTopology", "PlacementResult", "place_replicas", "primary_on_topology",
           "reset_rf_cap_warning"]


class _OnceWarning:
    """A one-shot warning latch that tests can re-arm."""

    def __init__(self) -> None:
        self.fired = False

    def reset(self) -> None:
        self.fired = False

    def warn(self, message: str) -> None:
        if not self.fired:
            self.fired = True
            warnings.warn(message, stacklevel=3)


_RF_CAP_WARNING = _OnceWarning()


def reset_rf_cap_warning() -> None:
    """Re-arm the one-shot rf-cap warning."""
    _RF_CAP_WARNING.reset()


@dataclass
class ClusterTopology:
    """A flat datanode set: every node is its own failure domain."""

    nodes: tuple[str, ...] = ("dn1", "dn2", "dn3")

    def __post_init__(self):
        self.nodes = tuple(self.nodes)
        if not self.nodes:
            raise ValueError("topology needs at least one node")
        if len(set(self.nodes)) != len(self.nodes):
            dupes = sorted({n for n in self.nodes if self.nodes.count(n) > 1})
            raise ValueError(f"duplicate node names in topology: {dupes}; every node "
                             "must be unique")

    def __len__(self) -> int:
        return len(self.nodes)


@dataclass
class PlacementResult:
    """Replica assignment: (n, max_rf) node ids, -1 where rf < max_rf."""

    replica_map: np.ndarray          # (n, max_rf) int32
    rf: np.ndarray                   # (n,) int32 effective rf (capped at #nodes)
    topology: ClusterTopology
    storage_per_node: np.ndarray | None = field(default=None)

    def holds(self, pid: np.ndarray, node: np.ndarray) -> np.ndarray:
        """Bool per event: does ``node`` hold a replica of file ``pid``?  A
        client outside the topology (``node < 0``) holds nothing."""
        return (self.replica_map[pid] == node[:, None]).any(axis=1) & (node >= 0)

    def compute_storage(self, size_bytes: np.ndarray) -> np.ndarray:
        """(#nodes,) replica bytes from the map; fills ``storage_per_node``
        when it is None."""
        if self.storage_per_node is None:
            sizes = np.asarray(size_bytes, dtype=np.int64)
            storage = np.zeros(len(self.topology), dtype=np.int64)
            sel = self.replica_map >= 0
            np.add.at(storage, self.replica_map[sel],
                      np.broadcast_to(sizes[:, None], self.replica_map.shape)[sel])
            self.storage_per_node = storage
        return self.storage_per_node


def primary_on_topology(node_vocab, primary_node_id: np.ndarray, topology) -> np.ndarray:
    """Manifest primary ids mapped onto the topology by node name; a name
    outside it spreads over the topology by crc32."""
    n_nodes = len(topology.nodes)
    node_by_name = {nm: i for i, nm in enumerate(topology.nodes)}
    lut = np.asarray([node_by_name.get(nm, zlib.crc32(str(nm).encode()) % n_nodes)
                      for nm in node_vocab], dtype=np.int32)
    return lut[np.asarray(primary_node_id)]


def place_replicas(manifest: Manifest, rf_per_file: np.ndarray,
                   topology: ClusterTopology | None = None, seed: int | None = 0,
                   method: str = "rng") -> PlacementResult:
    """Place ``rf_per_file`` replicas of each file on the topology (see the
    module docstring); deterministic for (manifest, rf, seed)."""
    if method == "hash":
        raise ValueError("placement method 'hash' is not ported yet (ROADMAP A8f, "
                         "functional placement)")
    if method != "rng":
        raise ValueError(f"unknown placement method {method!r} (want 'rng')")
    topology = topology or ClusterTopology()
    if not isinstance(topology, ClusterTopology):
        raise ValueError("failure-domain topologies are not ported yet (ROADMAP A8c, "
                         "the fault path); use the flat ClusterTopology")
    n = len(manifest)
    n_nodes = len(topology)
    primary = primary_on_topology(manifest.nodes, manifest.primary_node_id, topology)

    rf_want = np.asarray(rf_per_file, dtype=np.int32)
    n_capped = int((rf_want > n_nodes).sum())
    if n_capped:
        _RF_CAP_WARNING.warn(
            f"replication factor capped at the node count for {n_capped} files "
            f"(requested up to {int(rf_want.max())}, topology has {n_nodes} nodes): "
            f"replicas are distinct-per-node, so e.g. Archival rf=4 on a 3-node "
            f"topology places 3")
    rf = np.maximum(np.minimum(rf_want, n_nodes), 1)
    max_rf = int(rf.max())

    key = np.random.default_rng(seed).random((n, n_nodes))
    key[np.arange(n), primary] = -3.0           # replica 0: the primary
    order = np.argsort(key, axis=1).astype(np.int32)

    replica_map = order[:, :max_rf].copy()
    replica_map[np.arange(max_rf)[None, :] >= rf[:, None]] = -1
    result = PlacementResult(replica_map=replica_map, rf=rf, topology=topology)
    result.compute_storage(manifest.size_bytes)
    return result
