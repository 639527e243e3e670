"""Policy evaluation: the port of ``evaluate_placement`` and
``compare_policies`` of ``cdrs_tpu/cluster/evaluate.py``, host numpy,
identical to them.

Replays an event log against a placement:

* **read locality** — the share of reads whose client holds a replica;
* **load balance** — max/mean of the operations each node serves: a local
  read by the client, a remote read by a seeded-random replica holder, a
  write by every replica (the HDFS write pipeline);
* **storage** — bytes per node, replicas included.

``compare_policies`` puts a decided per-file rf beside uniform baselines
(rf 1, the reference cluster's dfs.replication, and rf 3, the HDFS
default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.events import EventLog, Manifest
from .placement import ClusterTopology, PlacementResult, place_replicas

__all__ = ["PolicyMetrics", "evaluate_placement", "compare_policies"]


@dataclass
class PolicyMetrics:
    read_locality: float          # local reads / total reads
    reads_per_node: np.ndarray    # (#nodes,)
    writes_per_node: np.ndarray   # (#nodes,) replica write amplification included
    load_balance: float           # max/mean of total ops per node (1.0 = even)
    storage_per_node: np.ndarray  # (#nodes,) bytes
    total_storage: int
    n_reads: int
    n_writes: int

    def summary(self) -> dict:
        return {
            "read_locality": self.read_locality,
            "load_balance": self.load_balance,
            "total_storage_bytes": int(self.total_storage),
            "reads_per_node": self.reads_per_node.tolist(),
            "writes_per_node": self.writes_per_node.tolist(),
            "storage_per_node": self.storage_per_node.tolist(),
            "n_reads": self.n_reads,
            "n_writes": self.n_writes,
        }


def _client_to_topology(events: EventLog, topology: ClusterTopology) -> np.ndarray:
    """(e,) node index of each event's client, -1 outside the topology."""
    node_by_name = {nm: i for i, nm in enumerate(topology.nodes)}
    lut = np.asarray([node_by_name.get(c, -1) for c in events.clients], dtype=np.int32)
    return lut[events.client_id]


def evaluate_placement(manifest: Manifest, events: EventLog, placement: PlacementResult,
                       seed: int | None = 0) -> PolicyMetrics:
    topology = placement.topology
    n_nodes = len(topology)
    keep = events.path_id >= 0
    pid = events.path_id[keep]
    op = events.op[keep]
    client = _client_to_topology(events, topology)[keep]
    reads = op == 0
    writes = ~reads

    rmap = placement.replica_map[pid]                    # (e, max_rf)
    holds = placement.holds(pid, client)
    rng = np.random.default_rng(seed)
    pick = (rng.random(len(pid)) * placement.rf[pid]).astype(np.int32)
    server = np.where(holds, client, rmap[np.arange(len(pid)), pick])

    read_server = server[reads]
    reads_per_node = np.bincount(read_server[read_server >= 0],
                                 minlength=n_nodes).astype(np.int64)
    n_reads = int(reads.sum())
    read_locality = float(holds[reads].mean()) if n_reads else 1.0

    wmap = rmap[writes]
    writes_per_node = np.bincount(wmap[wmap >= 0].ravel(), minlength=n_nodes).astype(np.int64)
    n_writes = int(writes.sum())

    total_ops = reads_per_node + writes_per_node
    mean_ops = total_ops.mean() if total_ops.sum() else 1.0
    storage = placement.compute_storage(manifest.size_bytes)
    return PolicyMetrics(
        read_locality=read_locality, reads_per_node=reads_per_node,
        writes_per_node=writes_per_node,
        load_balance=float(total_ops.max() / max(mean_ops, 1e-12)),
        storage_per_node=storage, total_storage=int(storage.sum()),
        n_reads=n_reads, n_writes=n_writes)


def compare_policies(manifest: Manifest, events: EventLog, policy_rf: np.ndarray,
                     topology: ClusterTopology | None = None,
                     baselines: dict[str, int] | None = None, seed: int | None = 0) -> dict:
    """``{baseline name: summary, ..., "policy": summary}``: the decided
    ``policy_rf`` against uniform baselines (default ``uniform_1`` and
    ``uniform_3``), each placed and replayed with ``seed``."""
    topology = topology or ClusterTopology()
    baselines = baselines if baselines is not None else {"uniform_1": 1, "uniform_3": 3}
    out = {}
    for name, rf in baselines.items():
        placement = place_replicas(manifest, np.full(len(manifest), rf, dtype=np.int32),
                                   topology, seed)
        out[name] = evaluate_placement(manifest, events, placement, seed).summary()
    placement = place_replicas(manifest, policy_rf, topology, seed)
    out["policy"] = evaluate_placement(manifest, events, placement, seed).summary()
    return out
