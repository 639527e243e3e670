"""The serving view of one request batch: ``read_view`` of
``cdrs_tpu/serve/view.py`` with its ``state=`` and ``resolver=`` sources.

* ``state=`` — the fault path: the live ``ClusterState``'s dense map,
  ``slot_ok`` from reachability, the straggler factors and, when rot
  exists, the corruption mask;
* ``resolver=`` — maps the batch's unique file ids to their slot rows (the
  hash placement of a pinned epoch), so the view holds O(unique files)
  rows and the read ids are remapped onto them; a router that indexes
  ``replica_map[pid]`` routes exactly as over the full map.

The materialized ``placement=`` source and the router itself come with
serving (ROADMAP A8d).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ReadView", "read_view"]


@dataclass
class ReadView:
    """Router inputs for one batch of reads."""

    replica_map: np.ndarray          # (n_unique, R) int32, -1 padded
    slot_ok: np.ndarray              # same shape, bool
    node_throughput: np.ndarray      # (n_nodes,) float64
    slot_corrupt: np.ndarray | None  # same shape as replica_map, or None
    pid: np.ndarray                  # the reads' rows in ``replica_map``
    #: Population file id behind each row of ``replica_map``.
    file_ids: np.ndarray | None = None


def read_view(pid: np.ndarray, *, state=None, resolver=None,
              n_nodes: int | None = None) -> ReadView:
    """The view of the reads ``pid`` from the live ``state`` or, without
    one, through ``resolver(unique_ids) -> (k, R) int32 rows`` (which needs
    ``n_nodes``)."""
    if state is not None:
        corrupt = state.slot_corrupt if state.has_corruption else None
        return ReadView(state.replica_map, state.reachable_mask(), state.node_throughput,
                        corrupt, pid)
    if resolver is None or n_nodes is None:
        raise ValueError("read_view needs state=, or resolver= with n_nodes=")
    uniq, inv = np.unique(pid, return_inverse=True)
    rows = np.asarray(resolver(uniq), dtype=np.int32)
    return ReadView(rows, rows >= 0, np.ones(n_nodes), None,
                    inv.astype(pid.dtype if pid.dtype.kind == "i" else np.int64),
                    file_ids=uniq)
