"""The serving view of one request batch: ``read_view`` of
``cdrs_tpu/serve/view.py`` with its ``state=``, ``resolver=`` and
``placement=`` sources.

* ``state=`` — the fault path: the live ``ClusterState``'s dense map,
  ``slot_ok`` from reachability, the straggler factors and, when rot
  exists, the corruption mask; a state with ``read_rows`` (the overlay
  state of ``placement_fn``, which holds no dense map) gives only the
  batch's unique files' rows, and the read ids are remapped onto them;
* ``resolver=`` — maps the batch's unique file ids to their slot rows (the
  hash placement of a pinned epoch), so the view holds O(unique files)
  rows and the read ids are remapped onto them; a router that indexes
  ``replica_map[pid]`` routes exactly as over the full map;
* ``placement=`` — a static materialized ``PlacementResult``: every
  assigned slot can serve, every node at nominal throughput.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ReadView", "read_view"]


@dataclass
class ReadView:
    """Router inputs for one batch of reads."""

    replica_map: np.ndarray          # (n_files | n_unique, R) int32, -1 padded
    slot_ok: np.ndarray              # same shape, bool
    node_throughput: np.ndarray      # (n_nodes,) float64
    slot_corrupt: np.ndarray | None  # same shape as replica_map, or None
    pid: np.ndarray                  # the reads' rows in ``replica_map``
    #: Population file id behind each row of a compacted ``replica_map``;
    #: None when rows are file ids.
    file_ids: np.ndarray | None = None


def read_view(pid: np.ndarray, *, state=None, placement=None, resolver=None,
              n_nodes: int | None = None) -> ReadView:
    """The view of the reads ``pid`` from exactly one source: ``state``
    wins, then ``resolver(unique_ids) -> (k, R) int32 rows`` (which needs
    ``n_nodes``), then the static ``placement``."""
    if state is not None:
        if getattr(state, "read_rows", None) is not None:
            uniq, inv = np.unique(pid, return_inverse=True)
            rows, ok, corrupt = state.read_rows(uniq)
            return ReadView(rows, ok, state.node_throughput, corrupt,
                            inv.astype(pid.dtype if pid.dtype.kind == "i" else np.int64),
                            file_ids=uniq)
        corrupt = state.slot_corrupt if state.has_corruption else None
        return ReadView(state.replica_map, state.reachable_mask(), state.node_throughput,
                        corrupt, pid)
    if resolver is not None:
        if n_nodes is None:
            raise ValueError("read_view(resolver=...) needs n_nodes for the throughput "
                             "vector")
        uniq, inv = np.unique(pid, return_inverse=True)
        rows = np.asarray(resolver(uniq), dtype=np.int32)
        return ReadView(rows, rows >= 0, np.ones(n_nodes), None,
                        inv.astype(pid.dtype if pid.dtype.kind == "i" else np.int64),
                        file_ids=uniq)
    if placement is None:
        raise ValueError("read_view needs one of state=, resolver=, placement=")
    rm = placement.replica_map
    return ReadView(rm, rm >= 0, np.ones(len(placement.topology)), None, pid)
