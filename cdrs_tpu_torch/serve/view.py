"""The serving view of one request batch: the resolver path of
``cdrs_tpu/serve/view.py``.

A resolver maps the batch's unique file ids to their slot rows (the
hash placement of a pinned epoch), so the view holds O(unique files)
rows and the read ids are remapped onto them; a router that indexes
``replica_map[pid]`` routes exactly as over the full map.  The fault
path's ``state=`` and the materialized ``placement=`` sources, and the
router itself, are not ported yet (ROADMAP A8c, A8d).
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
    slot_corrupt: np.ndarray | None  # always None here (no fault path)
    pid: np.ndarray                  # the reads' rows in ``replica_map``
    #: Population file id behind each row of ``replica_map``.
    file_ids: np.ndarray | None = None


def read_view(pid: np.ndarray, *, resolver, n_nodes: int) -> ReadView:
    """Resolve the reads ``pid`` through ``resolver(unique_ids) -> (k, R)
    int32 rows``."""
    uniq, inv = np.unique(pid, return_inverse=True)
    rows = np.asarray(resolver(uniq), dtype=np.int32)
    return ReadView(rows, rows >= 0, np.ones(n_nodes), None,
                    inv.astype(pid.dtype if pid.dtype.kind == "i" else np.int64),
                    file_ids=uniq)
