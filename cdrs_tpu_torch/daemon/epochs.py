"""Atomically published placement epochs: ``cdrs_tpu/daemon/epochs.py``.

Serving resolves against a published epoch, never a mutable table: each
admitted plan freezes into a :class:`PlacementEpoch` (read-only rf and
category vectors, the plan hash, and a resolver over the backing
``placement_fn.EpochMap`` revision) and lands through one reference swap
in :class:`EpochPublisher`.  A reader pins once per request batch and
routes the whole batch against that epoch, so no batch mixes two epochs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PlacementEpoch", "EpochPublisher"]


@dataclass(frozen=True)
class PlacementEpoch:
    """One admitted plan, as served.

    ``epoch_id`` is the daemon's publication sequence, continuous across
    checkpoint and resume; ``map_epoch_id`` names the ``EpochMap``
    revision inside this process (the map is rebuilt on resume).
    ``resolver(unique_file_ids) -> (k, R) int32`` slot rows is the
    ``serve.read_view`` plug, frozen over this epoch's rf vector.
    """

    epoch_id: int
    window: int                  # window whose plan this is
    plan_hash: str
    rf: np.ndarray               # (n,) int32, read-only
    category_idx: np.ndarray     # (n,) int32, read-only
    n_nodes: int
    map_epoch_id: int = 0
    resolver: object | None = field(default=None, repr=False)
    #: Trace id of the decision that published the epoch; None outside a
    #: traced daemon run.
    trace_id: str | None = None

    def __post_init__(self):
        # A snapshot, not a view: a later window cannot change a pinned plan.
        self.rf.setflags(write=False)
        self.category_idx.setflags(write=False)

    def read_view(self, pid: np.ndarray):
        """The router inputs for one request batch, pinned to this epoch."""
        from ..serve import read_view

        if self.resolver is None:
            raise ValueError(f"epoch {self.epoch_id} carries no resolver (published "
                             f"without a topology)")
        return read_view(pid, resolver=self.resolver, n_nodes=self.n_nodes)


class EpochPublisher:
    """Single-slot atomic publication: ``publish`` swaps one reference
    under a lock, ``pin`` is one unlocked attribute read.  Epoch ids must
    grow; republishing an older one raises."""

    def __init__(self, published_total: int = 0):
        self._lock = threading.Lock()
        self._current: PlacementEpoch | None = None
        #: Epochs published over the daemon's lifetime, resumes included.
        self.published_total = int(published_total)
        #: When on, ``pin`` stamps each epoch's first pin (perf_counter_ns)
        #: into ``first_pins`` for the decision trace.
        self.record_pins = False
        self.first_pins: dict[int, int] = {}

    def publish(self, epoch: PlacementEpoch) -> PlacementEpoch:
        with self._lock:
            cur = self._current
            if cur is not None and epoch.epoch_id <= cur.epoch_id:
                raise ValueError(f"epoch ids must grow: {epoch.epoch_id} after "
                                 f"{cur.epoch_id}")
            self._current = epoch
            self.published_total += 1
        return epoch

    def peek(self) -> PlacementEpoch | None:
        """The current epoch without pin semantics (reporting)."""
        return self._current

    def pin(self) -> PlacementEpoch | None:
        """The current epoch, to hold for a whole request batch."""
        ep = self._current
        if self.record_pins and ep is not None and ep.epoch_id not in self.first_pins:
            self.first_pins[ep.epoch_id] = time.perf_counter_ns()
        return ep
