"""Functional cluster states: ``cdrs_tpu/placement_fn/state.py``, host numpy,
decision-identical to it.

``FunctionalClusterState`` keeps the dense ``faults.ClusterState`` and all
its mutation policy, and changes what a checkpoint holds: the functional
base (seed, epoch and the per-file shard intent, rebuilt from the
controller's ``current_rf``), the rows that differ from the base
(*exceptions*: repairs onto live nodes, quarantines, deferred conversions,
decommission wipes), sparse corruption pairs and sparse strategy
overrides.  With ``sparse_checkpoint=False`` it keeps the dense snapshot:
the ``materialized_hash`` oracle that a functional run must equal.

``OverlayClusterState`` holds no ``(n_files, n_nodes)`` array at all: a
row is computed on demand (``_fn_base_rows``) unless the ``fid -> row``
overlay holds it, which happens exactly when it differs from the base;
corruption is a ``fid -> slot bitmask`` dict (at most 63 nodes); a
liveness event finds its blast radius by a chunked base scan
(``_holders``).  ``read_rows`` serves the read path O(unique files) rows.

Both share the base-form retarget: an rf change of a file whose row is
its base, on reachable holders and targets, moves along the computed slot
order (the slots nest in rf), so healthy migrations create no exception;
anything in the way falls back to the dense policy and the file becomes
an exception until a later retarget reconverges it.

Single rows come from a memo of each file's whole computed order (the
order at ``n_nodes`` shards, which the rows at fewer shards are prefixes
of); ``prefetch_rows`` fills it for a batch of files in one vectorized
pass, so a per-file loop (repairs, admitted moves) does not pay numpy's
per-call cost of a one-file placement several times a file.
"""

from __future__ import annotations

import types

import numpy as np

from ..faults.state import ClusterState, _corrupt_roll
from .compute import clip_shards_for_locality, compute_placement, node_salts

__all__ = ["FunctionalClusterState", "OverlayClusterState"]

#: Files whose computed order the single-row memo keeps before it starts
#: over; 0 turns the memo off (every single row is computed afresh).
_MEMO_MAX = 1 << 19


class FunctionalClusterState(ClusterState):
    """ClusterState whose placement state round-trips as exceptions."""

    def __init__(self, placement, size_bytes, *, primary: np.ndarray, seed: int = 0,
                 epoch: int = 0, sparse_checkpoint: bool = True):
        super().__init__(placement, size_bytes)
        self._fn_init(primary, seed, epoch, sparse_checkpoint)

    def _fn_init(self, primary, seed: int, epoch: int, sparse: bool) -> None:
        self._fn_primary = np.asarray(primary, dtype=np.int32)
        if self._fn_primary.shape[0] != self.min_live.shape[0]:
            raise ValueError(f"primary shape {self._fn_primary.shape} != "
                             f"({self.min_live.shape[0]},)")
        self._fn_seed = int(seed)
        self._fn_epoch = int(epoch)
        self._fn_sparse = bool(sparse)
        self._fn_salts = node_salts(self.topology.nodes, self._fn_seed)
        #: fid -> [region-local flag, (n_nodes,) int32 computed order, its
        #: length (n_nodes, or the region's for a region-local file), {rf:
        #: read-only base row}].
        self._fn_memo: dict[int, list] = {}
        #: Files mutated since the last ``exception_fids`` (to re-verify).
        self._fn_touched: set[int] = set()
        #: Verified standing exceptions, and their sorted-array cache.
        self._fn_exceptions: set[int] = set()
        self._fn_exc_array: np.ndarray | None = None

    # -- base placement ------------------------------------------------------
    def _fn_local(self, fids: np.ndarray):
        """The locality mask of ``fids`` for ``compute_placement`` (None when
        no file is region-local or the topology has one level)."""
        if self.topology.n_levels > 0 and self.region_local.any():
            return self.region_local[fids]
        return None

    def _fn_base_rows(self, fids: np.ndarray) -> np.ndarray:
        """(k, n_nodes) computed base rows of a file subset: a function of
        the seed, the topology, the installed shards, the primary and the
        region-locality flag."""
        fids = np.asarray(fids, dtype=np.int64)
        slots, _ = compute_placement(
            fids, self.installed_shards[fids], self._fn_primary[fids], self.topology,
            self._fn_seed, salts=self._fn_salts, out_width=len(self.nodes),
            local_mask=self._fn_local(fids))
        return slots

    def _fn_whole_orders(self, fids: np.ndarray) -> list:
        """Memo entries of ``fids``: each file's whole computed order (at
        ``n_nodes`` shards), computed in one vectorized pass."""
        n_nodes = len(self.nodes)
        local = self._fn_local(fids)
        full, _ = compute_placement(
            fids, np.full(fids.size, n_nodes, dtype=np.int32), self._fn_primary[fids],
            self.topology, self._fn_seed, salts=self._fn_salts, out_width=n_nodes,
            local_mask=local)
        flags = np.zeros(fids.size, dtype=bool) if local is None else local
        caps = (full >= 0).sum(axis=1)
        return [[lc, full[i], cap, {}]
                for i, (lc, cap) in enumerate(zip(flags.tolist(), caps.tolist()))]

    def _fn_memo_room(self, n: int) -> bool:
        """Whether ``n`` more entries may go into the memo (``_MEMO_MAX`` 0
        turns it off); a full memo starts over."""
        if _MEMO_MAX == 0:
            return False
        if len(self._fn_memo) + n > _MEMO_MAX:
            self._fn_memo.clear()
        return True

    def prefetch_rows(self, fids) -> None:
        """Compute the whole order of each of ``fids`` in one pass into the
        single-row memo."""
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size == 0 or not self._fn_memo_room(fids.size):
            return
        self._fn_memo.update(zip(fids.tolist(), self._fn_whole_orders(fids)))

    def _fn_memo_entry(self, fid: int) -> list:
        lc = bool(self.topology.n_levels > 0 and self.region_local[fid])
        hit = self._fn_memo.get(fid)
        if hit is None or hit[0] != lc:
            hit = self._fn_whole_orders(np.asarray([fid], dtype=np.int64))[0]
            if self._fn_memo_room(1):
                self._fn_memo[fid] = hit
        return hit

    def _fn_order(self, fid: int, shards: int) -> np.ndarray:
        """The computed slot order of one file at ``shards``: a prefix of its
        whole order (read-only)."""
        hit = self._fn_memo_entry(int(fid))
        return hit[1][:min(max(int(shards), 1), hit[2])]

    def _fn_base_row(self, fid: int, shards: int | None = None) -> np.ndarray:
        """(n_nodes,) base row of one file at ``shards`` (its installed shard
        count when None); read-only, shared between calls."""
        fid = int(fid)
        hit = self._fn_memo_entry(fid)
        r = min(max(int(self.installed_shards[fid] if shards is None else shards), 1), hit[2])
        row = hit[3].get(r)
        if row is None:
            row = np.full(len(self.nodes), -1, dtype=np.int32)
            row[:r] = hit[1][:r]
            row.flags.writeable = False
            hit[3][r] = row
        return row

    def exception_fids(self, verify_chunk: int = 1 << 18) -> np.ndarray:
        """Sorted int64 ids of the files whose row differs from the computed
        base, exact: files mutated since the last call are re-verified,
        the standing set comes from a cache.  Read-only."""
        if self._fn_touched:
            cand = np.fromiter(self._fn_touched, dtype=np.int64, count=len(self._fn_touched))
            cand.sort()
            self._fn_exceptions.difference_update(self._fn_touched)
            self._fn_touched.clear()
            for lo in range(0, cand.size, verify_chunk):
                part = cand[lo:lo + verify_chunk]
                diff = (self.replica_map[part] != self._fn_base_rows(part)).any(axis=1)
                self._fn_exceptions.update(int(f) for f in part[diff])
            self._fn_exc_array = None
        if self._fn_exc_array is None:
            arr = np.fromiter(self._fn_exceptions, dtype=np.int64,
                              count=len(self._fn_exceptions))
            arr.sort()
            self._fn_exc_array = arr
        return self._fn_exc_array

    # -- mutation tracking ---------------------------------------------------
    def add_replica(self, fid: int, node: int) -> None:
        self._fn_touched.add(int(fid))
        super().add_replica(fid, node)

    def drop_replica(self, fid: int, node: int) -> None:
        self._fn_touched.add(int(fid))
        super().drop_replica(fid, node)

    def apply_event(self, ev) -> None:
        if ev.kind == "decommission":
            # A decommission wipes rows in bulk, past drop_replica.
            for name in ev.node_list:
                i = self._nid(name)
                self._fn_touched.update(
                    int(f) for f in np.flatnonzero((self.replica_map == i).any(axis=1)))
        super().apply_event(ev)

    def grow(self, topology) -> None:
        """Elastic scale-out: the appended nodes join the base (fresh salts,
        epoch bump).  The caller pins the epoch diff's moved set first."""
        super().grow(topology)
        self._fn_salts = node_salts(self.topology.nodes, self._fn_seed)
        self._fn_memo.clear()
        self._fn_epoch += 1

    def pin_rows(self, fids) -> None:
        """Rows are held already: mark them for re-verification against the
        base that is about to move."""
        self._fn_touched.update(int(f) for f in np.asarray(fids))

    def retarget_row(self, fid: int, new_row: np.ndarray) -> int:
        self._fn_touched.add(int(fid))
        return super().retarget_row(fid, new_row)

    # -- base-form retarget --------------------------------------------------
    def apply_rf_target(self, fid: int, rf_new: int, record_intent: bool = True) -> int:
        if record_intent:
            # An intent change moves the base even where the row stays.
            self._fn_touched.add(int(fid))
            if self._fn_can_retarget(fid, rf_new):
                return self._fn_retarget(fid, rf_new)
        return super().apply_rf_target(fid, rf_new, record_intent)

    def _fn_can_retarget(self, fid: int, rf_new: int) -> bool:
        """Whether the base-form move cannot differ from a healthy cluster's:
        the row is its base, and every holder and every would-be computed
        target is reachable."""
        row = self.row(fid)
        cur = int(self.installed_shards[fid])
        base = self._fn_order(fid, max(cur, int(rf_new)))
        n_cur = int((row >= 0).sum())
        if n_cur != min(max(cur, 1), len(self.nodes)) \
                or row[:n_cur].tobytes() != base[:n_cur].tobytes():
            return False
        target = min(max(int(rf_new), 1), len(self.nodes))
        return bool(self.node_reachable()[base[:max(n_cur, target)]].all())

    def _fn_retarget(self, fid: int, rf_new: int) -> int:
        """Move ``fid`` along its computed order: growth appends computed
        nodes, a shrink drops the computed tail."""
        cur = int((self.row(fid) >= 0).sum())
        self.installed_shards[fid] = int(rf_new)
        return self._fn_walk(fid, cur, rf_new)

    def _fn_walk(self, fid: int, cur: int, rf_new: int) -> int:
        target = min(max(int(rf_new), 1), len(self.nodes))
        if target == cur:
            return 0
        order = self._fn_order(fid, max(cur, target))
        delta = 0
        for node in order[cur:target]:
            self.add_replica(fid, int(node))
            delta += 1
        for node in order[target:cur][::-1]:
            self.drop_replica(fid, int(node))
            delta -= 1
        return delta

    # -- checkpoint ----------------------------------------------------------
    def state_arrays(self, rf_hint: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """The sparse snapshot (the dense one with ``sparse_checkpoint=False``).

        ``rf_hint`` (the controller's ``current_rf``) anchors the shard
        intent: intents are stored only where they differ from
        ``clip(rf_hint, 1, None)``; without a hint they are stored dense."""
        if not self._fn_sparse:
            return super().state_arrays()
        exc = self.exception_fids()
        arrays = self._fn_head(exc, self.replica_map[exc].copy())
        if self._n_corrupt:
            cf, cs = np.nonzero(self.slot_corrupt)
            arrays["fault_fn_corrupt_fid"] = cf.astype(np.int64)
            arrays["fault_fn_corrupt_slot"] = cs.astype(np.int32)
        arrays.update(self._fn_tail(rf_hint))
        return arrays

    def _fn_head(self, exc: np.ndarray, rows: np.ndarray) -> dict[str, np.ndarray]:
        return {
            "fault_fn_sparse": np.asarray([1], dtype=np.int8),
            "fault_fn_seed": np.asarray([self._fn_seed], dtype=np.int64),
            "fault_fn_epoch": np.asarray([self._fn_epoch], dtype=np.int64),
            "fault_fn_exc_fids": exc,
            "fault_fn_exc_rows": rows,
            "fault_node_up": self.node_up.copy(),
            "fault_node_decommissioned": self.node_decommissioned.copy(),
            "fault_node_partitioned": self.node_partitioned.copy(),
            "fault_node_fail_prob": self.node_fail_prob.copy(),
            "fault_node_throughput": self.node_throughput.copy(),
        }

    def _fn_tail(self, rf_hint) -> dict[str, np.ndarray]:
        """The shard intents (sparse against ``rf_hint``, or dense) and the
        strategy overrides against the replicate defaults."""
        arrays: dict[str, np.ndarray] = {}
        if rf_hint is not None:
            default = np.clip(np.asarray(rf_hint, dtype=np.int64), 1, None).astype(np.int32)
            dev = np.flatnonzero(self.installed_shards != default)
            arrays["fault_fn_intent_fids"] = dev.astype(np.int64)
            arrays["fault_fn_intent_vals"] = self.installed_shards[dev].copy()
        else:
            arrays["fault_fn_intent_dense"] = self.installed_shards.copy()
        dev = np.flatnonzero((self.min_live != 1) | (self.shard_bytes != self.sizes)
                             | (self.ec_k != 0) | self.region_local)
        arrays["fault_fn_strat_fids"] = dev.astype(np.int64)
        arrays["fault_fn_strat_min_live"] = self.min_live[dev].copy()
        arrays["fault_fn_strat_shard_bytes"] = self.shard_bytes[dev].copy()
        arrays["fault_fn_strat_ec_k"] = self.ec_k[dev].copy()
        arrays["fault_fn_strat_local"] = self.region_local[dev].copy()
        return arrays

    def _fn_load_common(self, arrays: dict) -> np.ndarray:
        """Load seed check, epoch, intents, strategy overrides and node
        status from a sparse snapshot; returns the exception ids."""
        n = self.min_live.shape[0]
        if int(arrays["fault_fn_seed"][0]) != self._fn_seed:
            raise ValueError(f"checkpoint placement seed {int(arrays['fault_fn_seed'][0])} != "
                             f"{self._fn_seed}: stale checkpoint? delete it to start over")
        self._fn_epoch = int(arrays["fault_fn_epoch"][0])
        # Shard intent first: the base depends on it.
        if "fault_fn_intent_dense" in arrays:
            self.installed_shards = np.asarray(arrays["fault_fn_intent_dense"],
                                               dtype=np.int32).copy()
        else:
            if "current_rf" not in arrays:
                raise ValueError("sparse functional checkpoint needs the controller's "
                                 "current_rf for intent reconstruction")
            self.installed_shards = np.clip(np.asarray(arrays["current_rf"], dtype=np.int64),
                                            1, None).astype(np.int32)
            self.installed_shards[np.asarray(arrays["fault_fn_intent_fids"],
                                             dtype=np.int64)] = \
                np.asarray(arrays["fault_fn_intent_vals"], dtype=np.int32)
        self.min_live = np.ones(n, dtype=np.int32)
        self.shard_bytes = self.sizes.copy()
        self.ec_k = np.zeros(n, dtype=np.int32)
        self.region_local = np.zeros(n, dtype=bool)
        sf = np.asarray(arrays.get("fault_fn_strat_fids", np.zeros(0, np.int64)),
                        dtype=np.int64)
        if sf.size:
            self.min_live[sf] = np.asarray(arrays["fault_fn_strat_min_live"], dtype=np.int32)
            self.shard_bytes[sf] = np.asarray(arrays["fault_fn_strat_shard_bytes"],
                                              dtype=np.int64)
            self.ec_k[sf] = np.asarray(arrays["fault_fn_strat_ec_k"], dtype=np.int32)
            if "fault_fn_strat_local" in arrays:
                self.region_local[sf] = np.asarray(arrays["fault_fn_strat_local"], dtype=bool)
        self.node_up = np.asarray(arrays["fault_node_up"], dtype=bool).copy()
        self.node_decommissioned = np.asarray(arrays["fault_node_decommissioned"],
                                              dtype=bool).copy()
        self.node_partitioned = np.asarray(arrays["fault_node_partitioned"], dtype=bool).copy()
        self.node_fail_prob = np.asarray(arrays["fault_node_fail_prob"],
                                         dtype=np.float64).copy()
        self.node_throughput = np.asarray(arrays["fault_node_throughput"],
                                          dtype=np.float64).copy()
        self._fn_memo.clear()
        self._fn_touched = set()
        self._fn_exc_array = None
        return np.asarray(arrays["fault_fn_exc_fids"], dtype=np.int64)

    def load_state_arrays(self, arrays: dict) -> None:
        if "fault_fn_sparse" not in arrays:
            # A dense snapshot: the parent loads it, then one sweep seeds the
            # standing exceptions.
            super().load_state_arrays(arrays)
            self._fn_memo.clear()
            self._fn_touched = set()
            self._fn_exceptions = set()
            self._fn_exc_array = None
            self._fn_mark_deviations()
            return
        exc = self._fn_load_common(arrays)
        n = self.min_live.shape[0]
        n_nodes = len(self.nodes)
        # The base, with the exceptions laid over it (verified at save time).
        self.replica_map = np.full((n, n_nodes), -1, dtype=np.int32)
        for lo in range(0, n, 1 << 20):
            hi = min(lo + (1 << 20), n)
            self.replica_map[lo:hi] = self._fn_base_rows(np.arange(lo, hi, dtype=np.int64))
        self.replica_map[exc] = np.asarray(arrays["fault_fn_exc_rows"], dtype=np.int32)
        self._fn_exceptions = set(int(f) for f in exc)
        self.slot_corrupt = np.zeros((n, n_nodes), dtype=bool)
        if "fault_fn_corrupt_fid" in arrays:
            self.slot_corrupt[np.asarray(arrays["fault_fn_corrupt_fid"], dtype=np.int64),
                              np.asarray(arrays["fault_fn_corrupt_slot"], dtype=np.int64)] = True
        self._n_corrupt = int(self.slot_corrupt.sum())
        self._recompute_node_bytes()
        self._refresh_all()
        self.version += 1

    def _fn_mark_deviations(self, chunk: int = 1 << 20) -> None:
        """Seed the standing exceptions with every row that differs from its
        base (dense-snapshot loads only)."""
        n = self.replica_map.shape[0]
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            base = self._fn_base_rows(np.arange(lo, hi, dtype=np.int64))
            dev = np.flatnonzero((self.replica_map[lo:hi] != base).any(axis=1))
            self._fn_exceptions.update(int(lo + f) for f in dev)


class OverlayClusterState(FunctionalClusterState):
    """Functional ClusterState with no resident ``(n_files, n_nodes)`` array:
    the overlay ``_ov`` holds exactly the rows that differ from the computed
    base (so it is the standing exception set), corruption is a ``fid ->
    slot bitmask`` dict, and the per-file count caches stay maintained as
    in the dense state.  Every mutation reproduces the dense semantics on
    the resolved row, slot positions included.  Checkpoints are always
    sparse.  ``replica_map``, ``slot_corrupt`` and the masks materialize on
    access (tests, the evaluate replay); the per-file paths never touch
    them."""

    def __init__(self, placement, size_bytes, *, primary: np.ndarray, seed: int = 0,
                 epoch: int = 0, sparse_checkpoint: bool = True):
        if not sparse_checkpoint:
            raise ValueError("OverlayClusterState has no dense map to snapshot: use "
                             "FunctionalClusterState for the dense oracle")
        # The dense constructor's set-up but for its per-file-by-node arrays.
        rf = np.asarray(placement.rf, dtype=np.int32)
        n = rf.shape[0]
        self._init_files(placement.topology, size_bytes, rf)
        n_nodes = len(self.nodes)
        self._n_corrupt = 0
        self._corrupt_bits: dict[int, int] = {}
        self._fn_init(primary, seed, epoch, True)
        #: fid -> (n_nodes,) int32 row, held iff it differs from the base.
        self._ov: dict[int, np.ndarray] = {}
        rm = placement.replica_map
        if rm is not None and rm.size:
            # A hand-built placement may differ from the base: hold exactly
            # the rows that do.
            width = min(rm.shape[1], n_nodes)
            for lo in range(0, n, 1 << 20):
                hi = min(lo + (1 << 20), n)
                base = self._fn_base_rows(np.arange(lo, hi, dtype=np.int64))
                given = np.full((hi - lo, n_nodes), -1, dtype=np.int32)
                given[:, :width] = rm[lo:hi, :width]
                for f in np.flatnonzero((given != base).any(axis=1)):
                    self._ov[int(lo + f)] = given[f].copy()
        self.node_bytes = np.zeros(n_nodes, dtype=np.int64)
        self._recompute_node_bytes()
        self.version = 0
        self._refresh_all()

    @classmethod
    def from_base(cls, topology, size_bytes, *, n_shards: np.ndarray, primary: np.ndarray,
                  seed: int = 0, epoch: int = 0) -> "OverlayClusterState":
        """Construct in base form: no placement is materialized anywhere."""
        shim = types.SimpleNamespace(
            topology=topology,
            rf=np.clip(np.asarray(n_shards), 1, len(topology.nodes)).astype(np.int32),
            replica_map=None)
        return cls(shim, size_bytes, primary=primary, seed=seed, epoch=epoch)

    # -- row resolution ------------------------------------------------------
    def row(self, fid: int) -> np.ndarray:
        """Resolved (n_nodes,) row: the overlay's, else the computed base.
        Read-only (mutations go through the primitives)."""
        r = self._ov.get(int(fid))
        if r is not None:
            return r
        return self._fn_base_row(int(fid))

    def rows(self, fids: np.ndarray) -> np.ndarray:
        fids = np.asarray(fids, dtype=np.int64)
        out = self._fn_base_rows(fids)
        ov = self._ov
        if not ov:
            return out
        if fids.size > len(ov) and bool((np.diff(fids) > 0).all()):
            # More (sorted) ids than held rows: patch the held rows in range.
            keys = np.fromiter(ov, dtype=np.int64, count=len(ov))
            pos = np.searchsorted(fids, keys)
            hit = pos < fids.size
            hit[hit] = fids[pos[hit]] == keys[hit]
            for p, f in zip(pos[hit].tolist(), keys[hit].tolist()):
                out[p] = ov[f]
            return out
        for i, f in enumerate(fids.tolist()):
            r = ov.get(f)
            if r is not None:
                out[i] = r
        return out

    def _set_row(self, fid: int, row: np.ndarray) -> None:
        row = np.asarray(row, dtype=np.int32)
        if row.tobytes() == self._fn_base_row(fid).tobytes():
            self._ov.pop(int(fid), None)
        else:
            self._ov[int(fid)] = row

    def assigned_counts(self) -> np.ndarray:
        """Assigned slots per file without computing a row: a base row holds
        exactly its placement rf (``clip(installed_shards, 1, n_nodes)``,
        capped at the region for a region-local file); the overlay's rows
        are counted."""
        n_nodes = len(self.nodes)
        rf = np.clip(self.installed_shards, 1, n_nodes).astype(np.int32)
        local = self._fn_local(np.arange(self.min_live.shape[0]))
        if local is not None:
            rf = clip_shards_for_locality(rf, self._fn_primary, self.topology, local)
        out = rf.astype(np.int64)
        for f, r in self._ov.items():
            out[f] = int((r >= 0).sum())
        return out

    @property
    def replica_map(self) -> np.ndarray:
        """The whole map, materialized (tests and the evaluate replay)."""
        return self.rows(np.arange(self.min_live.shape[0], dtype=np.int64))

    @property
    def slot_corrupt(self) -> np.ndarray:
        out = np.zeros((self.min_live.shape[0], len(self.nodes)), dtype=bool)
        for f in self._corrupt_bits:
            out[f] = self.corrupt_row(f)
        return out

    def live_mask(self) -> np.ndarray:
        rm = self.replica_map
        return (rm >= 0) & self.node_up[np.clip(rm, 0, None)]

    def reachable_mask(self) -> np.ndarray:
        rm = self.replica_map
        return (rm >= 0) & self.node_reachable()[np.clip(rm, 0, None)]

    # -- cached counts -------------------------------------------------------
    def _refresh_all(self, chunk: int = 1 << 20) -> None:
        n = self.min_live.shape[0]
        self._live_counts = np.zeros(n, dtype=np.int32)
        self._reach_counts = np.zeros(n, dtype=np.int32)
        self._dom_spread = np.zeros(n, dtype=np.int32)
        if self._top_index is not None:
            self._top_spread = np.zeros(n, dtype=np.int32)
        for lo in range(0, n, int(chunk)):
            self._refresh_files(np.arange(lo, min(lo + int(chunk), n), dtype=np.int64))

    def _recompute_node_bytes(self, chunk: int = 1 << 20) -> None:
        n = self.min_live.shape[0]
        self.node_bytes = np.zeros(len(self.nodes), dtype=np.int64)
        for lo in range(0, n, int(chunk)):
            hi = min(lo + int(chunk), n)
            rows = self.rows(np.arange(lo, hi, dtype=np.int64))
            sel = rows >= 0
            np.add.at(self.node_bytes, rows[sel],
                      np.broadcast_to(self.shard_bytes[lo:hi, None], rows.shape)[sel])

    def _holders(self, node: int, chunk: int = 1 << 20) -> np.ndarray:
        """Sorted ids of the files whose resolved row holds ``node``: a
        chunked base scan patched by the overlay."""
        n = self.min_live.shape[0]
        parts: list[np.ndarray] = []
        for lo in range(0, n, int(chunk)):
            fids = np.arange(lo, min(lo + int(chunk), n), dtype=np.int64)
            parts.append(fids[(self._fn_base_rows(fids) == node).any(axis=1)])
        base = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        if not self._ov:
            return base
        held = [f for f, r in self._ov.items() if (r == node).any()]
        gone = np.fromiter(self._ov, dtype=np.int64, count=len(self._ov))
        out = np.union1d(np.setdiff1d(base, gone, assume_unique=True),
                         np.asarray(held, dtype=np.int64))
        return out.astype(np.int64)

    # -- mutation primitives -------------------------------------------------
    def add_replica(self, fid: int, node: int) -> None:
        row = self.row(fid).copy()
        free = np.flatnonzero(row < 0)
        if free.size == 0:  # pragma: no cover - width == n_nodes prevents this
            raise RuntimeError(f"file {fid} has no free replica slot")
        s = int(free[0])
        row[s] = node
        self._clear_corrupt_bit(fid, s)
        self.node_bytes[node] += self.shard_bytes[fid]
        self._set_row(fid, row)
        self._refresh_one(fid)
        self.version += 1

    def drop_replica(self, fid: int, node: int) -> None:
        row = self.row(fid).copy()
        slots = np.flatnonzero(row == node)
        if slots.size:
            s = int(slots[0])
            row[s] = -1
            self._clear_corrupt_bit(fid, s)
            self.node_bytes[node] -= self.shard_bytes[fid]
            self._set_row(fid, row)
            self._refresh_one(fid)
            self.version += 1

    # -- corruption (sparse bitmasks) ----------------------------------------
    def _clear_corrupt_bit(self, fid: int, slot: int) -> None:
        bits = self._corrupt_bits.get(int(fid))
        if bits is not None and bits >> slot & 1:
            bits &= ~(1 << slot)
            self._n_corrupt -= 1
            if bits:
                self._corrupt_bits[int(fid)] = bits
            else:
                del self._corrupt_bits[int(fid)]
            self.version += 1

    def corrupt_replica(self, fid: int, node: int) -> bool:
        slots = np.flatnonzero(self.row(fid) == node)
        if slots.size == 0:
            return False
        s = int(slots[0])
        bits = self._corrupt_bits.get(int(fid), 0)
        if bits >> s & 1:
            return False
        self._corrupt_bits[int(fid)] = bits | (1 << s)
        self._n_corrupt += 1
        self.version += 1
        return True

    def corrupt_row(self, fid: int) -> np.ndarray:
        """(n_nodes,) bool rot mask of one file."""
        bits = self._corrupt_bits.get(int(fid), 0)
        return np.asarray([bool(bits >> s & 1) for s in range(len(self.nodes))], dtype=bool)

    def corrupt_at(self, fids: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Bool per (fid, slot) pair."""
        fids = np.asarray(fids)
        if not self._n_corrupt:
            return np.zeros(fids.shape[0], dtype=bool)
        cb = self._corrupt_bits
        return np.fromiter((bool(cb.get(int(f), 0) >> int(s) & 1)
                            for f, s in zip(fids, np.asarray(slots))),
                           dtype=bool, count=fids.shape[0])

    def verify_sources(self, fid: int) -> tuple[int, int]:
        if not self._n_corrupt:
            return 0, 0
        bits = self._corrupt_bits.get(int(fid), 0)
        if not bits:
            return 0, 0
        row = self.row(fid)
        reach = self.node_reachable()
        found = charge = 0
        for s in range(len(self.nodes)):
            if not bits >> s & 1 or row[s] < 0:
                continue
            node = int(row[s])
            if not reach[node]:
                continue
            charge += int(np.ceil(int(self.shard_bytes[fid])
                                  / max(float(self.node_throughput[node]), 1e-9)))
            self.quarantine(fid, node)
            found += 1
        return found, charge

    def corrupt_file_counts(self) -> np.ndarray:
        out = np.zeros(self.min_live.shape[0], dtype=np.int32)
        for f, bits in self._corrupt_bits.items():
            row = self.row(f)
            out[f] = sum(1 for s in range(len(self.nodes))
                         if bits >> s & 1 and row[s] >= 0 and self.node_up[int(row[s])])
        return out

    def true_lost_mask(self) -> np.ndarray:
        if not self._n_corrupt:
            return self.lost_mask()
        return (self._live_counts - self.corrupt_file_counts()) < self.min_live

    # -- events --------------------------------------------------------------
    def apply_event(self, ev) -> None:
        affected: list[np.ndarray] = []
        for name in ev.node_list:
            i = self._nid(name)
            if ev.kind in self._COUNT_KINDS:
                affected.append(self._holders(i))
            if ev.kind == "crash":
                self.node_up[i] = False
            elif ev.kind == "recover":
                if not self.node_decommissioned[i]:
                    self.node_up[i] = True
            elif ev.kind == "decommission":
                self.node_up[i] = False
                self.node_decommissioned[i] = True
                self.node_bytes[i] = 0
                for f in affected[-1].tolist():
                    row = self.row(f).copy()
                    for s in np.flatnonzero(row == i):
                        row[int(s)] = -1
                        self._clear_corrupt_bit(f, int(s))
                    self._set_row(f, row)
            elif ev.kind == "partition":
                self.node_partitioned[i] = True
            elif ev.kind == "heal":
                self.node_partitioned[i] = False
            elif ev.kind == "flaky":
                self.node_fail_prob[i] = float(ev.fail_prob)
            elif ev.kind == "unflaky":
                self.node_fail_prob[i] = 0.0
            elif ev.kind == "degrade":
                self.node_throughput[i] = float(ev.factor)
            elif ev.kind == "restore":
                self.node_throughput[i] = 1.0
            elif ev.kind == "corrupt":
                if ev.file >= 0:
                    if ev.file >= self.min_live.shape[0]:
                        raise ValueError(f"corrupt event {ev.spec()!r} pins file {ev.file} "
                                         f"but the population has {self.min_live.shape[0]} "
                                         "files")
                    self.corrupt_replica(int(ev.file), i)
                else:
                    holds = self._holders(i)
                    roll = _corrupt_roll(ev.window, i, holds)
                    for f in holds[roll < float(ev.fail_prob)]:
                        self.corrupt_replica(int(f), i)
            else:  # pragma: no cover - FaultEvent validates kinds
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        if affected:
            # One node's holders are sorted and unique already.
            self._refresh_files(affected[0] if len(affected) == 1
                                else np.unique(np.concatenate(affected)))
        self.version += 1

    # -- intent changes pin the row ------------------------------------------
    # A row absent from the overlay is its base, which moves with the
    # installed shards (or the strategy, or the epoch): every change of
    # those pins the resolved row first, and the primitives' _set_row drops
    # the pin once the row reaches the new base.
    def apply_rf_target(self, fid: int, rf_new: int, record_intent: bool = True) -> int:
        if record_intent:
            if self._fn_can_retarget(fid, rf_new):
                return self._fn_retarget(fid, rf_new)
            pinned = self.row(fid).copy()
            self.installed_shards[fid] = int(rf_new)
            self._ov[int(fid)] = pinned
            delta = ClusterState.apply_rf_target(self, fid, rf_new, record_intent=False)
            self._set_row(fid, self.row(fid).copy())
            return delta
        return ClusterState.apply_rf_target(self, fid, rf_new, record_intent=False)

    def _fn_retarget(self, fid: int, rf_new: int) -> int:
        cur_row = self.row(fid).copy()
        cur = int((cur_row >= 0).sum())
        self.installed_shards[fid] = int(rf_new)
        self._ov[int(fid)] = cur_row          # pinned under the new base
        if min(max(int(rf_new), 1), len(self.nodes)) == cur:
            self._set_row(fid, self.row(fid).copy())
            return 0
        return self._fn_walk(fid, cur, rf_new)

    def apply_strategy_target(self, fid: int, min_live: int, shard_bytes: int, ec_k: int,
                              target: int, region_local: bool = False) -> int:
        same = (int(self.min_live[fid]) == int(min_live)
                and int(self.shard_bytes[fid]) == int(shard_bytes)
                and int(self.ec_k[fid]) == int(ec_k)
                and bool(self.region_local[fid]) == bool(region_local))
        if not same:
            # The re-encode moves the base (the strategy feeds it): pin the row.
            self._ov.setdefault(int(fid), self.row(fid).copy())
        delta = ClusterState.apply_strategy_target(self, fid, min_live, shard_bytes, ec_k,
                                                   target, region_local)
        if not same:
            self._set_row(fid, self.row(fid).copy())
        return delta

    def pin_rows(self, fids) -> None:
        """Hold the resolved rows before the base moves (an epoch advance):
        they stand as exceptions until the rebalance moves them."""
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size == 0:
            return
        rows = self.rows(fids)
        for i, f in enumerate(fids.tolist()):
            self._ov[f] = rows[i].copy()

    def retarget_row(self, fid: int, new_row: np.ndarray) -> int:
        new_row = np.asarray(new_row, dtype=np.int32)
        old_row = self.row(fid).copy()
        old_nodes = {int(x) for x in old_row[old_row >= 0]}
        new_nodes = {int(x) for x in new_row[new_row >= 0]}
        sb = int(self.shard_bytes[fid])
        for v in old_nodes - new_nodes:
            self.node_bytes[v] -= sb
        for v in new_nodes - old_nodes:
            self.node_bytes[v] += sb
        bits = self._corrupt_bits.get(int(fid), 0)
        if bits:
            slot_of = {int(v): int(s) for s, v in enumerate(new_row) if v >= 0}
            new_bits = 0
            for s in range(len(self.nodes)):
                if bits >> s & 1:
                    v = int(old_row[s])
                    if v in slot_of:
                        new_bits |= 1 << slot_of[v]
                    else:
                        self._n_corrupt -= 1
            if new_bits:
                self._corrupt_bits[int(fid)] = new_bits
            else:
                del self._corrupt_bits[int(fid)]
        self._set_row(fid, new_row)
        self._refresh_one(fid)
        self.version += 1
        return sb * len(new_nodes - old_nodes)

    def grow(self, topology) -> None:
        """Scale-out with no dense map: per-node arrays extend, every held
        overlay row widens, salts refresh, the epoch bumps."""
        add = self._grow_common(topology)
        pad = np.full(add, -1, dtype=np.int32)
        for f in list(self._ov):
            self._ov[f] = np.concatenate([self._ov[f], pad])
        self._fn_salts = node_salts(self.topology.nodes, self._fn_seed)
        self._fn_memo.clear()
        self._fn_epoch += 1

    # -- serve resolution ----------------------------------------------------
    def read_rows(self, uniq: np.ndarray):
        """(rows, slot_ok, slot_corrupt or None) of a unique-id subset: the
        read path's O(unique files) view (``serve.read_view``)."""
        rows = self.rows(uniq)
        ok = (rows >= 0) & self.node_reachable()[np.clip(rows, 0, None)]
        corrupt = None
        if self._n_corrupt:
            corrupt = np.zeros(rows.shape, dtype=bool)
            for i, f in enumerate(np.asarray(uniq).tolist()):
                if f in self._corrupt_bits:
                    corrupt[i] = self.corrupt_row(f)
        return rows, ok, corrupt

    # -- exceptions and checkpoint -------------------------------------------
    def exception_fids(self, verify_chunk: int = 1 << 18) -> np.ndarray:
        """The overlay's keys, sorted: held exactly when the row differs."""
        return np.asarray(sorted(self._ov), dtype=np.int64)

    def state_arrays(self, rf_hint: np.ndarray | None = None) -> dict[str, np.ndarray]:
        exc = self.exception_fids()
        rows = (np.stack([self._ov[int(f)] for f in exc]) if exc.size
                else np.zeros((0, len(self.nodes)), dtype=np.int32))
        arrays = self._fn_head(exc, rows)
        if self._n_corrupt:
            cf, cs = [], []
            for f in sorted(self._corrupt_bits):
                bits = self._corrupt_bits[f]
                for s in range(len(self.nodes)):
                    if bits >> s & 1:
                        cf.append(f)
                        cs.append(s)
            arrays["fault_fn_corrupt_fid"] = np.asarray(cf, dtype=np.int64)
            arrays["fault_fn_corrupt_slot"] = np.asarray(cs, dtype=np.int32)
        arrays.update(self._fn_tail(rf_hint))
        return arrays

    def load_state_arrays(self, arrays: dict) -> None:
        if "fault_fn_sparse" not in arrays:
            raise ValueError("OverlayClusterState resumes from sparse functional snapshots "
                             "only (this one is dense, a materialized-mode checkpoint): "
                             "stale checkpoint? delete it to start over")
        exc = self._fn_load_common(arrays)
        rows = np.asarray(arrays["fault_fn_exc_rows"], dtype=np.int32)
        self._ov = {f: rows[i].copy() for i, f in enumerate(exc.tolist())}
        self._corrupt_bits = {}
        self._n_corrupt = 0
        if "fault_fn_corrupt_fid" in arrays:
            for f, s in zip(np.asarray(arrays["fault_fn_corrupt_fid"]).tolist(),
                            np.asarray(arrays["fault_fn_corrupt_slot"]).tolist()):
                self._corrupt_bits[int(f)] = self._corrupt_bits.get(int(f), 0) | (1 << int(s))
                self._n_corrupt += 1
        self._recompute_node_bytes()
        self._refresh_all()
        self.version += 1
