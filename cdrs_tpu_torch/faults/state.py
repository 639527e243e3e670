"""Mutable cluster state: node liveness and the evolving replica map, the
port of the dense ``ClusterState`` of ``cdrs_tpu/faults/state.py``, host
numpy, bit-identical to it after the same sequence of events and moves.

``ClusterState`` takes one placement as its starting condition and becomes
what the fault schedule, the repair scheduler and the controller's
migrations mutate:

* per-node status: up/down, decommissioned (replicas destroyed),
  partitioned (up but unreachable), a flaky fail probability and a
  straggler throughput multiplier;
* the replica map, ``(n_files, n_nodes)`` int32 node ids, -1 = empty;
* durability tiers against the effective target ``min(rf, reachable
  nodes)``: lost (fewer live copies than ``min_live``), unreachable (live
  copies, none reachable), at risk (one reachable when more are wanted),
  under-replicated; and the correlated-risk overlay (two or more
  reachable copies all in one failure domain while another is reachable,
  per hierarchy level on a geo topology);
* silent corruption per slot (``slot_corrupt``): a rotten copy counts as
  live until a verified read quarantines it; ``integrity()`` reports the
  ground truth the blind tiers cannot see.

The per-file live/reachable counts and domain spreads are cached and
refreshed only for the rows a mutation touches.  ``state_arrays`` /
``load_state_arrays`` round-trip the whole state for checkpoints;
``placement_view`` renders the reachable replicas as a ``PlacementResult``
for ``cluster/evaluate.py``.

Storage strategies: a slot of file i holds ``shard_bytes[i]`` bytes, the
file is lost below ``min_live[i]`` live shards, ``ec_k[i] > 0`` marks an EC
stripe whose repair reads k shards (``repair_read_bytes``, ``copy_charge``
gated by the k-th fastest source), ``region_local[i]`` keeps its shards in
one top-level domain, and ``installed_shards[i]`` is the shard count repair
maintains.  The defaults are the replicate semantics.
``apply_strategy_target`` re-encodes a file between strategies, deferring
while it is unreadable (``strategy_mismatch`` lists the deferred ones).

Every policy method reads a file's slots through ``row``/``rows``, never
the dense map, so that ``placement_fn.state``'s overlay state (which holds
no dense map) shares them; ``grow`` appends elastic nodes (``_grow_common``
is its per-node half), ``retarget_row`` installs a whole computed row, ``pin_rows`` is the hook a
functional state pins rows in before its base moves, and ``prefetch_rows``
the one it computes a batch of rows in ahead of a per-file loop.
"""

from __future__ import annotations

import numpy as np

from ..cluster.placement import ClusterTopology, PlacementResult

__all__ = ["ClusterState"]


def _corrupt_roll(window: int, nid: int, fids: np.ndarray) -> np.ndarray:
    """Uniform [0, 1) per file for the seeded ``corrupt`` fraction:
    splitmix64 over (window, node, file), stateless, so a resumed run
    selects the same copies (uint64 arithmetic wraps by design)."""
    base = ((window + 1) * 0x9E3779B97F4A7C15
            + (nid + 1) * 0xC2B2AE3D27D4EB4F) & 0xFFFFFFFFFFFFFFFF
    z = np.asarray(fids, dtype=np.uint64) + np.uint64(base)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)


class ClusterState:
    """One controlled cluster's mutable placement and node status."""

    def __init__(self, placement: PlacementResult, size_bytes: np.ndarray):
        self._init_files(placement.topology, size_bytes, placement.rf)
        n, n_nodes = self.sizes.shape[0], len(self.nodes)
        rm = np.full((n, n_nodes), -1, dtype=np.int32)
        w = min(placement.replica_map.shape[1], n_nodes)
        rm[:, :w] = placement.replica_map[:, :w]
        self.replica_map = rm
        self.slot_corrupt = np.zeros((n, n_nodes), dtype=bool)
        self._n_corrupt = 0
        #: Bytes assigned per node (down replicas still occupy disk): the
        #: least-loaded preference of repair targets.
        self.node_bytes = np.zeros(n_nodes, dtype=np.int64)
        self._recompute_node_bytes()
        #: Bumped on every mutation.
        self.version = 0
        self._refresh_all()

    def _set_topology(self, topology: ClusterTopology) -> None:
        """Install ``topology`` and the per-node lookups derived from it."""
        self.topology = topology
        self.nodes: tuple[str, ...] = tuple(topology.nodes)
        self._node_idx = {nm: i for i, nm in enumerate(self.nodes)}
        self.domain_index = topology.domain_index()
        self.n_domains = topology.n_domains
        #: Top-level domain per node, None for one-level topologies.
        self._top_index = topology.top_domain_index() if topology.n_levels > 0 else None
        self._n_top = topology.n_domains_at(topology.n_levels) \
            if self._top_index is not None else 0
        #: Per-copy byte-cost multipliers of the hierarchy's edges (None: flat).
        self._byte_cost = topology.byte_cost_matrix() if topology.edge_bytes else None

    def _init_files(self, topology: ClusterTopology, size_bytes: np.ndarray, rf) -> None:
        """Everything but the per-file-by-node arrays: the topology, every
        node up and nominal, each file's strategy at the replicate defaults
        (a slot holds the whole file, one live copy keeps it, no EC stripe,
        no region pin) and its shard-count intent ``rf``."""
        self._set_topology(topology)
        n, n_nodes = np.asarray(rf).shape[0], len(self.nodes)
        self.sizes = np.asarray(size_bytes, dtype=np.int64)
        if self.sizes.shape != (n,):
            raise ValueError(f"size_bytes shape {self.sizes.shape} != ({n},)")
        self.min_live = np.ones(n, dtype=np.int32)
        self.shard_bytes = self.sizes.copy()
        self.ec_k = np.zeros(n, dtype=np.int32)
        self.region_local = np.zeros(n, dtype=bool)
        #: Shard-count intent repair maintains for each file.
        self.installed_shards = np.asarray(rf).astype(np.int32).copy()
        self.node_up = np.ones(n_nodes, dtype=bool)
        self.node_decommissioned = np.zeros(n_nodes, dtype=bool)
        self.node_partitioned = np.zeros(n_nodes, dtype=bool)
        self.node_fail_prob = np.zeros(n_nodes, dtype=np.float64)
        self.node_throughput = np.ones(n_nodes, dtype=np.float64)

    # -- cached per-file counts ----------------------------------------------
    def _refresh_all(self) -> None:
        live = self.live_mask()
        reach = self.reachable_mask()
        self._live_counts = live.sum(axis=1).astype(np.int32)
        self._reach_counts = reach.sum(axis=1).astype(np.int32)
        slot_dom = self.domain_index[np.clip(self.replica_map, 0, None)]
        spread = np.zeros(self.replica_map.shape[0], dtype=np.int32)
        for d in range(self.n_domains):
            spread += ((slot_dom == d) & reach).any(axis=1)
        self._dom_spread = spread
        if self._top_index is not None:
            top = self._top_index[np.clip(self.replica_map, 0, None)]
            tspread = np.zeros(self.replica_map.shape[0], dtype=np.int32)
            for d in range(self._n_top):
                tspread += ((top == d) & reach).any(axis=1)
            self._top_spread = tspread

    def _refresh_files(self, fids: np.ndarray) -> None:
        """Recompute the cached counts of the rows a mutation touched."""
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size == 0:
            return
        rows = self.rows(fids)
        safe = np.clip(rows, 0, None)
        assigned = rows >= 0
        self._live_counts[fids] = (assigned & self.node_up[safe]).sum(axis=1)
        rmask = assigned & self.node_reachable()[safe]
        self._reach_counts[fids] = rmask.sum(axis=1)
        dom = self.domain_index[safe]
        spread = np.zeros(fids.shape[0], dtype=np.int32)
        for d in range(self.n_domains):
            spread += ((dom == d) & rmask).any(axis=1)
        self._dom_spread[fids] = spread
        if self._top_index is not None:
            top = self._top_index[safe]
            tspread = np.zeros(fids.shape[0], dtype=np.int32)
            for d in range(self._n_top):
                tspread += ((top == d) & rmask).any(axis=1)
            self._top_spread[fids] = tspread

    def _refresh_one(self, fid: int) -> None:
        """``_refresh_files`` of one row, in Python over its slots: the
        per-copy mutations call it, where numpy's per-call overhead would
        dominate."""
        up = self.node_up.tolist()
        reach = self.node_reachable().tolist()
        dom = self.domain_index.tolist()
        top = None if self._top_index is None else self._top_index.tolist()
        live = n_reach = 0
        doms, tops = set(), set()
        for x in self.row(fid).tolist():
            if x < 0:
                continue
            live += up[x]
            if reach[x]:
                n_reach += 1
                doms.add(dom[x])
                if top is not None:
                    tops.add(top[x])
        self._live_counts[fid] = live
        self._reach_counts[fid] = n_reach
        self._dom_spread[fid] = len(doms)
        if top is not None:
            self._top_spread[fid] = len(tops)

    def _recompute_node_bytes(self) -> None:
        self.node_bytes = np.zeros(len(self.nodes), dtype=np.int64)
        assigned = self.replica_map >= 0
        np.add.at(self.node_bytes, self.replica_map[assigned],
                  np.broadcast_to(self.shard_bytes[:, None], self.replica_map.shape)[assigned])

    # -- storage strategies --------------------------------------------------
    def set_strategy_arrays(self, min_live: np.ndarray, shard_bytes: np.ndarray,
                            ec_k: np.ndarray) -> None:
        """Install per-file strategy arrays and re-derive the per-node bytes."""
        n = self.replica_map.shape[0]
        for name, a in (("min_live", min_live), ("shard_bytes", shard_bytes),
                        ("ec_k", ec_k)):
            if np.asarray(a).shape != (n,):
                raise ValueError(f"{name} shape {np.asarray(a).shape} != ({n},)")
        self.min_live = np.asarray(min_live, dtype=np.int32).copy()
        self.shard_bytes = np.asarray(shard_bytes, dtype=np.int64).copy()
        self.ec_k = np.asarray(ec_k, dtype=np.int32).copy()
        self._recompute_node_bytes()
        self.version += 1

    def set_file_strategy(self, fid: int, min_live: int, shard_bytes: int, ec_k: int,
                          region_local: bool = False) -> None:
        """Re-strategize one file; its assigned slots re-account at the new
        shard size."""
        old = int(self.shard_bytes[fid])
        new = int(shard_bytes)
        if new != old:
            row = self.row(fid)
            for node in row[row >= 0]:
                self.node_bytes[int(node)] += new - old
        self.min_live[fid] = int(min_live)
        self.shard_bytes[fid] = new
        self.ec_k[fid] = int(ec_k)
        self.region_local[fid] = bool(region_local)
        self.version += 1

    def apply_strategy_target(self, fid: int, min_live: int, shard_bytes: int, ec_k: int,
                              target: int, region_local: bool = False) -> int:
        """Move ``fid`` to a storage strategy and toward ``target`` shards.

        The same shape (min_live, shard_bytes, ec_k, region_local) is
        ``apply_rf_target``.  A new shape is a re-encode: it needs
        ``min_live`` reachable shards of the current form and ``min_live``
        of the new one's reachable nodes, else it defers (the file keeps
        its form; the controller retries each window).  A granted re-encode
        drops every old slot, then places the new shards one by one with
        ``pick_repair_target``.  Returns the shard-count delta."""
        same = (int(self.min_live[fid]) == int(min_live)
                and int(self.shard_bytes[fid]) == int(shard_bytes)
                and int(self.ec_k[fid]) == int(ec_k)
                and bool(self.region_local[fid]) == bool(region_local))
        if same:
            return self.apply_rf_target(fid, target)
        if int(self._reach_counts[fid]) < int(self.min_live[fid]) \
                or self.n_available < int(min_live):
            return 0
        row = self.row(fid)
        before = int((row >= 0).sum())
        for node in [int(x) for x in row[row >= 0]]:
            self.drop_replica(fid, node)
        self.set_file_strategy(fid, min_live, shard_bytes, ec_k, region_local)
        self.installed_shards[fid] = int(target)
        placed = 0
        goal = min(int(target), self.n_available)
        while placed < goal:
            node = self.pick_repair_target(fid)
            if node < 0:  # pragma: no cover - goal <= n_available
                break
            self.add_replica(fid, node)
            placed += 1
        return placed - before

    def strategy_mismatch(self, min_live: np.ndarray, shard_bytes: np.ndarray,
                          ec_k: np.ndarray, region_local: np.ndarray | None = None
                          ) -> np.ndarray:
        """File ids whose installed strategy differs from the wanted arrays
        (deferred conversions)."""
        mism = ((self.min_live != np.asarray(min_live, np.int32))
                | (self.shard_bytes != np.asarray(shard_bytes, np.int64))
                | (self.ec_k != np.asarray(ec_k, np.int32)))
        if region_local is not None:
            mism |= self.region_local != np.asarray(region_local, bool)
        return np.flatnonzero(mism)

    def repair_read_bytes(self, fid: int) -> int:
        """Bytes read to create one new copy of ``fid`` (k shards for an EC
        stripe, one copy otherwise)."""
        return int(self.shard_bytes[fid]) * max(int(self.ec_k[fid]), 1)

    # -- data integrity (silent corruption) ----------------------------------
    @property
    def has_corruption(self) -> bool:
        return self._n_corrupt > 0

    def corrupt_replica(self, fid: int, node: int) -> bool:
        """Silently rot ``fid``'s copy on ``node``; False when the slot is
        empty or already rotten."""
        slots = np.flatnonzero(self.replica_map[fid] == node)
        if slots.size == 0:
            return False
        s = int(slots[0])
        if self.slot_corrupt[fid, s]:
            return False
        self.slot_corrupt[fid, s] = True
        self._n_corrupt += 1
        self.version += 1
        return True

    def quarantine(self, fid: int, node: int) -> None:
        """Detected corruption: drop the copy (and its rot bit)."""
        self.drop_replica(fid, node)

    def verify_sources(self, fid: int) -> tuple[int, int]:
        """Quarantine every corrupt reachable copy of ``fid`` before a repair
        streams from it; ``(n_quarantined, charge_bytes)``, one verification
        read per rotten copy at its holder's throughput."""
        if not self._n_corrupt:
            return 0, 0
        row = self.row(fid)
        corr = self.slot_corrupt[fid]
        reach = self.node_reachable()
        found = 0
        charge = 0
        for s in np.flatnonzero((row >= 0) & corr):
            node = int(row[s])
            if not reach[node]:
                continue
            charge += int(np.ceil(int(self.shard_bytes[fid])
                                  / max(float(self.node_throughput[node]), 1e-9)))
            self.quarantine(fid, node)
            found += 1
        return found, charge

    def corrupt_row(self, fid: int) -> np.ndarray:
        return self.slot_corrupt[fid]

    def corrupt_at(self, fids: np.ndarray, slots: np.ndarray) -> np.ndarray:
        return self.slot_corrupt[np.asarray(fids), np.asarray(slots)]

    def corrupt_file_counts(self) -> np.ndarray:
        """(n,) int32 live corrupt copies per file (rot on a down holder
        is excluded while it is down)."""
        if not self._n_corrupt:
            return np.zeros(self.replica_map.shape[0], dtype=np.int32)
        return (self.live_mask() & self.slot_corrupt).sum(axis=1).astype(np.int32)

    def true_lost_mask(self) -> np.ndarray:
        """(n,) bool: fewer than ``min_live`` live clean copies."""
        if not self._n_corrupt:
            return self.lost_mask()
        clean = self.live_mask() & ~self.slot_corrupt
        return clean.sum(axis=1).astype(np.int32) < self.min_live

    def integrity(self) -> dict:
        """Corrupt copies in place, files carrying rot, and true losses."""
        cf = self.corrupt_file_counts()
        return {"corrupt_copies": int(cf.sum()), "files_corrupt": int((cf > 0).sum()),
                "true_lost": int(self.true_lost_mask().sum())}

    # -- row access ----------------------------------------------------------
    def row(self, fid: int) -> np.ndarray:
        """(n_nodes,) int32 slot row of one file (a live view)."""
        return self.replica_map[fid]

    def rows(self, fids: np.ndarray) -> np.ndarray:
        """(k, n_nodes) int32 slot rows of a file subset (read-only)."""
        return self.replica_map[fids]

    def assigned_counts(self) -> np.ndarray:
        """(n,) int64 assigned slots per file (up or down)."""
        return (self.replica_map >= 0).sum(axis=1).astype(np.int64)

    def copy_charge(self, fid: int, target: int) -> int:
        """Budget charge of a new copy of ``fid`` on ``target``: the read
        bytes over the best source's rate, the slower of (source, target)
        throughput divided by the edge's byte-cost multiplier (an EC
        rebuild is gated by its k-th best source)."""
        read_bytes = int(self.repair_read_bytes(fid))
        node_reach = self.node_reachable().tolist()
        thr = self.node_throughput.tolist()
        tgt = thr[target]
        cost = self._byte_cost
        rates = []
        for s in self.row(fid).tolist():
            if s < 0 or not node_reach[s]:
                continue
            r = min(thr[s], tgt)
            if cost is not None:
                r /= float(cost[s, target])
            rates.append(r)
        k = int(self.ec_k[fid])
        if k > 1 and rates:
            rates.sort(reverse=True)
            rate = rates[min(k, len(rates)) - 1]
        else:
            rate = max(rates, default=min(1.0, tgt))
        return int(np.ceil(read_bytes / max(rate, 1e-9)))

    # -- elastic capacity ----------------------------------------------------
    def _grow_common(self, topology) -> int:
        """The half of ``grow`` that holds no per-file array: check that the
        current nodes are a strict prefix of ``topology``, install it and
        extend every per-node array.  Returns the number of nodes added."""
        old_n = len(self.nodes)
        if tuple(topology.nodes[:old_n]) != self.nodes or len(topology.nodes) <= old_n:
            raise ValueError(f"grow needs the current node set as a strict prefix of the "
                             f"new topology (have {self.nodes}, got {tuple(topology.nodes)})")
        add = len(topology.nodes) - old_n
        self._set_topology(topology)
        self.node_up = np.concatenate([self.node_up, np.ones(add, bool)])
        self.node_decommissioned = np.concatenate([self.node_decommissioned,
                                                   np.zeros(add, bool)])
        self.node_partitioned = np.concatenate([self.node_partitioned, np.zeros(add, bool)])
        self.node_fail_prob = np.concatenate([self.node_fail_prob, np.zeros(add)])
        self.node_throughput = np.concatenate([self.node_throughput, np.ones(add)])
        self.node_bytes = np.concatenate([self.node_bytes, np.zeros(add, dtype=np.int64)])
        self.version += 1
        return add

    def grow(self, topology) -> None:
        """Install a grown topology (the current one with nodes appended):
        the map gains empty columns; every file's slots, counts and domain
        ids stay as they were."""
        add = self._grow_common(topology)
        n = self.replica_map.shape[0]
        self.replica_map = np.concatenate(
            [self.replica_map, np.full((n, add), -1, dtype=np.int32)], axis=1)
        self.slot_corrupt = np.concatenate([self.slot_corrupt, np.zeros((n, add), dtype=bool)],
                                           axis=1)

    def pin_rows(self, fids) -> None:
        """Hook before a change that moves a functional state's computed
        base: the dense state holds every row already."""

    def prefetch_rows(self, fids) -> None:
        """Hook before a per-file loop over ``fids`` (repairs, admitted
        moves): the dense state holds every row already."""

    def retarget_row(self, fid: int, new_row: np.ndarray) -> int:
        """Install a whole slot row for one file (an elastic rebalance
        move): node bytes follow the node-set delta, rot bits follow their
        surviving nodes.  Returns the bytes written (one shard per newly
        holding node)."""
        new_row = np.asarray(new_row, dtype=np.int32)
        old_row = self.row(fid).copy()
        old_nodes = {int(x) for x in old_row[old_row >= 0]}
        new_nodes = {int(x) for x in new_row[new_row >= 0]}
        sb = int(self.shard_bytes[fid])
        for v in old_nodes - new_nodes:
            self.node_bytes[v] -= sb
        for v in new_nodes - old_nodes:
            self.node_bytes[v] += sb
        corr = self.slot_corrupt[fid]
        if corr.any():
            new_corr = np.zeros_like(corr)
            slot_of = {int(v): int(s) for s, v in enumerate(new_row) if v >= 0}
            for s in np.flatnonzero(corr):
                v = int(old_row[s])
                if v in slot_of:
                    new_corr[slot_of[v]] = True
                else:
                    self._n_corrupt -= 1
            self.slot_corrupt[fid] = new_corr
        self.replica_map[fid] = new_row
        self._refresh_files(np.asarray([fid]))
        self.version += 1
        return sb * len(new_nodes - old_nodes)

    # -- node status ---------------------------------------------------------
    def _nid(self, node: str) -> int:
        try:
            return self._node_idx[node]
        except KeyError:
            raise ValueError(f"unknown node {node!r} (topology: {self.nodes})") from None

    #: Event kinds that change liveness or reachability.
    _COUNT_KINDS = ("crash", "recover", "decommission", "partition", "heal")

    def apply_event(self, ev) -> None:
        """Apply one ``FaultEvent``; a partition/heal group applies to every
        member at once.  Cached counts refresh for the files holding an
        affected node only."""
        affected: list[np.ndarray] = []
        for name in ev.node_list:
            i = self._nid(name)
            if ev.kind in self._COUNT_KINDS:
                affected.append(np.flatnonzero((self.replica_map == i).any(axis=1)))
            if ev.kind == "crash":
                self.node_up[i] = False
            elif ev.kind == "recover":
                if not self.node_decommissioned[i]:
                    self.node_up[i] = True
            elif ev.kind == "decommission":
                self.node_up[i] = False
                self.node_decommissioned[i] = True
                gone = self.replica_map == i
                self.node_bytes[i] = 0
                self.replica_map[gone] = -1
                self._n_corrupt -= int((gone & self.slot_corrupt).sum())
                self.slot_corrupt[gone] = False
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
                    if ev.file >= self.replica_map.shape[0]:
                        raise ValueError(f"corrupt event {ev.spec()!r} pins file {ev.file} "
                                         f"but the population has "
                                         f"{self.replica_map.shape[0]} files")
                    self.corrupt_replica(int(ev.file), i)
                else:
                    holds = np.flatnonzero((self.replica_map == i).any(axis=1))
                    roll = _corrupt_roll(ev.window, i, holds)
                    for f in holds[roll < float(ev.fail_prob)]:
                        self.corrupt_replica(int(f), i)
            else:  # pragma: no cover - FaultEvent validates kinds
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        if affected:
            self._refresh_files(np.unique(np.concatenate(affected)))
        self.version += 1

    def node_reachable(self) -> np.ndarray:
        """(n_nodes,) bool: up, not decommissioned, not partitioned."""
        return self.node_up & ~self.node_decommissioned & ~self.node_partitioned

    @property
    def n_available(self) -> int:
        return int(self.node_reachable().sum())

    @property
    def n_partitioned(self) -> int:
        return int(self.node_partitioned.sum())

    def domains_reachable(self) -> int:
        """Base failure domains with at least one reachable node."""
        return int(np.unique(self.domain_index[self.node_reachable()]).size)

    def domains_reachable_at(self, level: int) -> int:
        idx = self.topology.domain_index_at(level)
        return int(np.unique(idx[self.node_reachable()]).size)

    def spread_at(self, level: int, chunk: int = 1 << 20) -> np.ndarray:
        """(n,) int32 distinct level-``level`` domains holding a reachable
        copy of each file."""
        idx = self.topology.domain_index_at(level)
        n_dom = self.topology.n_domains_at(level)
        n = self.min_live.shape[0]
        node_reach = self.node_reachable()
        out = np.zeros(n, dtype=np.int32)
        for lo in range(0, n, int(chunk)):
            hi = min(lo + int(chunk), n)
            rows = self.rows(np.arange(lo, hi, dtype=np.int64))
            safe = np.clip(rows, 0, None)
            rmask = (rows >= 0) & node_reach[safe]
            dom = idx[safe]
            spread = np.zeros(hi - lo, dtype=np.int32)
            for d in range(n_dom):
                spread += ((dom == d) & rmask).any(axis=1)
            out[lo:hi] = spread
        return out

    # -- replica accounting --------------------------------------------------
    def live_mask(self) -> np.ndarray:
        """(n, n_nodes) bool: the slot's copy is on an up node."""
        rm = self.replica_map
        return (rm >= 0) & self.node_up[np.clip(rm, 0, None)]

    def reachable_mask(self) -> np.ndarray:
        """(n, n_nodes) bool: the slot's copy can serve (up, not partitioned)."""
        rm = self.replica_map
        return (rm >= 0) & self.node_reachable()[np.clip(rm, 0, None)]

    def live_counts(self) -> np.ndarray:
        return self._live_counts.copy()

    def reachable_counts(self) -> np.ndarray:
        return self._reach_counts.copy()

    def domain_spread(self) -> np.ndarray:
        return self._dom_spread.copy()

    def effective_target(self, target_rf: np.ndarray) -> np.ndarray:
        return np.minimum(np.asarray(target_rf, dtype=np.int64), self.n_available)

    def repair_needs(self, target_rf: np.ndarray):
        """(file ids, reachable counts, effective targets) of every file
        below its effective target."""
        reach = self.reachable_counts()
        eff = self.effective_target(target_rf)
        return np.flatnonzero(reach < eff), reach, eff

    def correlated_mask(self, target_rf: np.ndarray, *, reach: np.ndarray | None = None,
                        eff: np.ndarray | None = None) -> np.ndarray:
        """(n,) bool: two or more reachable copies, all in one failure domain
        (or, on a geo hierarchy, one top-level domain) while another is
        reachable and the target wants two or more."""
        n = self.min_live.shape[0]
        if reach is None:
            reach = self._reach_counts
        if eff is None:
            eff = self.effective_target(target_rf)
        out = np.zeros(n, dtype=bool)
        if self.n_domains >= 2 and self.domains_reachable() >= 2:
            out |= (reach >= 2) & (self._dom_spread == 1) & (eff >= 2)
        if self._top_index is not None and self._n_top >= 2 \
                and self.domains_reachable_at(self.topology.n_levels) >= 2:
            out |= (reach >= 2) & (self._top_spread == 1) & (eff >= 2) & ~self.region_local
        return out

    def durability(self, target_rf: np.ndarray, cat: np.ndarray, categories) -> dict:
        """Disjoint tiers (``lost``, ``unreachable``, ``at_risk``,
        ``under_replicated``), the ``correlated_risk`` overlay, node and
        domain counts, the tiers per category (-1 = "Unplanned") and, on a
        geo hierarchy, the correlated risk per level."""
        live = self._live_counts
        reach = self._reach_counts
        eff = self.effective_target(target_rf)
        need = self.min_live
        lost = live < need
        unreachable = (reach < need) & ~lost
        at_risk = (reach == need) & (eff > need)
        under = (reach > need) & (reach < eff)
        names = list(categories) + ["Unplanned"]
        bucket = np.where(np.asarray(cat) >= 0, cat, len(categories))
        per: dict[str, dict] = {}
        for mask, key in ((under, "under_replicated"), (at_risk, "at_risk"),
                          (unreachable, "unreachable"), (lost, "lost")):
            counts = np.bincount(bucket[mask], minlength=len(names))
            for ci, c in enumerate(counts):
                if c:
                    per.setdefault(names[ci], {})[key] = int(c)
        out = {
            "nodes_up": self.n_available,
            "nodes_partitioned": self.n_partitioned,
            "domains_reachable": self.domains_reachable(),
            "under_replicated": int(under.sum()),
            "at_risk": int(at_risk.sum()),
            "unreachable": int(unreachable.sum()),
            "lost": int(lost.sum()),
            "correlated_risk": int(self.correlated_mask(target_rf, reach=reach,
                                                        eff=eff).sum()),
            "per_category": per,
        }
        n_levels = self.topology.n_levels
        if n_levels > 0:
            out["regions_reachable"] = self.domains_reachable_at(n_levels)
            per_level: dict[str, int] = {}
            for lvl in range(1, n_levels + 1):
                name = self.topology.level_names[lvl]
                if self.domains_reachable_at(lvl) < 2:
                    per_level[name] = 0
                    continue
                spread = self._top_spread if lvl == n_levels else self.spread_at(lvl)
                mask = (reach >= 2) & (spread == 1) & (eff >= 2) & ~self.region_local
                per_level[name] = int(mask.sum())
            out["correlated_risk_levels"] = per_level
        return out

    def lost_mask(self) -> np.ndarray:
        return self.live_counts() < self.min_live

    def unreadable_mask(self) -> np.ndarray:
        """Files no read can be served for right now."""
        return self.reachable_counts() < self.min_live

    # -- mutation ------------------------------------------------------------
    def _file_domains(self, fid: int) -> set:
        """Base domains holding an assigned copy of ``fid`` (down holders
        count: their copy returns on recovery)."""
        dom = self.domain_index.tolist()
        return {dom[x] for x in self.row(fid).tolist() if x >= 0}

    def pick_repair_target(self, fid: int, rotate: int = 0,
                           new_domain_only: bool = False) -> int:
        """Target of a new copy of ``fid``: a reachable node without a copy
        (up or down), unoccupied domains first (on a geo hierarchy by
        (copies in its region, copies in its rack)), least-loaded next,
        then node id; ``rotate`` steps through the candidates (a retry
        after a flaky failure), ``new_domain_only`` keeps unoccupied
        domains only (the spread rebalance).  -1 when there is none."""
        # Python lists of the node arrays: a call touches a dozen nodes,
        # where numpy's per-element indexing would dominate.
        holding = {x for x in self.row(fid).tolist() if x >= 0}
        dom = self.domain_index.tolist()
        have_domains = self._file_domains(fid)
        reach = self.node_reachable().tolist()
        nbytes = self.node_bytes.tolist()
        avail = [i for i in range(len(reach)) if reach[i] and i not in holding]
        if self._top_index is not None:
            top = self._top_index.tolist()
            have_top = {top[x] for x in holding}
            if self.region_local[fid] and have_top:
                avail = [i for i in avail if top[i] in have_top]
        if new_domain_only:
            avail = [i for i in avail if dom[i] not in have_domains]
        if not avail:
            return -1
        if self._top_index is not None:
            top_cnt: dict[int, int] = {}
            base_cnt: dict[int, int] = {}
            for x in holding:
                top_cnt[top[x]] = top_cnt.get(top[x], 0) + 1
                base_cnt[dom[x]] = base_cnt.get(dom[x], 0) + 1
            avail.sort(key=lambda i: (top_cnt.get(top[i], 0), base_cnt.get(dom[i], 0),
                                      nbytes[i], i))
        else:
            avail.sort(key=lambda i: (dom[i] in have_domains, nbytes[i], i))
        return avail[int(rotate) % len(avail)]

    def add_replica(self, fid: int, node: int) -> None:
        row = self.replica_map[fid]
        free = np.flatnonzero(row < 0)
        if free.size == 0:  # pragma: no cover - width == n_nodes prevents this
            raise RuntimeError(f"file {fid} has no free replica slot")
        row[free[0]] = node
        if self.slot_corrupt[fid, free[0]]:  # pragma: no cover - drops clear the bit
            self.slot_corrupt[fid, free[0]] = False
            self._n_corrupt -= 1
        self.node_bytes[node] += self.shard_bytes[fid]
        self._refresh_one(fid)
        self.version += 1

    def drop_replica(self, fid: int, node: int) -> None:
        row = self.replica_map[fid]
        slots = np.flatnonzero(row == node)
        if slots.size:
            row[slots[0]] = -1
            if self.slot_corrupt[fid, slots[0]]:
                self.slot_corrupt[fid, slots[0]] = False
                self._n_corrupt -= 1
            self.node_bytes[node] -= self.shard_bytes[fid]
            self._refresh_one(fid)
            self.version += 1

    def _drop_order(self, fid: int, holders: list[int]) -> list[int]:
        """Holders most-droppable first: crowded regions, then crowded
        domains, then the most-loaded node."""
        dom_count: dict[int, int] = {}
        for h in holders:
            d = int(self.domain_index[h])
            dom_count[d] = dom_count.get(d, 0) + 1
        if self._top_index is not None:
            top_count: dict[int, int] = {}
            for h in holders:
                t = int(self._top_index[h])
                top_count[t] = top_count.get(t, 0) + 1
            return sorted(holders, key=lambda i: (-top_count[int(self._top_index[i])],
                                                  -dom_count[int(self.domain_index[i])],
                                                  -int(self.node_bytes[i]), i))
        return sorted(holders, key=lambda i: (-dom_count[int(self.domain_index[i])],
                                              -int(self.node_bytes[i]), i))

    def drop_crowded(self, fid: int) -> int:
        """Drop one reachable copy from the file's most crowded domain; the
        node dropped, or -1 with fewer than two reachable copies."""
        row = self.row(fid)
        reach = self.node_reachable()
        holders = [int(x) for x in row[row >= 0] if reach[int(x)]]
        if len(holders) < 2:
            return -1
        victim = self._drop_order(fid, holders)[0]
        self.drop_replica(fid, victim)
        return victim

    def apply_rf_target(self, fid: int, rf_new: int, record_intent: bool = True) -> int:
        """Bring ``fid`` toward ``rf_new`` reachable copies (capped at the
        reachable node count): adds go to ``pick_repair_target``; drops
        release copies on down nodes first, then reachable holders in
        ``_drop_order``; copies behind a partition are kept.  A file below
        ``min_live`` reachable copies has no source and is left alone.
        Returns the reachable delta."""
        if record_intent:
            self.installed_shards[fid] = int(rf_new)
        target = min(int(rf_new), self.n_available)
        live = int(self._reach_counts[fid])
        delta = 0
        if live < int(self.min_live[fid]):
            return 0
        while live < target:
            node = self.pick_repair_target(fid)
            if node < 0:
                break
            self.add_replica(fid, node)
            live += 1
            delta += 1
        if live > target:
            row = self.row(fid)
            for node in [int(x) for x in row[row >= 0] if not self.node_up[int(x)]]:
                self.drop_replica(fid, node)
        reach = self.node_reachable()
        while live > target:
            row = self.row(fid)
            holders = [int(x) for x in row[row >= 0] if reach[int(x)]]
            if not holders:  # pragma: no cover - live > target implies holders
                break
            self.drop_replica(fid, self._drop_order(fid, holders)[0])
            live -= 1
            delta -= 1
        return delta

    def trim_excess(self, target_rf: np.ndarray) -> int:
        """Drop reachable copies beyond the effective target (a recovered
        node or a healed partition resurfaces them); the trim records no new
        intent.  Returns files trimmed."""
        eff = self.effective_target(target_rf)
        over = np.flatnonzero(self._reach_counts > eff)
        for fid in over:
            self.apply_rf_target(int(fid), int(eff[fid]), record_intent=False)
        return int(over.size)

    # -- rendering -----------------------------------------------------------
    def placement_view(self) -> PlacementResult:
        """The reachable copies as a ``PlacementResult`` (reachable ids lead
        each row); files with none get rf 0."""
        rm = self.replica_map
        reach = (rm >= 0) & self.node_reachable()[np.clip(rm, 0, None)]
        masked = np.where(reach, rm, -1).astype(np.int32)
        order = np.argsort(~reach, axis=1, kind="stable")
        compact = np.take_along_axis(masked, order, axis=1)
        view = PlacementResult(replica_map=compact, rf=reach.sum(axis=1).astype(np.int32),
                               topology=self.topology)
        view.compute_storage(self.shard_bytes)
        return view

    # -- checkpoint ----------------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        """The whole state under the reference's ``fault_*`` names."""
        return {
            "fault_replica_map": self.replica_map.copy(),
            "fault_node_up": self.node_up.copy(),
            "fault_node_decommissioned": self.node_decommissioned.copy(),
            "fault_node_partitioned": self.node_partitioned.copy(),
            "fault_node_fail_prob": self.node_fail_prob.copy(),
            "fault_node_throughput": self.node_throughput.copy(),
            "fault_min_live": self.min_live.copy(),
            "fault_shard_bytes": self.shard_bytes.copy(),
            "fault_ec_k": self.ec_k.copy(),
            "fault_region_local": self.region_local.copy(),
            "fault_installed_shards": self.installed_shards.copy(),
            "fault_slot_corrupt": self.slot_corrupt.copy(),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        rm = np.asarray(arrays["fault_replica_map"], dtype=np.int32)
        if rm.shape != self.replica_map.shape:
            raise ValueError(f"checkpoint replica map shape {rm.shape} != "
                             f"{self.replica_map.shape}: stale checkpoint?")
        n_nodes = len(self.nodes)
        n = rm.shape[0]
        self.replica_map = rm.copy()
        self.node_up = np.asarray(arrays["fault_node_up"], dtype=bool).copy()
        self.node_decommissioned = np.asarray(arrays["fault_node_decommissioned"],
                                              dtype=bool).copy()
        self.node_partitioned = np.asarray(
            arrays.get("fault_node_partitioned", np.zeros(n_nodes, bool)), dtype=bool).copy()
        self.node_fail_prob = np.asarray(arrays["fault_node_fail_prob"],
                                         dtype=np.float64).copy()
        self.node_throughput = np.asarray(
            arrays.get("fault_node_throughput", np.ones(n_nodes)), dtype=np.float64).copy()
        self.min_live = np.asarray(arrays.get("fault_min_live", np.ones(n, np.int32)),
                                   dtype=np.int32).copy()
        self.shard_bytes = np.asarray(arrays.get("fault_shard_bytes", self.sizes),
                                      dtype=np.int64).copy()
        self.ec_k = np.asarray(arrays.get("fault_ec_k", np.zeros(n, np.int32)),
                               dtype=np.int32).copy()
        self.region_local = np.asarray(arrays.get("fault_region_local", np.zeros(n, bool)),
                                       dtype=bool).copy()
        self.installed_shards = np.asarray(
            arrays.get("fault_installed_shards",
                       np.maximum((rm >= 0).sum(axis=1), self.min_live)),
            dtype=np.int32).copy()
        self.slot_corrupt = np.asarray(
            arrays.get("fault_slot_corrupt", np.zeros(rm.shape, bool)), dtype=bool).copy()
        self._n_corrupt = int(self.slot_corrupt.sum())
        self._recompute_node_bytes()
        self._refresh_all()
        self.version += 1
