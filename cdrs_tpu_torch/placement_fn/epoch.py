"""Cluster-map epochs and the epoch diff: ``cdrs_tpu/placement_fn/epoch.py``,
host numpy, bit-identical to it.

An ``EpochMap`` keeps the history of topologies; ``placement`` computes
the hash placement of any subset of files under one epoch, resolving the
manifest's primaries onto that epoch's topology by node name.  ``diff``
plans a topology change by hashing twice and comparing each file's node
set.  Node salts follow node names, so an unchanged topology diffs to zero
moves, and a pure removal (survivors keep their names, domains and order)
prunes to the files whose old slots held a removed node (or whose rf the
smaller node count re-caps): nobody else's priorities changed.
``addition_moved`` is the additive twin for elastic scale-out: with nodes
appended, a file moves exactly when its new slots touch an added node.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cluster.placement import primary_on_topology
from .compute import compute_placement, node_salts

__all__ = ["Epoch", "EpochDiff", "EpochMap", "addition_moved"]


def addition_moved(topo_old, topo_new, n_shards: np.ndarray, primary: np.ndarray,
                   seed: int = 0, *, chunk: int = 1 << 20,
                   local_mask: np.ndarray | None = None) -> np.ndarray:
    """Sorted int64 ids of the files whose placement changes when
    ``topo_new`` is ``topo_old`` with nodes appended (names, domains,
    levels and order of the old nodes kept): those whose new slots hold an
    added node.  ``primary`` is already resolved onto the shared node ids."""
    old_n = len(topo_old.nodes)
    prefix_ok = (
        tuple(topo_new.nodes[:old_n]) == tuple(topo_old.nodes)
        and len(topo_new.nodes) > old_n
        and tuple(topo_new.domains[:old_n] if topo_new.domains else ())
        == tuple(topo_old.domains)
        and len(topo_old.levels) == len(topo_new.levels)
        and all(a[0] == b[0] and tuple(b[1][:old_n]) == tuple(a[1])
                for a, b in zip(topo_old.levels, topo_new.levels)))
    if not prefix_ok:
        raise ValueError("addition_moved needs the new topology to be the old one with nodes "
                         "appended (names, domains, levels and order of survivors kept); "
                         "anything else is a general epoch diff (EpochMap.diff)")
    shards = np.asarray(n_shards)
    n = int(shards.shape[0])
    prim = np.asarray(primary)
    salts = node_salts(topo_new.nodes, seed)
    moved_parts: list[np.ndarray] = []
    for lo in range(0, n, int(chunk)):
        hi = min(lo + int(chunk), n)
        fids = np.arange(lo, hi, dtype=np.int64)
        slots, _ = compute_placement(
            fids, shards[lo:hi], prim[lo:hi], topo_new, seed, salts=salts,
            local_mask=None if local_mask is None else local_mask[lo:hi])
        hit = (slots >= old_n).any(axis=1)
        if hit.any():
            moved_parts.append(fids[hit])
    if not moved_parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(moved_parts)


@dataclass(frozen=True)
class Epoch:
    """One immutable cluster-map revision."""

    epoch_id: int
    topology: object            # cluster.placement.ClusterTopology


@dataclass
class EpochDiff:
    """Files whose computed placement moved between two epochs."""

    moved: np.ndarray           # (k,) int64 file ids that must migrate
    old_slots: np.ndarray       # (k, w) int32 placement under the old epoch
    new_slots: np.ndarray       # (k, w) int32 placement under the new epoch
    n_checked: int              # files the diff resolved
    pruned: bool                # the removal fast path applied

    def __len__(self) -> int:
        return int(self.moved.shape[0])


def _node_bitmask(slots: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """(m,) uint64 bitmask of each row's node set in a global id space of at
    most 64 nodes (a migration moves bytes between nodes; slot order does
    not matter)."""
    out = np.zeros(slots.shape[0], dtype=np.uint64)
    for c in range(slots.shape[1]):
        col = slots[:, c]
        assigned = col >= 0
        out[assigned] |= np.uint64(1) << gids[col[assigned]].astype(np.uint64)
    return out


class EpochMap:
    """The cluster's topology history and the epoch diff.  ``vocab`` is the
    node-name vocabulary that the manifest's ``primary_node_id`` indexes;
    each epoch resolves primaries onto its own topology by name, so a
    removed primary re-homes by the stable crc32 spread."""

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

    def diff(self, old_id: int, new_id: int, n_shards: np.ndarray,
             primary_node_id: np.ndarray, *, chunk: int = 1 << 20,
             prune: bool = True) -> EpochDiff:
        """The migrations between two epochs: hash both, compare node sets.

        ``n_shards``/``primary_node_id`` cover the whole population; files go
        in chunks of ``chunk``.  With ``prune`` a pure removal re-places only
        the old holders of removed nodes and the files whose rf the smaller
        node count re-caps: each of them must move and no other can."""
        shards = np.asarray(n_shards)
        n = int(shards.shape[0])
        topo_old, topo_new = self.topology(old_id), self.topology(new_id)
        names_old, names_new = set(topo_old.nodes), set(topo_new.nodes)
        if old_id == new_id or (tuple(topo_old.nodes) == tuple(topo_new.nodes)
                                and tuple(topo_old.domains) == tuple(topo_new.domains)
                                and tuple(topo_old.levels) == tuple(topo_new.levels)):
            empty = np.zeros((0, 0), dtype=np.int32)
            return EpochDiff(np.zeros(0, dtype=np.int64), empty, empty, n_checked=0,
                             pruned=True)

        # One global node-id space over both epochs (old order, then additions).
        union = list(topo_old.nodes) + [x for x in topo_new.nodes if x not in names_old]
        if len(union) > 64:
            raise ValueError(f"epoch diff supports up to 64 distinct nodes across the two "
                             f"epochs, got {len(union)}")
        gid_old = np.asarray([union.index(x) for x in topo_old.nodes], dtype=np.int64)
        gid_new = np.asarray([union.index(x) for x in topo_new.nodes], dtype=np.int64)

        # A pure removal keeps every survivor's name, domains and relative
        # order (packed priorities break a 26-bit tie by node index).
        dom_old = dict(zip(topo_old.nodes, topo_old.domains or topo_old.nodes))
        dom_new = dict(zip(topo_new.nodes, topo_new.domains or topo_new.nodes))
        lvl_old = {nd: tuple(d[i] for _, d in topo_old.levels)
                   for i, nd in enumerate(topo_old.nodes)}
        lvl_new = {nd: tuple(d[i] for _, d in topo_new.levels)
                   for i, nd in enumerate(topo_new.nodes)}
        removal_only = (names_new <= names_old
                        and [x for x in topo_old.nodes if x in names_new] == list(topo_new.nodes)
                        and all(dom_new[nd] == dom_old[nd] for nd in topo_new.nodes)
                        and len(topo_old.levels) == len(topo_new.levels)
                        and all(lvl_new[nd] == lvl_old[nd] for nd in topo_new.nodes))
        use_prune = bool(prune and removal_only and names_old - names_new)

        prim = np.asarray(primary_node_id)
        width = int(min(int(shards.max()) if n else 1, max(len(topo_old), len(topo_new))))
        moved_parts: list[np.ndarray] = []
        old_parts: list[np.ndarray] = []
        new_parts: list[np.ndarray] = []
        n_checked = 0
        salts_old = node_salts(topo_old.nodes, self.seed)
        salts_new = node_salts(topo_new.nodes, self.seed)
        vocab_ids = np.arange(len(self.vocab))
        prim_lut_old = primary_on_topology(self.vocab, vocab_ids, topo_old)
        prim_lut_new = primary_on_topology(self.vocab, vocab_ids, topo_new)
        recap = len(topo_new) < len(topo_old)
        removed_old_idx = np.asarray(
            [list(topo_old.nodes).index(x) for x in names_old - names_new], dtype=np.int32)
        for lo in range(0, n, int(chunk)):
            hi = min(lo + int(chunk), n)
            fids = np.arange(lo, hi, dtype=np.int64)
            sh = shards[lo:hi]
            old_slots, _ = compute_placement(fids, sh, prim_lut_old[prim[lo:hi]], topo_old,
                                             self.seed, salts=salts_old, out_width=width)
            if use_prune:
                # Candidacy is the moved set: no bitmask compare.
                cand = np.zeros(hi - lo, dtype=bool)
                for ri in removed_old_idx:
                    cand |= (old_slots == ri).any(axis=1)
                if recap:
                    cand |= sh > len(topo_new)
                idx = np.flatnonzero(cand)
                n_checked += int(idx.size)
                if idx.size == 0:
                    continue
                fids_c = fids[idx]
                new_slots, _ = compute_placement(fids_c, sh[idx], prim_lut_new[prim[fids_c]],
                                                 topo_new, self.seed, salts=salts_new,
                                                 out_width=width)
                moved_parts.append(fids_c)
                old_parts.append(old_slots[idx])
                new_parts.append(new_slots)
            else:
                new_slots, _ = compute_placement(fids, sh, prim_lut_new[prim[lo:hi]], topo_new,
                                                 self.seed, salts=salts_new, out_width=width)
                moved_loc = np.flatnonzero(_node_bitmask(old_slots, gid_old)
                                           != _node_bitmask(new_slots, gid_new))
                n_checked += hi - lo
                if moved_loc.size:
                    moved_parts.append(fids[moved_loc])
                    old_parts.append(old_slots[moved_loc])
                    new_parts.append(new_slots[moved_loc])
        if moved_parts:
            return EpochDiff(np.concatenate(moved_parts), np.concatenate(old_parts),
                             np.concatenate(new_parts), n_checked=n_checked, pruned=use_prune)
        empty = np.zeros((0, width), dtype=np.int32)
        return EpochDiff(np.zeros(0, dtype=np.int64), empty, empty, n_checked=n_checked,
                         pruned=use_prune)
