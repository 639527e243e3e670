"""Stateless hash placement on a flat topology: the flat branch of
``cdrs_tpu/placement_fn/compute.py``, host numpy, bit-identical to it.

The priority of node j for file f is a hash of (seed, file id, node
name), CRUSH's straw2 draw, so any subset of files places in O(subset)
with no per-file state, and a node's salt follows its name, not its
index.  Replica 0 is the file's primary node; every further replica is
the distinct node of best (lowest) priority.  Each packed priority holds
the node id in its low 6 bits under a 26-bit hash, so the minimum over
the node axis carries its winner and a file's values never tie; that
caps a topology at 63 nodes.

Failure-domain and hierarchical topologies (the rack-aware and
hierarchical fills, the region-locality clip) are not ported yet (ROADMAP
A8c): ``compute_placement`` raises for a topology with domains or levels.
``explain_placement`` waits for ROADMAP A10.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["node_salts", "file_keys", "hash_priorities", "compute_placement",
           "PRIO_MAX", "NODE_MASK", "MAX_NODES"]

_SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX_1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_2 = np.uint64(0x94D049BB133111EB)
_C1 = np.uint32(0xCC9E2D51)   # murmur3 mixing constants
_C2 = np.uint32(0x1B873593)
_M32 = np.uint32(0x85EBCA6B)
#: Low-bits node-id channel of a packed priority.
NODE_MASK = np.uint32(0x3F)
_PRIO_BITS_MASK = np.uint32(0xFFFFFFC0)
#: "Taken" priority: all ones (node id 63 is reserved, so no candidate equals it).
PRIO_MAX = np.uint32(0xFFFFFFFF)
MAX_NODES = 63


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 (wrapping by design)."""
    z = z + _SPLITMIX_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _MIX_1
    z = (z ^ (z >> np.uint64(27))) * _MIX_2
    return z ^ (z >> np.uint64(31))


def node_salts(nodes, seed: int = 0) -> np.ndarray:
    """(n_nodes,) uint32 salt per node: blake2b of the node's name mixed
    with the seed (stable across processes and platforms)."""
    if len(nodes) > MAX_NODES:
        raise ValueError(f"functional placement supports up to {MAX_NODES} nodes "
                         f"(6-bit packed node ids), got {len(nodes)}")
    seed_key = _splitmix64(np.asarray([np.uint64(seed & 0xFFFFFFFFFFFFFFFF)],
                                      dtype=np.uint64))[0]
    out = np.empty(len(nodes), dtype=np.uint64)
    for i, name in enumerate(nodes):
        h = hashlib.blake2b(str(name).encode(), digest_size=8).digest()
        out[i] = np.uint64(int.from_bytes(h, "little"))
    mixed = _splitmix64(out ^ seed_key)
    return (mixed ^ (mixed >> np.uint64(32))).astype(np.uint32)


def file_keys(file_ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """(m,) uint32 mixed per-file keys (two murmur3-style rounds over the
    low 32 bits of each id)."""
    x = np.asarray(file_ids).astype(np.uint32)
    x = x ^ np.uint32((seed * 2654435761) & 0xFFFFFFFF)
    x = x * _C1
    x = x ^ (x >> np.uint32(16))
    x = x * _C2
    return x ^ (x >> np.uint32(16))


def hash_priorities(keys: np.ndarray, salts: np.ndarray,
                    out: np.ndarray | None = None) -> np.ndarray:
    """(n_nodes, m) uint32 packed priorities ``(hash26 << 6) | node_id``,
    one contiguous row per node."""
    m = keys.shape[0]
    n = salts.shape[0]
    if out is None:
        out = np.empty((n, m), dtype=np.uint32)
    for j in range(n):
        row = out[j]
        np.bitwise_xor(keys, salts[j], out=row)
        np.multiply(row, _M32, out=row)
        np.bitwise_and(row, _PRIO_BITS_MASK, out=row)
        np.bitwise_or(row, np.uint32(j), out=row)
    return out


def compute_placement(file_ids: np.ndarray, n_shards: np.ndarray, primary: np.ndarray,
                      topology, seed: int = 0, *, out_width: int | None = None,
                      chunk: int = 1 << 17) -> tuple[np.ndarray, np.ndarray]:
    """Hash placement of an arbitrary subset of files on a flat topology.

    Returns ``(slots, rf)``: ``slots`` (m, width) int32 node ids, -1 past
    each row's rf; ``rf`` (m,) int32 = ``clip(n_shards, 1, n_nodes)``.
    ``primary`` is already mapped onto ``topology``
    (``cluster.placement.primary_on_topology``).  Row i depends only on
    (seed, file_ids[i], n_shards[i], primary[i], topology), and the slots
    nest in rf.  Files go in chunks of ``chunk`` with one reused priority
    block.
    """
    if getattr(topology, "domains", None) or getattr(topology, "n_levels", 0):
        raise ValueError("placement on a topology with failure domains or levels is not "
                         "ported yet (ROADMAP A8c, failure-domain topologies)")
    fids = np.asarray(file_ids)
    m_total = fids.shape[0]
    n_nodes = len(topology)
    salts = node_salts(topology.nodes, seed)
    rf = np.asarray(n_shards)
    if rf.dtype != np.int32:
        rf = rf.astype(np.int32)
    rf = np.clip(rf, 1, n_nodes)
    if rf.shape == ():
        rf = np.full(m_total, int(rf), dtype=np.int32)
    max_rf = int(rf.max()) if m_total else 1
    width = max_rf if out_width is None else int(out_width)
    # Every cell of [:, :max_rf] is written below (selection and rf padding).
    slots = np.empty((m_total, width), dtype=np.int32)
    if m_total == 0:
        return slots, rf
    primary_all = np.asarray(primary, dtype=np.int32)
    uniform_rf = bool((rf == max_rf).all())
    chunk = max(int(chunk), 1)
    work = np.empty((n_nodes, min(chunk, m_total)), dtype=np.uint32)
    all_cols = np.arange(work.shape[1])
    for lo in range(0, m_total, chunk):
        hi = min(lo + chunk, m_total)
        m = hi - lo
        w = work[:, :m]
        hash_priorities(file_keys(fids[lo:hi], seed), salts, out=w)
        prim = primary_all[lo:hi]
        cols = all_cols[:m]
        out = slots[lo:hi]
        out[:, 0] = prim
        w[prim, cols] = PRIO_MAX
        for c in range(1, max_rf):
            mn = np.minimum.reduce(w, axis=0)
            mn &= NODE_MASK
            s = mn.astype(np.int32)
            out[:, c] = s
            if c + 1 < max_rf:      # the last slot needs no masking
                w[s, cols] = PRIO_MAX
        if not uniform_rf:
            rfc = rf[lo:hi]
            for c in range(1, max_rf):
                np.copyto(out[:, c], np.int32(-1), where=rfc <= c)
        if width > max_rf:
            out[:, max_rf:] = -1
    return slots, rf
