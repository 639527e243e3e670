"""Stateless hash placement: ``cdrs_tpu/placement_fn/compute.py``, host
numpy, bit-identical to it.

The priority of node j for file f is a hash of (seed, file id, node
name), CRUSH's straw2 draw, so any subset of files places in O(subset)
with no per-file state, and a node's salt follows its name, not its
index.  Replica 0 is the file's primary node.  On a topology with racks,
replica 1 is the best node outside the primary's rack and replica 2 the
second-best of that same rack (HDFS rack-aware); every further replica is
the distinct node of best (lowest) priority.  On a topology with
hierarchy levels, ``hierarchical_fill`` takes each slot by the key (copies
already in the candidate's top-level domain, copies in its rack, packed
priority), and a region-local file is clipped to its primary's region
(``clip_shards_for_locality``).  Each packed priority holds the node id in
its low 6 bits under a 26-bit hash, so the minimum over the node axis
carries its winner and a file's values never tie; that caps a topology at
63 nodes.  ``explain_placement`` narrates one file's slots scalar by
scalar and checks the narration against ``compute_placement``.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["node_salts", "file_keys", "hash_priorities", "compute_placement",
           "explain_placement", "hierarchical_fill", "clip_shards_for_locality", "PRIO_MAX", "NODE_MASK",
           "MAX_NODES"]

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


_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def clip_shards_for_locality(n_shards: np.ndarray, primary: np.ndarray, topology,
                             local_mask: np.ndarray | None) -> np.ndarray:
    """Shard counts under a region-locality mask: a file pinned to its
    primary's top-level domain holds at most that domain's node count.
    ``n_shards`` comes back untouched when no mask applies."""
    if local_mask is None or topology.n_levels == 0:
        return n_shards
    local = np.asarray(local_mask, dtype=bool)
    if not local.any():
        return n_shards
    top = topology.top_domain_index()
    region_size = np.bincount(top, minlength=topology.n_domains_at(topology.n_levels))
    cap = region_size[top[np.asarray(primary, dtype=np.int64)]]
    return np.where(local, np.minimum(n_shards, cap), n_shards).astype(np.int32)


def hierarchical_fill(w: np.ndarray, out: np.ndarray, prim: np.ndarray, max_rf: int,
                      topology) -> None:
    """Greedy highest-level-first fill of one chunk's slots 1..max_rf-1.

    ``w`` is the (n_nodes, m) packed priority block, mutated (taken nodes
    go to PRIO_MAX); slot 0 is already written to ``out`` and masked in
    ``w``.  Each slot takes the node of least key (copies already in its
    top-level domain, copies already in its base domain, packed priority),
    so region counts differ by at most one across a row.  The cluster
    package's rng chooser calls it with rng-packed priorities."""
    n_nodes, m = w.shape
    cols = np.arange(m)
    dom_base = topology.domain_index()
    dom_top = topology.top_domain_index()
    n_base = topology.n_domains
    n_top = topology.n_domains_at(topology.n_levels)
    base_rows = [np.flatnonzero(dom_base == d) for d in range(n_base)]
    top_of_base = np.asarray([int(dom_top[rows[0]]) for rows in base_rows], dtype=np.int64)
    base_cnt = np.zeros((n_base, m), dtype=np.uint16)
    top_cnt = np.zeros((n_top, m), dtype=np.uint16)
    base_cnt[dom_base[prim], cols] = 1
    top_cnt[dom_top[prim], cols] = 1
    dvb = np.empty((n_base, m), dtype=np.uint32)
    comp = np.empty((n_base, m), dtype=np.uint64)
    span = np.uint64(n_nodes + 2)
    for c in range(1, max_rf):
        for d, rows in enumerate(base_rows):
            np.copyto(dvb[d], w[rows[0]])
            for r in rows[1:]:
                np.minimum(dvb[d], w[r], out=dvb[d])
        # (top count * span + base count) above the packed priority: the
        # minimum over base domains carries the winning node's id.
        np.multiply(top_cnt[top_of_base].astype(np.uint64), span, out=comp)
        comp += base_cnt
        comp <<= np.uint64(32)
        comp |= dvb
        comp[dvb == PRIO_MAX] = _U64_MAX
        best = comp.min(axis=0)
        valid = best != _U64_MAX
        sel = (best.astype(np.uint32) & NODE_MASK).astype(np.int32)
        np.copyto(sel, np.int32(0), where=~valid)
        out[:, c] = np.where(valid, sel, -1)
        w[sel, cols] = np.where(valid, PRIO_MAX, w[sel, cols])
        np.add.at(base_cnt, (dom_base[sel], cols), valid.astype(np.uint16))
        np.add.at(top_cnt, (dom_top[sel], cols), valid.astype(np.uint16))


def compute_placement(file_ids: np.ndarray, n_shards: np.ndarray, primary: np.ndarray,
                      topology, seed: int = 0, *, salts: np.ndarray | None = None,
                      out_width: int | None = None, chunk: int = 1 << 17,
                      local_mask: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Hash placement of an arbitrary subset of files.

    Returns ``(slots, rf)``: ``slots`` (m, width) int32 node ids, -1 past
    each row's rf; ``rf`` (m,) int32 = ``clip(n_shards, 1, n_nodes)``
    (clipped to the region for region-local files).  ``primary`` is
    already mapped onto ``topology``
    (``cluster.placement.primary_on_topology``); ``salts`` are
    ``node_salts(topology.nodes, seed)``, computed when None.  Row i
    depends only on (seed, file_ids[i], n_shards[i], primary[i], topology),
    and the slots nest in rf: a row at rf r + 1 is the row at rf r with one
    node appended.  Files go in chunks of ``chunk`` with one reused
    priority block.
    """
    fids = np.asarray(file_ids)
    m_total = fids.shape[0]
    n_nodes = len(topology)
    if salts is None:
        salts = node_salts(topology.nodes, seed)
    rf = np.asarray(n_shards)
    if rf.dtype != np.int32:
        rf = rf.astype(np.int32)
    rf = np.clip(rf, 1, n_nodes)
    if rf.shape == ():
        rf = np.full(m_total, int(rf), dtype=np.int32)
    hier = getattr(topology, "n_levels", 0) > 0
    if hier and m_total:
        rf = clip_shards_for_locality(rf, primary, topology, local_mask)
    max_rf = int(rf.max()) if m_total else 1
    width = max_rf if out_width is None else int(out_width)
    # Every cell of [:, :max_rf] is written below (selection and rf padding).
    slots = np.empty((m_total, width), dtype=np.int32)
    if m_total == 0:
        return slots, rf
    primary_all = np.asarray(primary, dtype=np.int32)
    n_domains = topology.n_domains
    dom = topology.domain_index()
    # All-singleton domains (the flat topology) reduce exactly to the
    # generic ascending-priority fill.
    multi_domain = not hier and 1 < n_domains < n_nodes and max_rf >= 2
    dom_top = topology.top_domain_index() if hier else None
    local_all = np.asarray(local_mask, dtype=bool) if hier and local_mask is not None \
        else None
    uniform_rf = bool((rf == max_rf).all())
    chunk = max(int(chunk), 1)
    buf = min(chunk, m_total)
    work = np.empty((n_nodes, buf), dtype=np.uint32)
    dmin = dom_rows = None
    if multi_domain:
        dom_rows = [np.flatnonzero(dom == d) for d in range(n_domains)]
        dmin = np.empty((n_domains, buf), dtype=np.uint32)

    def _grouped_min(w, m):
        """dmin[d] = min over domain d's rows of ``w`` (the value carries the
        winning node's id)."""
        dv = dmin[:, :m]
        for d, rows in enumerate(dom_rows):
            np.copyto(dv[d], w[rows[0]])
            for r in rows[1:]:
                np.minimum(dv[d], w[r], out=dv[d])
        return dv

    all_cols = np.arange(buf)
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
        start_col = 1
        if hier:
            if local_all is not None:
                lc = local_all[lo:hi]
                if lc.any():
                    offr = dom_top[:, None] != dom_top[prim][None, :]
                    w[offr & lc[None, :]] = PRIO_MAX
            if max_rf >= 2:
                hierarchical_fill(w, out, prim, max_rf, topology)
            start_col = max_rf
        if multi_domain:
            # Replica 1: best node outside the primary's domain; replica 2:
            # that domain's second-best.  A file without such a node falls
            # back to the generic fill.
            dv = _grouped_min(w, m)
            best = dv.copy()
            best[dom[prim], cols] = PRIO_MAX
            mn1 = np.minimum.reduce(best, axis=0)
            has1 = mn1 != PRIO_MAX
            sel1 = (mn1 & NODE_MASK).astype(np.int32)
            if not has1.all():
                gen = (np.minimum.reduce(w, axis=0) & NODE_MASK).astype(np.int32)
                sel1 = np.where(has1, sel1, gen)
            out[:, 1] = sel1
            w[sel1, cols] = PRIO_MAX
            start_col = 2
            if max_rf >= 3:
                dv = _grouped_min(w, m)
                mn2 = dv[dom[sel1], cols]
                if not has1.all():
                    mn2 = np.where(has1, mn2, PRIO_MAX)
                has2 = mn2 != PRIO_MAX
                sel2 = (mn2 & NODE_MASK).astype(np.int32)
                if not has2.all():
                    gen = (np.minimum.reduce(w, axis=0) & NODE_MASK).astype(np.int32)
                    sel2 = np.where(has2, sel2, gen)
                out[:, 2] = sel2
                w[sel2, cols] = PRIO_MAX
                start_col = 3
        for c in range(start_col, max_rf):
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


def explain_placement(file_id: int, n_shards: int, primary: int, topology, seed: int = 0, *,
                      local: bool = False) -> dict:
    """Slot-by-slot trace of one file's computed placement.

    Re-derives the chooser's slots scalar by scalar (each candidate's hash
    priority, the domain-count keys of the hierarchical fill, the rule that
    took each slot), then checks that the narrated slots equal the file's
    :func:`compute_placement` row and raises if they do not.  ``primary``
    is already mapped onto ``topology``
    (``cluster.placement.primary_on_topology``).

    Returns ``{"file", "seed", "rf", "local", "slots"}``; a slot carries
    ``slot``, ``node``, ``node_name``, ``rule`` and, past slot 0, its
    ``candidates`` (``priority`` is the 26-bit hash channel; hierarchical
    slots add ``top_count`` and ``base_count`` and the winner's ``key``; a
    masked candidate says why).
    """
    fid = int(file_id)
    n_nodes = len(topology)
    prim = int(primary)
    salts = node_salts(topology.nodes, seed)
    w = hash_priorities(file_keys(np.asarray([fid]), seed), salts).reshape(n_nodes).copy()
    hier = topology.n_levels > 0
    rf_arr = np.clip(np.asarray([int(n_shards)], dtype=np.int32), 1, n_nodes)
    local_mask = np.asarray([bool(local)]) if hier else None
    if hier:
        rf_arr = clip_shards_for_locality(rf_arr, np.asarray([prim], dtype=np.int64),
                                          topology, local_mask)
    rf = int(rf_arr[0])
    dom = topology.domain_index()
    dom_top = topology.top_domain_index() if hier else None
    names = list(topology.nodes)
    base_names = list(topology.domains) if topology.domains else names
    masked_why = {}   # node -> why it is no longer a candidate

    def cand_rows(extra=None):
        rows = []
        for j in range(n_nodes):
            row = {"node": j, "name": str(names[j]), "domain": str(base_names[j])}
            if w[j] == PRIO_MAX:
                row["masked"] = masked_why.get(j, "taken")
            else:
                row["priority"] = int(w[j] >> np.uint32(6))
            if extra is not None:
                row.update(extra(j))
            rows.append(row)
        return rows

    def take(c, sel, rule, cands, **extra):
        slots.append({"slot": c, "node": int(sel), "node_name": str(names[sel]),
                      "rule": rule, **extra, "candidates": cands})
        w[sel] = PRIO_MAX
        masked_why[sel] = f"taken (slot {c})"

    def best(cands_idx):
        return min(cands_idx, key=lambda j: int(w[j]))

    slots: list[dict] = [{"slot": 0, "node": prim, "node_name": str(names[prim]),
                          "rule": "primary"}]
    w[prim] = PRIO_MAX
    masked_why[prim] = "primary (slot 0)"

    if hier:
        # The scalar form of ``hierarchical_fill``: each slot takes the
        # candidate of least (copies in its top-level domain, copies in its
        # base domain, packed priority); a region-local file first loses
        # every off-region candidate.
        if local:
            for j in range(n_nodes):
                if dom_top[j] != dom_top[prim] and w[j] != PRIO_MAX:
                    w[j] = PRIO_MAX
                    masked_why[j] = "off-region (locality pin)"
        base_cnt = np.zeros(topology.n_domains, dtype=np.int64)
        top_cnt = np.zeros(topology.n_domains_at(topology.n_levels), dtype=np.int64)
        base_cnt[dom[prim]] += 1
        top_cnt[dom_top[prim]] += 1

        def key_of(j):
            return {"top_count": int(top_cnt[dom_top[j]]), "base_count": int(base_cnt[dom[j]])}

        for c in range(1, rf):
            cands = cand_rows(key_of)
            live = [j for j in range(n_nodes) if w[j] != PRIO_MAX]
            if not live:
                slots.append({"slot": c, "node": -1, "node_name": None, "rule": "exhausted",
                              "candidates": cands})
                continue
            sel = min(live, key=lambda j: (int(top_cnt[dom_top[j]]), int(base_cnt[dom[j]]),
                                           int(w[j])))
            key = {**key_of(sel), "priority": int(w[sel] >> np.uint32(6))}
            take(c, sel, "hierarchical_fill (least-covered region, then rack, then best "
                 "priority)", cands, key=key)
            base_cnt[dom[sel]] += 1
            top_cnt[dom_top[sel]] += 1
    else:
        multi_domain = 1 < topology.n_domains < n_nodes and rf >= 2
        start_col = 1
        if multi_domain:
            # Rack-aware: replica 1 is the best node outside the primary's
            # domain, replica 2 that domain's second-best (each falling back
            # to the best remaining node).
            dp = int(dom[prim])
            cands = cand_rows()
            remote = [j for j in range(n_nodes) if w[j] != PRIO_MAX and dom[j] != dp]
            has1 = bool(remote)
            if has1:
                sel1, rule1 = best(remote), "best node of a remote domain (off-rack)"
            else:
                sel1 = best([j for j in range(n_nodes) if w[j] != PRIO_MAX])
                rule1 = "best remaining node (no remote domain)"
            take(1, sel1, rule1, cands)
            start_col = 2
            if rf >= 3:
                cands = cand_rows()
                second = [j for j in range(n_nodes)
                          if w[j] != PRIO_MAX and has1 and dom[j] == dom[sel1]]
                if second:
                    sel2, rule2 = best(second), "second-best node of the remote domain"
                else:
                    sel2 = best([j for j in range(n_nodes) if w[j] != PRIO_MAX])
                    rule2 = "best remaining node (remote domain has no second member)"
                take(2, sel2, rule2, cands)
                start_col = 3
        for c in range(start_col, rf):
            cands = cand_rows()
            take(c, best([j for j in range(n_nodes) if w[j] != PRIO_MAX]),
                 "ascending hash priority", cands)

    truth, truth_rf = compute_placement(
        np.asarray([fid], dtype=np.int64), np.asarray([int(n_shards)], dtype=np.int32),
        np.asarray([prim], dtype=np.int64), topology, seed, local_mask=local_mask)
    told = [s["node"] for s in slots]
    want = [int(x) for x in truth[0, :int(truth_rf[0])]]
    if told != want or rf != int(truth_rf[0]):
        raise RuntimeError(
            f"explain_placement narration diverged from compute_placement for file {fid}: "
            f"narrated {told}, computed {want}")
    return {"file": fid, "seed": int(seed), "rf": rf, "local": bool(local), "slots": slots}
