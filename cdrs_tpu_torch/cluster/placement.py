"""Replica placement over simulated datanodes with failure domains: the port
of ``cdrs_tpu/cluster/placement.py`` (and ``primary_on_topology`` of
``cdrs_tpu/placement_fn/compute.py``), host numpy, bit-identical to it for
the same seed.

Replica 0 is the file's primary node.  With failure domains (racks),
replica 1 is the best-priority node of a seeded-random remote domain and
replica 2 the second-best node of that same domain (HDFS rack-aware
placement); every further replica is a distinct node in seeded random
priority order.  A flat topology makes every node its own domain, and the
policy reduces to the distinct-node random chooser.  A topology with
hierarchy ``levels`` (racks inside regions) fills the slots greedily,
least-covered region first, then least-covered rack, then best priority
(``placement_fn.compute.hierarchical_fill``); there a region-local file
(``local_mask``) stays in its primary's region.  The rf is capped at the
node count, with a one-time warning (and every time the
``placement.rf_capped`` counter of the active instrument).  ``place_stripes`` places the shards
of storage strategies the same way, accounting a slot at its shard size.

``ClusterTopology`` parses the CLI's rack spec (``from_rack_spec``) and
the ``--topology`` JSON hierarchy (``from_hierarchy``, with optional
``edge_bytes``/``edge_latency`` multipliers per boundary class), and
renders it back (``to_hierarchy_dict``).  ``method="hash"`` draws the same
policy's priorities from the stateless per-(file, node name) hash of
``placement_fn.compute.compute_placement`` instead of a seeded rng matrix:
the materialized twin of the functional chooser.
"""

from __future__ import annotations

import warnings
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..io.events import Manifest
from ..obs import current

__all__ = ["ClusterTopology", "PlacementResult", "place_replicas", "place_stripes",
           "primary_on_topology", "reset_rf_cap_warning"]


class _OnceWarning:
    """A one-shot warning latch that tests can re-arm."""

    def __init__(self) -> None:
        self.fired = False

    def reset(self) -> None:
        self.fired = False

    def warn(self, message: str) -> None:
        if not self.fired:
            self.fired = True
            warnings.warn(message, stacklevel=3)


_RF_CAP_WARNING = _OnceWarning()


def reset_rf_cap_warning() -> None:
    """Re-arm the one-shot rf-cap warning."""
    _RF_CAP_WARNING.reset()


@dataclass
class ClusterTopology:
    """Datanodes with failure domains.

    ``domains`` names each node's base failure domain (empty: every node is
    its own domain).  ``levels`` stacks coarser domains on top, finest
    first, each ``(level_name, per-node domain names)`` and each a strict
    coarsening of the level below.  ``edge_bytes``/``edge_latency`` hold one
    multiplier per boundary class (off-rack, off-region, ...); empty means
    all 1.0."""

    nodes: tuple[str, ...] = ("dn1", "dn2", "dn3")
    domains: tuple[str, ...] = ()
    levels: tuple = ()
    edge_bytes: tuple = ()
    edge_latency: tuple = ()
    #: Name of the base ``domains`` level; fault scopes such as
    #: ``crash:rack:r0`` resolve level names against it and ``levels``.
    domain_level_name: str = "rack"

    def __post_init__(self):
        self.nodes = tuple(self.nodes)
        self.domains = tuple(self.domains)
        if not self.nodes:
            raise ValueError("topology needs at least one node")
        if len(set(self.nodes)) != len(self.nodes):
            dupes = sorted({n for n in self.nodes if self.nodes.count(n) > 1})
            raise ValueError(f"duplicate node names in topology: {dupes}; every node "
                             "must be unique")
        if self.domains and len(self.domains) != len(self.nodes):
            raise ValueError(f"domains has {len(self.domains)} entries for "
                             f"{len(self.nodes)} nodes; must be parallel to nodes")
        self.levels = tuple((str(nm), tuple(str(d) for d in doms)) for nm, doms in self.levels)
        if self.levels and not self.domains:
            raise ValueError("hierarchy levels require a base domains level (the finest "
                             "failure domain): give every node a domain")
        for nm, doms in self.levels:
            if len(doms) != len(self.nodes):
                raise ValueError(f"hierarchy level {nm!r} has {len(doms)} entries for "
                                 f"{len(self.nodes)} nodes; must be parallel to nodes")
        # Strict coarsening: nodes sharing a domain share it on every level above.
        below_name = self.domain_level_name or "domain"
        below = self.domains
        for nm, doms in self.levels:
            owner: dict[str, tuple[str, str]] = {}
            for node, lo, hi in zip(self.nodes, below, doms):
                if lo in owner and owner[lo][0] != hi:
                    raise ValueError(
                        f"hierarchy level {nm!r}: {below_name} {lo!r} spans {hi!r} "
                        f"(node {node!r}) and {owner[lo][0]!r} (node {owner[lo][1]!r}); "
                        f"each {below_name} must nest inside exactly one {nm}")
                owner.setdefault(lo, (hi, node))
            below_name, below = nm, doms
        self._level_names = (self.domain_level_name or "rack",) + tuple(
            nm for nm, _ in self.levels)
        for label, edges in (("edge_bytes", self.edge_bytes),
                             ("edge_latency", self.edge_latency)):
            edges = tuple(float(x) for x in edges)
            setattr(self, label, edges)
            if edges and len(edges) != self.n_levels + 1:
                raise ValueError(
                    f"{label} has {len(edges)} entries for {self.n_levels + 1} boundary "
                    f"classes ({self._class_names()}); one multiplier per class")
            if any(x < 1.0 for x in edges):
                raise ValueError(f"{label} multipliers must be >= 1.0 (crossing a boundary "
                                 f"is never cheaper than staying inside), got {edges}")
        # One names tuple and one int32 index array per level, base first.
        self._dom_names: list[tuple[str, ...]] = []
        self._dom_index: list[np.ndarray] = []
        for doms in (self.domains if self.domains else self.nodes,
                     *(d for _, d in self.levels)):
            names = tuple(dict.fromkeys(doms))
            idx = {d: i for i, d in enumerate(names)}
            self._dom_names.append(names)
            self._dom_index.append(np.asarray([idx[d] for d in doms], dtype=np.int32))

    def __len__(self) -> int:
        return len(self.nodes)

    # -- hierarchy accessors (level 0 = base domains) -----------------------
    @property
    def n_levels(self) -> int:
        """Hierarchy levels above the base domain."""
        return len(self.levels)

    @property
    def level_names(self) -> tuple[str, ...]:
        """Level names, base first."""
        return self._level_names

    def domain_names_at(self, level: int) -> tuple[str, ...]:
        """Distinct domain names of one level, first-appearance order."""
        return self._dom_names[level]

    def domain_index_at(self, level: int) -> np.ndarray:
        """(n_nodes,) int32 domain ids at ``level`` (cached; read-only)."""
        return self._dom_index[level]

    def n_domains_at(self, level: int) -> int:
        return len(self._dom_names[level])

    def top_domain_index(self) -> np.ndarray:
        """(n_nodes,) int32 ids at the coarsest level."""
        return self._dom_index[self.n_levels]

    def nodes_in(self, level_name: str, domain: str) -> tuple[str, ...]:
        """Node names inside one named domain of one named level."""
        if level_name not in self._level_names:
            raise ValueError(f"unknown hierarchy level {level_name!r} (this topology has "
                             f"{self._level_names})")
        lvl = self._level_names.index(level_name)
        if domain not in self._dom_names[lvl]:
            raise ValueError(f"level {level_name!r} has no domain {domain!r} "
                             f"(have {self._dom_names[lvl]})")
        want = self._dom_names[lvl].index(domain)
        return tuple(n for n, d in zip(self.nodes, self._dom_index[lvl]) if d == want)

    def _class_names(self) -> tuple[str, ...]:
        return tuple(f"off-{nm}" for nm in self._level_names)

    def separation(self) -> np.ndarray:
        """(n_nodes, n_nodes) int8 boundary class between node pairs: 0 = same
        base domain, c >= 1 = the pair first shares a domain at level c
        (n_levels + 1: different top-level domains)."""
        n = len(self.nodes)
        sep = np.zeros((n, n), dtype=np.int8)
        for lvl in range(self.n_levels + 1):
            idx = self._dom_index[lvl]
            sep[idx[:, None] != idx[None, :]] = lvl + 1
        return sep

    def byte_cost_matrix(self) -> np.ndarray:
        """(n_nodes, n_nodes) float64 per-copy byte-cost multiplier."""
        return self._edge_matrix(self.edge_bytes)

    def latency_matrix(self) -> np.ndarray:
        """(n_nodes, n_nodes) float64 read-latency multiplier."""
        return self._edge_matrix(self.edge_latency)

    def _edge_matrix(self, edges: tuple) -> np.ndarray:
        n = len(self.nodes)
        if not edges:
            return np.ones((n, n), dtype=np.float64)
        mult = np.asarray((1.0,) + tuple(edges), dtype=np.float64)
        return mult[self.separation()]

    @property
    def domain_names(self) -> tuple[str, ...]:
        """Distinct base-domain names in first-appearance order."""
        return self._dom_names[0]

    @property
    def n_domains(self) -> int:
        return len(self._dom_names[0])

    def domain_index(self) -> np.ndarray:
        """(n_nodes,) int32 base-domain id of each node (cached; read-only)."""
        return self._dom_index[0]

    @classmethod
    def from_racks(cls, nodes, racks: dict) -> "ClusterTopology":
        """Topology from a ``node -> domain`` mapping; unmapped nodes are
        their own domain."""
        nodes = tuple(nodes)
        unknown = sorted(set(racks) - set(nodes))
        if unknown:
            raise ValueError(f"rack map names nodes outside the topology {nodes}: {unknown}")
        return cls(nodes, tuple(str(racks.get(n, n)) for n in nodes))

    @classmethod
    def from_rack_spec(cls, nodes, spec: str) -> "ClusterTopology":
        """Topology from a CLI rack spec: ``;``-separated groups, each
        ``name=n1,n2`` or bare ``n1,n2`` (named rack0, rack1, ...)."""
        racks: dict[str, str] = {}
        seen_names: set[str] = set()
        for i, group in enumerate(g for g in spec.split(";") if g.strip()):
            if "=" in group:
                name, members = group.split("=", 1)
                name = name.strip()
            else:
                name, members = f"rack{i}", group
            if name in seen_names:
                raise ValueError(f"duplicate rack name {name!r} in spec {spec!r} "
                                 "(auto-named bare groups use rack0, rack1, ...)")
            seen_names.add(name)
            for m in members.split(","):
                m = m.strip()
                if not m:
                    continue
                if m in racks:
                    raise ValueError(f"node {m!r} appears in two rack groups ({racks[m]!r} "
                                     f"and {name!r}) in spec {spec!r}")
                racks[m] = name
        if not racks:
            raise ValueError(f"rack spec {spec!r} names no nodes")
        return cls.from_racks(nodes, racks)

    @classmethod
    def from_hierarchy(cls, spec: dict) -> "ClusterTopology":
        """Topology from the ``--topology`` JSON spec::

            {"nodes": ["dn1", ...], "levels": ["rack", "region"],
             "rack": {"r0": ["dn1", "dn2"], ...},   # groups nodes
             "region": {"eu": ["r0", "r1"], ...},   # groups racks
             "edge_bytes": {"rack": 1.0, "region": 4.0},      # optional
             "edge_latency": {"rack": 2.0, "region": 20.0}}   # optional

        Every validation error names the offending level and member."""
        if not isinstance(spec, dict):
            raise ValueError(f"topology spec must be a JSON object, got {type(spec).__name__}")
        known = {"nodes", "levels", "edge_bytes", "edge_latency"}
        level_names = [str(x) for x in spec.get("levels", ())]
        if not level_names:
            raise ValueError("topology spec needs 'levels': an ordered list of hierarchy "
                             "level names, finest first (e.g. ['rack', 'region'])")
        dupes = sorted({x for x in level_names if level_names.count(x) > 1})
        if dupes:
            raise ValueError(f"duplicate level names in spec: {dupes}")
        unknown = sorted(set(spec) - known - set(level_names))
        if unknown:
            raise ValueError(f"unknown topology spec keys {unknown} (want nodes/levels/"
                             f"edge_bytes/edge_latency plus one group map per level in "
                             f"{level_names})")
        nodes = tuple(str(n) for n in spec.get("nodes", ()))
        if not nodes:
            raise ValueError("topology spec needs a non-empty 'nodes'")
        members = nodes
        per_node: list[tuple[str, ...]] = []
        node_dom = {n: n for n in nodes}
        for lvl, name in enumerate(level_names):
            groups = spec.get(name)
            if not isinstance(groups, dict) or not groups:
                raise ValueError(f"level {name!r}: spec needs a non-empty group map "
                                 f"{{domain: [members]}} under the {name!r} key")
            member_domain: dict[str, str] = {}
            kind = "node" if lvl == 0 else level_names[lvl - 1]
            for dom, mem in groups.items():
                for m in mem:
                    m = str(m)
                    if m not in members:
                        raise ValueError(f"level {name!r}: group {dom!r} names unknown "
                                         f"{kind} {m!r} (have {sorted(members)})")
                    if m in member_domain:
                        raise ValueError(f"level {name!r}: {m!r} appears in both "
                                         f"{member_domain[m]!r} and {dom!r}; a member "
                                         "belongs to exactly one domain")
                    member_domain[m] = str(dom)
            missing = sorted(set(members) - set(member_domain))
            if missing:
                raise ValueError(f"level {name!r}: {kind} {missing[0]!r} is not assigned "
                                 f"to any {name} group (unassigned: {missing})")
            node_dom = {n: member_domain[node_dom[n]] for n in nodes}
            per_node.append(tuple(node_dom[n] for n in nodes))
            members = tuple(dict.fromkeys(member_domain.values()))

        def _edges(key: str) -> tuple:
            raw = spec.get(key)
            if raw is None:
                return ()
            if isinstance(raw, dict):
                bad = sorted(set(raw) - set(level_names))
                if bad:
                    raise ValueError(f"{key} names unknown level {bad[0]!r} "
                                     f"(levels: {level_names})")
                miss = [x for x in level_names if x not in raw]
                if miss:
                    raise ValueError(f"{key} is missing a multiplier for level {miss[0]!r}; "
                                     "give one per level or omit the key entirely")
                return tuple(float(raw[x]) for x in level_names)
            return tuple(float(x) for x in raw)

        return cls(nodes=nodes, domains=per_node[0],
                   levels=tuple((level_names[i], per_node[i])
                                for i in range(1, len(level_names))),
                   edge_bytes=_edges("edge_bytes"), edge_latency=_edges("edge_latency"),
                   domain_level_name=level_names[0])

    def to_hierarchy_dict(self) -> dict:
        """The ``from_hierarchy`` spec of this topology (round-trip)."""
        out: dict = {"nodes": list(self.nodes), "levels": list(self.level_names)}
        for lvl, name in enumerate(self.level_names):
            doms = self.domains if lvl == 0 else self.levels[lvl - 1][1]
            groups: dict[str, list[str]] = {}
            if lvl == 0:
                for n, d in zip(self.nodes, doms):
                    groups.setdefault(d, []).append(n)
            else:
                lower = self.domains if lvl == 1 else self.levels[lvl - 2][1]
                seen = set()
                for lo, hi in zip(lower, doms):
                    if lo not in seen:
                        seen.add(lo)
                        groups.setdefault(hi, []).append(lo)
            out[name] = groups
        if self.edge_bytes:
            out["edge_bytes"] = dict(zip(self.level_names, self.edge_bytes))
        if self.edge_latency:
            out["edge_latency"] = dict(zip(self.level_names, self.edge_latency))
        return out


@dataclass
class PlacementResult:
    """Replica assignment: (n, max_rf) node ids, -1 where rf < max_rf."""

    replica_map: np.ndarray          # (n, max_rf) int32
    rf: np.ndarray                   # (n,) int32 effective rf (capped at #nodes)
    topology: ClusterTopology
    storage_per_node: np.ndarray | None = field(default=None)

    def holds(self, pid: np.ndarray, node: np.ndarray) -> np.ndarray:
        """Bool per event: does ``node`` hold a replica of file ``pid``?  A
        client outside the topology (``node < 0``) holds nothing."""
        return (self.replica_map[pid] == node[:, None]).any(axis=1) & (node >= 0)

    def compute_storage(self, size_bytes: np.ndarray) -> np.ndarray:
        """(#nodes,) replica bytes from the map; fills ``storage_per_node``
        when it is None."""
        if self.storage_per_node is None:
            sizes = np.asarray(size_bytes, dtype=np.int64)
            storage = np.zeros(len(self.topology), dtype=np.int64)
            sel = self.replica_map >= 0
            np.add.at(storage, self.replica_map[sel],
                      np.broadcast_to(sizes[:, None], self.replica_map.shape)[sel])
            self.storage_per_node = storage
        return self.storage_per_node

    def domain_counts(self) -> np.ndarray:
        """(n,) int32: distinct failure domains each file's replicas span."""
        dom = self.topology.domain_index()
        assigned = self.replica_map >= 0
        counts = np.zeros(self.replica_map.shape[0], dtype=np.int32)
        slot_dom = dom[np.clip(self.replica_map, 0, None)]
        for d in range(self.topology.n_domains):
            counts += ((slot_dom == d) & assigned).any(axis=1)
        return counts


def primary_on_topology(node_vocab, primary_node_id: np.ndarray, topology) -> np.ndarray:
    """Manifest primary ids mapped onto the topology by node name; a name
    outside it spreads over the topology by crc32."""
    n_nodes = len(topology.nodes)
    node_by_name = {nm: i for i, nm in enumerate(topology.nodes)}
    lut = np.asarray([node_by_name.get(nm, zlib.crc32(str(nm).encode()) % n_nodes)
                      for nm in node_vocab], dtype=np.int32)
    return lut[np.asarray(primary_node_id)]


def place_replicas(manifest: Manifest, rf_per_file: np.ndarray,
                   topology: ClusterTopology | None = None, seed: int | None = 0,
                   size_bytes: np.ndarray | None = None, method: str = "rng",
                   local_mask: np.ndarray | None = None) -> PlacementResult:
    """Place ``rf_per_file`` replicas of each file on the topology (see the
    module docstring); deterministic for (manifest, rf, seed).
    ``size_bytes`` (default: the manifest's sizes) fills the per-node byte
    accounting; ``local_mask`` pins each marked file to its primary's
    top-level domain on a geo hierarchy (its count clipped to that
    domain's node count) and is ignored on other topologies.  ``method``
    is "rng" (a seeded priority matrix over the whole population) or
    "hash" (``compute_placement``'s stateless priorities)."""
    topology = topology or ClusterTopology()
    n = len(manifest)
    n_nodes = len(topology)
    primary = primary_on_topology(manifest.nodes, manifest.primary_node_id, topology)

    rf_want = np.asarray(rf_per_file, dtype=np.int32)
    n_capped = int((rf_want > n_nodes).sum())
    if n_capped:
        _RF_CAP_WARNING.warn(
            f"replication factor capped at the node count for {n_capped} files "
            f"(requested up to {int(rf_want.max())}, topology has {n_nodes} nodes): "
            f"replicas are distinct-per-node, so e.g. Archival rf=4 on a 3-node "
            f"topology places 3")
        tel = current()
        if tel is not None:
            tel.counter_inc("placement.rf_capped", n_capped)
    rf = np.maximum(np.minimum(rf_want, n_nodes), 1)
    max_rf = int(rf.max())

    if method == "hash":
        from ..placement_fn.compute import compute_placement

        replica_map, rf = compute_placement(np.arange(n, dtype=np.int64), rf, primary,
                                            topology, 0 if seed is None else int(seed),
                                            local_mask=local_mask)
        result = PlacementResult(replica_map=replica_map, rf=rf, topology=topology)
        result.compute_storage(manifest.size_bytes if size_bytes is None else size_bytes)
        return result
    if method != "rng":
        raise ValueError(f"unknown placement method {method!r} (want 'rng' or 'hash')")

    prio = np.random.default_rng(seed).random((n, n_nodes))
    if topology.n_levels > 0:
        # The hash chooser's hierarchical fill, fed rng-packed priorities.
        from ..placement_fn.compute import PRIO_MAX, clip_shards_for_locality, \
            hierarchical_fill

        if n_nodes > 63:
            raise ValueError(f"hierarchical placement supports up to 63 nodes "
                             f"(6-bit packed node ids), got {n_nodes}")
        rf = clip_shards_for_locality(rf, primary, topology, local_mask)
        max_rf = int(rf.max()) if n else 1
        packed = ((prio * (1 << 26)).astype(np.uint32) << np.uint32(6)) \
            | np.arange(n_nodes, dtype=np.uint32)[None, :]
        w = np.ascontiguousarray(packed.T)
        replica_map = np.empty((n, max_rf), dtype=np.int32)
        replica_map[:, 0] = primary
        w[primary, np.arange(n)] = PRIO_MAX
        if local_mask is not None:
            lc = np.asarray(local_mask, dtype=bool)
            if lc.any():
                # Nodes outside a local file's home region are never chosen.
                dt = topology.top_domain_index()
                w[(dt[:, None] != dt[primary][None, :]) & lc[None, :]] = PRIO_MAX
        if max_rf >= 2:
            hierarchical_fill(w, replica_map, primary, max_rf, topology)
        replica_map[np.arange(max_rf)[None, :] >= rf[:, None]] = -1
    else:
        key = prio.copy()
        key[np.arange(n), primary] = -3.0           # replica 0: the primary
        dom = topology.domain_index()
        if topology.n_domains > 1 and n_nodes > 1:
            # The remote domain of each file: that of its best-priority node
            # outside the primary's domain; its best and second-best nodes
            # take replicas 1 and 2.
            same = dom[None, :] == dom[primary][:, None]
            remote_prio = np.where(same, np.inf, prio)
            best_remote = np.argmin(remote_prio, axis=1)
            has_remote = np.isfinite(remote_prio[np.arange(n), best_remote])
            in_rdom = ((dom[None, :] == dom[best_remote][:, None]) & ~same
                       & has_remote[:, None])
            masked = np.where(in_rdom, prio, np.inf)
            part = np.partition(masked, 1, axis=1)
            m1, m2 = part[:, 0], part[:, 1]
            key = np.where(np.isfinite(m1)[:, None] & (masked == m1[:, None]), -2.0, key)
            key = np.where(np.isfinite(m2)[:, None] & (masked == m2[:, None]), -1.0, key)
        order = np.argsort(key, axis=1).astype(np.int32)
        replica_map = order[:, :max_rf].copy()
        replica_map[np.arange(max_rf)[None, :] >= rf[:, None]] = -1
    result = PlacementResult(replica_map=replica_map, rf=rf, topology=topology)
    result.compute_storage(manifest.size_bytes if size_bytes is None else size_bytes)
    return result


def place_stripes(manifest: Manifest, shards_per_file: np.ndarray,
                  topology: ClusterTopology | None = None, seed: int | None = 0,
                  shard_bytes: np.ndarray | None = None, method: str = "rng",
                  local_mask: np.ndarray | None = None) -> PlacementResult:
    """Stripe placement of storage strategies: the k + m shards of an EC
    file want what replicas want (distinct nodes, spread across failure
    domains), so this is ``place_replicas`` over the per-file shard count,
    with a slot holding ``shard_bytes`` (about size / k) in the per-node
    accounting.  A replicate-only config gives ``place_replicas``'s result
    bit for bit."""
    return place_replicas(manifest, shards_per_file, topology, seed, size_bytes=shard_bytes,
                          method=method, local_mask=local_mask)
