"""Storage strategies on the port (``cdrs_tpu_torch/storage``, stripe
placement, the strategy methods of ``faults.ClusterState``, EC repair and
``storage show|estimate``) against ``cdrs_tpu`` on the same numpy-seeded
inputs.  Everything here is host numpy: exact fields compare exactly, and
``ClusterState.state_arrays()`` is compared after every call that mutates
it.  The cases are those of the reference's ``tests/test_storage.py`` and
``tests/test_geo.py`` that need no controller (those are in
``test_torch_storage_control.py``).
"""

import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu import cli as ref_cli  # noqa: E402
from cdrs_tpu import storage as ref_storage  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.cluster import place_replicas as ref_place_replicas  # noqa: E402
from cdrs_tpu.cluster import place_stripes as ref_place_stripes  # noqa: E402
from cdrs_tpu.faults import ClusterState as RefState  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.faults import RepairScheduler as RefRepairs  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

import cdrs_tpu_torch.config as pcfg  # noqa: E402
from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch import storage  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas, \
    place_stripes  # noqa: E402
from cdrs_tpu_torch.config import CATEGORIES, GeneratorConfig, KMeansConfig, \
    validated_scoring_config  # noqa: E402
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.faults import ClusterState, FaultSchedule, RepairScheduler  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402
from cdrs_tpu_torch.storage import StorageConfig, Strategy  # noqa: E402

NODES = tuple(f"dn{i}" for i in range(1, 13))
RACK_SPEC = "r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;r2=dn7,dn8,dn9;r3=dn10,dn11,dn12"
#: ``tests/test_geo.py``'s three-region hierarchy: 6 racks of 2 nodes.
GEO = {
    "nodes": list(NODES), "levels": ["rack", "region"],
    "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
    "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
    "edge_bytes": {"rack": 1.0, "region": 4.0},
    "edge_latency": {"rack": 1.5, "region": 8.0},
}


def _min_rf2(mod):
    base = mod.validated_scoring_config()
    rf = dict(base.replication_factors)
    rf["Moderate"] = max(2, rf["Moderate"])
    return dataclasses.replace(base, replication_factors=rf)


@pytest.fixture(scope="module")
def manifests():
    """Port and reference populations of ``test_storage.py``'s workload."""
    m = generate_population(GeneratorConfig(n_files=160, seed=71, nodes=NODES))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=160, seed=71, nodes=NODES))
    return m, rm


def _topologies(kind):
    if kind == "flat":
        return ClusterTopology(nodes=NODES), RefTopology(nodes=NODES)
    if kind == "racks":
        return (ClusterTopology.from_rack_spec(NODES, RACK_SPEC),
                RefTopology.from_rack_spec(NODES, RACK_SPEC))
    return ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)


def _assert_state_equal(got, want):
    ga, wa = got.state_arrays(), want.state_arrays()
    assert set(ga) == set(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype and np.array_equal(ga[k], wa[k]), k
    assert np.array_equal(got.node_bytes, want.node_bytes)
    assert np.array_equal(got.reachable_counts(), want.reachable_counts())
    assert np.array_equal(got.live_counts(), want.live_counts())


# -- strategies ------------------------------------------------------------------

SPECS = ["replicate(3)", "rf(4):warm", "ec(6,3):cold", "ec(1,2)", "ec(2,1):region",
         "ec(2,1):cold:region", "replicate(2):hot:spread", 5,
         {"k": 6, "m": 3, "tier": "cold"}, {"rf": 2}, {"kind": "ec", "k": 4, "m": 2}]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_strategy_spec_roundtrip(spec):
    s = Strategy.from_spec(spec)
    r = ref_storage.Strategy.from_spec(spec)
    assert dataclasses.asdict(s) == dataclasses.asdict(r)
    assert (s.n_shards, s.min_live, s.shard_div, s.overhead, s.repair_read_shards) == \
        (r.n_shards, r.min_live, r.shard_div, r.overhead, r.repair_read_shards)
    assert s.spec() == r.spec()
    assert Strategy.from_spec(s.spec()) == s


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


BAD = [
    ("cfg", {"Archival": "ec(0,3)"}), ("cfg", {"Hot": "replicate(0)"}),
    ("spec", "ec(6,-1)"), ("cfg", {"Hot": "replicate(3):lava"}),
    ("dict", {"strategy": {}}), ("spec", {"tier": "cold"}), ("spec", {"kind": "ec", "m": 3}),
    ("spec", {"rf": 3, "k": 2}), ("spec", {"kind": "ec", "rf": 3, "k": 2}),
    ("spec", "ec(6 3)"), ("spec", {"rf": 2, "depth": 1}), ("spec", "ec(2,1):cold:nowhere"),
    ("tier", {"tiers": {"x": {"byte_cost": 0.0, "throughput": 1.0}}}),
    ("tier", {"tiers": {"x": {"byte_cost": 1.0, "throughput": 1.5}}}),
    ("tier", {"tiers": {"x": {"cost": 1.0}}}), ("dict", {"default_tier": "lava"}),
    ("vectors", {"Warmish": "replicate(2)"}),
]


@pytest.mark.parametrize("kind,arg", BAD, ids=[f"{k}-{i}" for i, (k, _) in enumerate(BAD)])
def test_strategy_validation_matches_the_reference(kind, arg):
    """Each bad input raises the reference's message (which names the
    category where there is one)."""
    def make(mod):
        if kind == "cfg":
            return lambda: mod.StorageConfig(strategies=arg)
        if kind == "spec":
            return lambda: mod.Strategy.from_spec(arg)
        if kind in ("dict", "tier"):
            return lambda: mod.storage_config_from_dict(arg)
        return lambda: mod.StorageConfig(strategies=arg).vectors(
            ("Hot", "Archival"), {"Hot": 3, "Archival": 4})
    got, want = _error(make(storage)), _error(make(ref_storage))
    assert got == want
    if kind == "cfg":
        assert repr(next(iter(arg))) in got


def test_strategy_dict_must_size_itself():
    with pytest.raises(ValueError, match="needs 'rf'"):
        Strategy.from_spec({"tier": "cold"})
    with pytest.raises(ValueError, match="ec keys"):
        Strategy.from_spec({"rf": 3, "k": 2})
    assert Strategy.from_spec({"k": 6, "m": 3, "tier": "cold"}).spec() == "ec(6,3):cold"
    assert Strategy.from_spec({"rf": 2}).spec() == "replicate(2):hot"


CONFIGS = {
    "ec_archival": lambda mod, sc: mod.StorageConfig.ec_archival(sc),
    "replicate": lambda mod, sc: mod.StorageConfig.from_scoring(sc),
    "custom": lambda mod, sc: mod.storage_config_from_dict({
        "strategies": {"Hot": "replicate(3)", "Shared": "ec(4,2):warm",
                       "Archival": {"k": 2, "m": 1, "tier": "glacier", "locality": "region"}},
        "tiers": {"glacier": {"byte_cost": 0.1, "throughput": 0.05}},
        "default_tier": "warm"}),
    "ec_1_m": lambda mod, sc: mod.StorageConfig(strategies={"Archival": "ec(1,2):cold"}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vectors_and_describe_match_the_reference(name):
    sc, rsc = _min_rf2(pcfg), _min_rf2(jcfg)
    cfg, ref = CONFIGS[name](storage, sc), CONFIGS[name](ref_storage, rsc)
    sv = cfg.vectors(CATEGORIES, sc.replication_factors)
    rv = ref.vectors(CATEGORIES, rsc.replication_factors)
    for f in dataclasses.fields(rv):
        a, b = getattr(sv, f.name), getattr(rv, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert cfg.describe(CATEGORIES, sc.replication_factors) == \
        ref.describe(CATEGORIES, rsc.replication_factors)
    assert cfg.to_dict() == ref.to_dict() and cfg.pure_replication == ref.pure_replication
    rng = np.random.default_rng(5)
    cat = rng.integers(-1, len(CATEGORIES), 500)
    sizes = rng.integers(1, 10**9, 500)
    for fn in ("file_min_live", "file_ec_k", "file_region_local"):
        assert np.array_equal(getattr(sv, fn)(cat), getattr(rv, fn)(cat)), fn
    assert np.array_equal(sv.file_shard_bytes(cat, sizes), rv.file_shard_bytes(cat, sizes))
    assert sv.file_shard_bytes(cat, sizes).dtype == np.int64
    assert np.array_equal(sv.file_n_shards(cat, 2), rv.file_n_shards(cat, 2))


def test_vectors_arithmetic():
    sv = StorageConfig.ec_archival(_min_rf2(pcfg)).vectors(
        CATEGORIES, {"Hot": 3, "Shared": 2, "Moderate": 2, "Archival": 4})
    i = sv.categories.index("Archival")
    assert (sv.n_shards[i], sv.min_live[i], sv.shard_div[i], sv.ec_k[i]) == (9, 6, 6, 6)
    j = sv.categories.index("Hot")
    assert (sv.n_shards[j], sv.min_live[j], sv.ec_k[j]) == (3, 1, 0)
    cat = np.asarray([i, i, -1])
    assert sv.file_shard_bytes(cat, np.asarray([600, 601, 5])).tolist() == [100, 101, 5]
    assert sv.file_min_live(cat).tolist() == [6, 6, 1]
    # Shard bytes stay int64 past 2**31.
    assert sv.file_shard_bytes(np.asarray([i]), np.asarray([6 * 2**40 + 1])).tolist() == \
        [2**40 + 1]


def test_resolve_and_load(tmp_path):
    sc = validated_scoring_config()
    assert storage.resolve_storage_config(None, sc) is None
    assert storage.resolve_storage_config("replicate", sc).pure_replication
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"strategies": {"Archival": "ec(4,2):cold"}}))
    got = storage.resolve_storage_config(str(path), sc)
    want = ref_storage.resolve_storage_config(str(path), jcfg.validated_scoring_config())
    assert got.to_dict() == want.to_dict()


def test_ec_strategy_must_fit_topology():
    small = generate_population(GeneratorConfig(n_files=40, seed=3, nodes=("a", "b", "c")))
    sc = _min_rf2(pcfg)
    with pytest.raises(ValueError, match="'Archival'.*9 distinct nodes.*has 3"):
        ReplicationController(small, ControllerConfig(
            window_seconds=60.0, default_rf=2, kmeans=KMeansConfig(k=8, seed=42),
            scoring=sc, storage=StorageConfig.ec_archival(sc), device="cpu"))


# -- stripe placement --------------------------------------------------------------

@pytest.mark.parametrize("topo", ["flat", "racks", "geo"])
def test_place_stripes_degenerates_to_place_replicas(manifests, topo):
    m, rm = manifests
    t, rt = _topologies(topo)
    rf = np.random.default_rng(1).integers(1, 5, len(m)).astype(np.int32)
    a = place_replicas(m, rf, t, seed=0)
    b = place_stripes(m, rf, t, seed=0)
    w = ref_place_replicas(rm, rf, rt, seed=0)
    for res in (a, b):
        assert np.array_equal(res.replica_map, w.replica_map)
        assert np.array_equal(res.rf, w.rf)
        assert np.array_equal(res.storage_per_node, w.storage_per_node)


@pytest.mark.parametrize("topo", ["flat", "racks", "geo"])
@pytest.mark.parametrize("local", [False, True])
def test_place_stripes_matches_the_reference(manifests, topo, local):
    """Mixed EC and replicate shard counts at their shard sizes, with and
    without a region-local mask, bit for bit."""
    m, rm = manifests
    t, rt = _topologies(topo)
    rng = np.random.default_rng(2)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    k = np.where(rng.random(len(m)) < 0.5, 6, 1)
    shards = np.where(k > 1, 9, rng.integers(1, 4, len(m))).astype(np.int32)
    shard_bytes = -(-sizes // k)
    mask = rng.random(len(m)) < 0.5 if local else None
    got = place_stripes(m, shards, t, seed=0, shard_bytes=shard_bytes, local_mask=mask)
    want = ref_place_stripes(rm, shards, rt, seed=0, shard_bytes=shard_bytes,
                             local_mask=mask)
    assert np.array_equal(got.replica_map, want.replica_map)
    assert np.array_equal(got.rf, want.rf)
    assert np.array_equal(got.storage_per_node, want.storage_per_node)
    if topo == "geo" and local:
        dom_top = t.top_domain_index()
        prim = got.replica_map[:, 0]
        for i in np.flatnonzero(mask):
            row = got.replica_map[i][got.replica_map[i] >= 0]
            assert (dom_top[row] == dom_top[prim[i]]).all()
            assert got.rf[i] == min(shards[i], 4)   # 4 nodes per region
    if topo == "racks":
        assert got.storage_per_node.sum() == (shard_bytes * got.rf).sum()


def test_place_stripes_ec_shard_accounting(manifests):
    m, _ = manifests
    topo = ClusterTopology.from_rack_spec(NODES, RACK_SPEC)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    shard_bytes = -(-sizes // 6)
    res = place_stripes(m, np.full(len(m), 9, np.int32), topo, seed=0,
                        shard_bytes=shard_bytes)
    assert (res.rf == 9).all() and res.domain_counts().min() >= 3
    dom = topo.domain_index()
    slot_dom = dom[np.clip(res.replica_map, 0, None)]
    per_rack = np.stack([((slot_dom == d) & (res.replica_map >= 0)).sum(axis=1)
                         for d in range(4)], axis=1)
    assert per_rack.max() <= 3
    assert res.storage_per_node.sum() == (shard_bytes * 9).sum()


# -- ClusterState strategy methods ----------------------------------------------------

def _state_pair(m, rm, topo="racks", k=6, ec_m=3):
    """Port and reference states of EC(k, m) stripes on every file."""
    t, rt = _topologies(topo)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    n = len(m)
    shards = np.full(n, k + ec_m, dtype=np.int32)
    shard_bytes = -(-sizes // k)
    out = []
    for place, man, tp, cls in ((place_stripes, m, t, ClusterState),
                                (ref_place_stripes, rm, rt, RefState)):
        st = cls(place(man, shards, tp, seed=0, shard_bytes=shard_bytes), sizes)
        st.set_strategy_arrays(np.full(n, k, np.int32), shard_bytes, np.full(n, k, np.int32))
        out.append(st)
    _assert_state_equal(*out)
    return out[0], out[1], shards


def _apply(states, spec):
    """Apply the first event of ``spec`` (a window range's start) to both."""
    for st, sched in zip(states, (FaultSchedule, RefSchedule)):
        st.apply_event(sched.from_specs([spec]).events[0])


@pytest.mark.parametrize("topo", ["racks", "geo"])
def test_strategy_methods_match_the_reference(manifests, topo):
    """A sequence of re-encodes (replicate -> EC, EC -> replicate, an
    equal-shard-count conversion, region-local, deferrals behind a
    partition and their retry), state arrays compared after each call."""
    m, rm = manifests
    t, rt = _topologies(topo)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    rf = np.full(len(m), 2, np.int32)
    got = ClusterState(place_replicas(m, rf, t, seed=0), sizes)
    want = RefState(ref_place_replicas(rm, rf, rt, seed=0), sizes)
    pair = (got, want)
    calls = []
    for f in range(0, 40, 3):
        calls.append(("apply_strategy_target", (f, 6, int(-(-sizes[f] // 6)), 6, 9)))
    for f in range(1, 40, 3):
        calls.append(("apply_strategy_target",
                      (f, 2, int(-(-sizes[f] // 2)), 2, 3, topo == "geo")))
    for f in range(0, 12, 3):     # EC back to replicate, shrink and grow rf
        calls.append(("apply_strategy_target", (f, 1, int(sizes[f]), 0, 3)))
        calls.append(("apply_strategy_target", (f, 1, int(sizes[f]), 0, 1)))
    calls.append(("set_file_strategy", (50, 4, int(-(-sizes[50] // 4)), 4)))
    for name, args in calls:
        ret = [getattr(st, name)(*args) for st in pair]
        assert ret[0] == ret[1], (name, args)
        _assert_state_equal(got, want)
    # Behind a partition most re-encodes defer; the mismatch lists them.
    _apply(pair, "partition:dn1+dn2+dn3+dn4+dn5+dn6+dn7@0")
    want_min = np.where(np.arange(len(m)) < 60, 6, got.min_live).astype(np.int32)
    want_sb = np.where(np.arange(len(m)) < 60, -(-sizes // 6), got.shard_bytes)
    want_k = np.where(np.arange(len(m)) < 60, 6, got.ec_k).astype(np.int32)
    mism = [st.strategy_mismatch(want_min, want_sb, want_k) for st in pair]
    assert np.array_equal(*mism) and len(mism[0])
    for f in mism[0][:20]:
        f = int(f)
        ret = [st.apply_strategy_target(f, 6, int(want_sb[f]), 6, 9) for st in pair]
        assert ret[0] == ret[1] == 0
        _assert_state_equal(got, want)
    _apply(pair, "heal:dn1+dn2+dn3+dn4+dn5+dn6+dn7@1")
    for f in mism[0][:20]:
        f = int(f)
        ret = [st.apply_strategy_target(f, 6, int(want_sb[f]), 6, 9) for st in pair]
        assert ret[0] == ret[1]
        _assert_state_equal(got, want)
    assert not len(got.strategy_mismatch(got.min_live, got.shard_bytes, got.ec_k,
                                         region_local=got.region_local))
    for f in range(40):
        assert got.repair_read_bytes(f) == want.repair_read_bytes(f)
        tgt = got.pick_repair_target(f)
        assert tgt == want.pick_repair_target(f)
        if tgt >= 0:
            assert got.copy_charge(f, tgt) == want.copy_charge(f, tgt)


def test_equal_shard_count_conversion(manifests):
    m, rm = manifests
    t, rt = _topologies("racks")
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    rf = np.full(len(m), 3, np.int32)
    got = ClusterState(place_replicas(m, rf, t, seed=0), sizes)
    want = RefState(ref_place_replicas(rm, rf, rt, seed=0), sizes)
    args = (0, 2, int(-(-sizes[0] // 2)), 2, 3)
    assert got.apply_strategy_target(*args) == want.apply_strategy_target(*args) == 0
    assert got.ec_k[0] == 2 and got.min_live[0] == 2
    assert int((got.replica_map[0] >= 0).sum()) == 3
    _assert_state_equal(got, want)


def test_set_strategy_arrays_validates_shapes(manifests):
    m, rm = manifests
    got, _, _ = _state_pair(m, rm)
    with pytest.raises(ValueError, match="min_live shape"):
        got.set_strategy_arrays(np.ones(3, np.int32), got.shard_bytes, got.ec_k)


def test_ec_durability_tiers(manifests):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm)
    cat = np.zeros(len(m), np.int64) - 1
    cats = ("Hot", "Shared", "Moderate", "Archival")
    assert got.durability(shards, cat, cats) == want.durability(shards, cat, cats)
    for node in ("dn4", "dn5", "dn6"):
        _apply((got, want), f"crash:{node}@0")
    d = got.durability(shards, cat, cats)
    assert d == want.durability(shards, cat, cats) and d["lost"] == 0
    assert (got.reachable_counts() >= 6).all()
    assert d["at_risk"] == int((got.reachable_counts() == 6).sum())
    for node in ("dn7", "dn8", "dn9", "dn10"):
        _apply((got, want), f"crash:{node}@0")
    assert got.lost_mask().any()
    assert np.array_equal(got.lost_mask(), want.lost_mask())
    assert (got.lost_mask() == (got.live_counts() < 6)).all()
    _assert_state_equal(got, want)


# -- EC repair -------------------------------------------------------------------------

def _repair_pair(got, want, shards, window=0, **kw):
    reps = []
    for st, cls in ((got, RepairScheduler), (want, RefRepairs)):
        sched = cls(seed=0)
        sched.sync(st, shards)
        reps.append((sched, sched.schedule(window, st, shards, np.zeros(len(shards), np.int64),
                                           **kw)))
    (gs, g), (ws, w) = reps
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert np.array_equal(gs.backlog.fid, ws.backlog.fid)
    _assert_state_equal(got, want)
    return gs, g


@pytest.mark.parametrize("max_bytes", [None, 50_000_000])
def test_ec_repair_reads_k_shards(manifests, max_bytes):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    assert got.repair_read_bytes(0) == int(-(-sizes[0] // 6)) * 6
    _apply((got, want), "crash:dn4@0")
    _, rep = _repair_pair(got, want, shards, max_bytes=max_bytes)
    assert rep.bytes_copied > 0
    # The budget pays k shards read for each shard written.
    assert rep.bytes_used >= 5.9 * rep.bytes_copied
    if max_bytes is None:
        d = got.durability(shards, np.zeros(len(m), np.int64), ("Hot",))
        assert d["under_replicated"] == d["at_risk"] == 0
    else:
        assert rep.deferred_budget > 0


def test_ec_charge_gated_by_slowest_of_k_fastest_sources(manifests):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm)
    holders = [int(x) for x in got.replica_map[0] if int(x) >= 0]
    _apply((got, want), f"crash:{got.nodes[holders[0]]}@0")
    for h in holders[1:5]:
        _apply((got, want), f"degrade:{got.nodes[h]}@0-99:0.25")
    target = got.pick_repair_target(0)
    assert target == want.pick_repair_target(0)
    assert float(got.node_throughput[target]) == 1.0
    charge = got.copy_charge(0, target)
    assert charge == RefRepairs(seed=0)._charge(want, 0, target)
    assert charge == int(np.ceil(got.repair_read_bytes(0) / 0.25))
    _repair_pair(got, want, shards)


def test_lost_stripe_has_no_source(manifests):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm)
    for node in NODES[:7]:   # 5 up < k = 6
        _apply((got, want), f"crash:{node}@0")
    assert got.lost_mask().all()
    sched, rep = _repair_pair(got, want, shards)
    assert rep.files_touched == 0 and rep.bytes_used == 0
    assert rep.deferred_no_source == len(sched.backlog) > 0


def test_ec_partition_stall_not_lost(manifests):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm)
    _apply((got, want), "partition:dn1+dn2+dn3+dn4+dn5+dn6+dn7@0")
    d = got.durability(shards, np.zeros(len(m), np.int64), ("Hot",))
    assert d == want.durability(shards, np.zeros(len(m), np.int64), ("Hot",))
    assert d["lost"] == 0 and d["unreachable"] == int((got.reachable_counts() < 6).sum())
    _, rep = _repair_pair(got, want, shards, window=1)
    assert rep.deferred_partition > 0


def test_state_arrays_round_trip_with_stripes(manifests):
    m, rm = manifests
    got, want, shards = _state_pair(m, rm, topo="geo", k=2, ec_m=1)
    _apply((got, want), "crash:dn3@0")
    _repair_pair(got, want, shards)
    t, _ = _topologies("geo")
    fresh = ClusterState(place_replicas(m, np.ones(len(m), np.int32), t, seed=0),
                         np.asarray(m.size_bytes, dtype=np.int64))
    fresh.load_state_arrays(got.state_arrays())
    _assert_state_equal(fresh, want)


# -- storage show | estimate -------------------------------------------------------------

def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("config", ["ec_archival", "replicate", "file"])
def test_cli_storage_show_matches_the_reference(tmp_path, config):
    if config == "file":
        path = tmp_path / "s.json"
        path.write_text(json.dumps({"strategies": {"Shared": "ec(4,2):warm:region"},
                                    "tiers": {"tape": {"byte_cost": 0.05,
                                                       "throughput": 0.01}}}))
        config = str(path)
    argv = ["storage", "show", "--storage_config", config, "--scoring_config", "validated"]
    got, want = _run_cli(port_cli.main, argv), _run_cli(ref_cli.main, argv)
    assert got[0] == want[0] == 0 and got[1] == want[1]
    assert json.loads(got[1])["categories"][0]["category"] == "Hot"


def test_cli_storage_estimate_matches_the_reference(tmp_path):
    m = str(tmp_path / "m.csv")
    assert port_cli.main(["gen", "--n", "40", "--nodes", ",".join(NODES), "--seed", "40",
                          "--out_manifest", m]) == 0
    from cdrs_tpu_torch.io.events import Manifest

    manifest = Manifest.read_csv(m)
    a = str(tmp_path / "assign.csv")
    with open(a, "w") as f:
        f.write("path,category\n")
        for i, p in enumerate(manifest.paths[:20]):
            f.write(f"{p},{CATEGORIES[i % 4]}\n")
        f.write("not/a/manifest/path,Hot\n")
    outs = {}
    for config in ("ec_archival", "replicate"):
        argv = ["storage", "estimate", "--manifest", m, "--assignments_csv", a,
                "--storage_config", config]
        got, want = _run_cli(port_cli.main, argv), _run_cli(ref_cli.main, argv)
        assert got == want and got[0] == 0
        outs[config] = json.loads(got[1])
        assert outs[config]["files"] == 40 and outs[config]["files_categorized"] == 20
        assert "1/21" in got[2]
    arch = [r for r in outs["ec_archival"]["per_category"] if r["category"] == "Archival"][0]
    assert arch["strategy"] == "ec(6,3):cold"
    assert arch["bytes_stored"] < arch["bytes_replicate_baseline"]
    # No matching row, and a missing table: the reference's exit codes.
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("path,category\nnope,Hot\n")
    for argv in (["storage", "estimate", "--manifest", m, "--assignments_csv", bad],
                 ["storage", "estimate", "--manifest", m]):
        got, want = _run_cli(port_cli.main, argv), _run_cli(ref_cli.main, argv)
        assert got == want and got[0] == 1
