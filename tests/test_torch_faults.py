"""The port's fault modules (``cdrs_tpu_torch/faults``) and failure-domain
placement against ``cdrs_tpu``'s, on the CPU.

Every module here is host numpy in both packages, so the checks are exact:
schedules parsed, serialized and drawn at random; ``ClusterState`` after
the same events and mutations (``state_arrays`` bit for bit, durability
tiers, integrity, the placement view); one window of ``RepairScheduler``
and ``Scrubber`` under the same budgets; the migration scheduler's
reservations; the topology parsers; the rng and hash placements on flat,
rack and geo topologies.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu import faults as ref_faults  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.cluster import place_replicas as ref_place  # noqa: E402
from cdrs_tpu.control.migrate import MigrationScheduler as RefScheduler  # noqa: E402
from cdrs_tpu.control.migrate import plan_diff as ref_plan_diff  # noqa: E402
from cdrs_tpu.faults.repair import _fail_roll as ref_fail_roll  # noqa: E402
from cdrs_tpu.faults.state import _corrupt_roll as ref_corrupt_roll  # noqa: E402
from cdrs_tpu.obs.aggregate import integrity_digest as ref_integrity_digest  # noqa: E402
from cdrs_tpu.placement_fn import compute_placement as ref_compute  # noqa: E402
from cdrs_tpu.serve import read_view as ref_read_view  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch import faults  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas  # noqa: E402
from cdrs_tpu_torch.cluster.placement import primary_on_topology  # noqa: E402
from cdrs_tpu_torch.config import CATEGORIES, GeneratorConfig  # noqa: E402
from cdrs_tpu_torch.control.migrate import MigrationScheduler, plan_diff  # noqa: E402
from cdrs_tpu_torch.faults.repair import _fail_roll  # noqa: E402
from cdrs_tpu_torch.faults.state import _corrupt_roll  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import integrity_digest  # noqa: E402
from cdrs_tpu_torch.placement_fn import compute_placement  # noqa: E402
from cdrs_tpu_torch.serve import read_view  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

NODES = tuple(f"dn{i}" for i in range(1, 7))
RACKS = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
GEO = {"nodes": list(NODES), "levels": ["rack", "region"],
       "rack": {"r0": ["dn1", "dn2"], "r1": ["dn3", "dn4"], "r2": ["dn5", "dn6"]},
       "region": {"eu": ["r0"], "us": ["r1", "r2"]},
       "edge_bytes": {"rack": 2.0, "region": 5.0},
       "edge_latency": {"rack": 1.5, "region": 10.0}}
TOPOLOGIES = ("flat", "racks", "geo")


def _topologies(kind):
    """(port, reference) topologies of one kind over NODES."""
    if kind == "flat":
        return ClusterTopology(NODES), RefTopology(NODES)
    if kind == "racks":
        return (ClusterTopology.from_rack_spec(NODES, RACKS),
                RefTopology.from_rack_spec(NODES, RACKS))
    return ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)


def _manifests(n, seed):
    return (generate_population(GeneratorConfig(n_files=n, seed=seed, nodes=NODES)),
            ref_generate(jcfg.GeneratorConfig(n_files=n, seed=seed, nodes=NODES)))


def _states(kind, n=300, seed=0, rf=None):
    """Port and reference ClusterStates placed alike."""
    (topo, rtopo), (m, rm) = _topologies(kind), _manifests(n, seed)
    if rf is None:
        rf = np.random.default_rng(seed).integers(1, 4, size=n).astype(np.int32)
    st = faults.ClusterState(place_replicas(m, rf, topo, seed=0), m.size_bytes)
    rst = ref_faults.ClusterState(ref_place(rm, rf, rtopo, seed=0), rm.size_bytes)
    return st, rst


def _assert_states_equal(st, rst):
    a, b = st.state_arrays(), rst.state_arrays()
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_array_equal(st.node_bytes, rst.node_bytes)
    np.testing.assert_array_equal(st._live_counts, rst._live_counts)
    np.testing.assert_array_equal(st._reach_counts, rst._reach_counts)
    np.testing.assert_array_equal(st._dom_spread, rst._dom_spread)


def _events(specs):
    return faults.FaultSchedule.from_specs(specs), ref_faults.FaultSchedule.from_specs(specs)


# -- schedules ---------------------------------------------------------------

SPECS = ["crash:dn2@3-5", "flaky:dn1@2-4:0.7", "decommission:dn3@1", "recover:dn4@6",
         "partition:dn2+dn3@4-6", "degrade:dn5@2-6:0.25", "corrupt:dn1@3:0.25",
         "corrupt:dn2#17@3", "crash:rack:r1@7"]


def test_schedule_specs_and_json_match_the_reference():
    got, want = _events(SPECS)
    assert [e.spec() for e in got] == [e.spec() for e in want]
    assert got.to_json() == want.to_json()
    assert faults.FaultSchedule.from_json(json.loads(json.dumps(got.to_json()))).events \
        == got.events
    assert got.max_window == want.max_window and got.nodes() == want.nodes()
    for w in range(got.max_window + 2):
        assert [e.spec() for e in got.for_window(w)] == [e.spec() for e in want.for_window(w)]
    topo, rtopo = _topologies("racks")
    assert got.expand_domains(topo).to_json() == want.expand_domains(rtopo).to_json()
    edited = got.drop(0).splice(faults.FaultEvent(2, "crash", "dn6")).retime(0, 9)
    redited = want.drop(0).splice(ref_faults.FaultEvent(2, "crash", "dn6")).retime(0, 9)
    assert edited.to_json() == redited.to_json()


@pytest.mark.parametrize("bad,match", [
    ("crash@dn2:3", "bad fault spec"), ("crash:dn2@x", "bad fault spec"),
    ("crash:dn2@3:0.5", "bad fault spec"), ("explode:dn2@3", "unknown fault kind"),
    ("decommission:dn1@2-4", "spans"), ("corrupt:dn2#-1@3", "bad fault spec"),
    ("flaky:dn1+dn2@2", "node groups"), ("unflaky:rack:r0@2", "domain scopes"),
])
def test_bad_specs_raise_like_the_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        faults.FaultSchedule.from_specs([bad])
    with pytest.raises(ValueError, match=match):
        ref_faults.FaultSchedule.from_specs([bad])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_schedule_matches_the_reference(seed):
    kw = dict(seed=seed, crash_rate=0.3, recover_windows=(2, 6), flaky_rate=0.2,
              degrade_rate=0.1, corrupt_rate=0.1, corrupt_frac=0.2)
    got = faults.FaultSchedule.random(NODES, 30, **kw)
    want = ref_faults.FaultSchedule.random(NODES, 30, **kw)
    assert len(got) > 0 and got.to_json() == want.to_json()
    cas = faults.FaultSchedule.cascade(NODES[:3], 2, spacing=2, recover_after=3)
    assert cas.to_json() == ref_faults.FaultSchedule.cascade(
        NODES[:3], 2, spacing=2, recover_after=3).to_json()
    roll = faults.FaultSchedule.rolling_decommission(NODES[3:], 1)
    assert roll.to_json() == ref_faults.FaultSchedule.rolling_decommission(NODES[3:], 1).to_json()


def test_stateless_rolls_match_the_reference():
    fids = np.arange(500)
    for w, nid in ((0, 0), (3, 2), (17, 5)):
        np.testing.assert_array_equal(_corrupt_roll(w, nid, fids), ref_corrupt_roll(w, nid, fids))
    assert [_fail_roll(s, w, f, a, c) for s in (0, 7) for w in range(3) for f in (0, 9)
            for a in range(2) for c in range(2)] == \
        [ref_fail_roll(s, w, f, a, c) for s in (0, 7) for w in range(3) for f in (0, 9)
         for a in range(2) for c in range(2)]


# -- topologies and placement --------------------------------------------------

def test_topology_parsers_and_round_trip():
    for kind in TOPOLOGIES:
        topo, rtopo = _topologies(kind)
        assert topo.nodes == rtopo.nodes and topo.domains == rtopo.domains
        assert topo.levels == rtopo.levels and topo.level_names == rtopo.level_names
        np.testing.assert_array_equal(topo.domain_index(), rtopo.domain_index())
        np.testing.assert_array_equal(topo.top_domain_index(), rtopo.top_domain_index())
        np.testing.assert_array_equal(topo.separation(), rtopo.separation())
        np.testing.assert_array_equal(topo.byte_cost_matrix(), rtopo.byte_cost_matrix())
        np.testing.assert_array_equal(topo.latency_matrix(), rtopo.latency_matrix())
        if kind != "flat":
            spec = topo.to_hierarchy_dict()
            assert spec == rtopo.to_hierarchy_dict()
            back = ClusterTopology.from_hierarchy(json.loads(json.dumps(spec)))
            assert (back.nodes, back.domains, back.levels, back.edge_bytes,
                    back.edge_latency) == (topo.nodes, topo.domains, topo.levels,
                                           topo.edge_bytes, topo.edge_latency)
    topo, rtopo = _topologies("geo")
    assert topo.nodes_in("region", "us") == rtopo.nodes_in("region", "us")
    assert ClusterTopology.from_racks(NODES, {"dn1": "a", "dn2": "a"}).domains == \
        RefTopology.from_racks(NODES, {"dn1": "a", "dn2": "a"}).domains


@pytest.mark.parametrize("build,match", [
    (lambda: ClusterTopology(("dn1", "dn1")), "duplicate node names"),
    (lambda: ClusterTopology.from_rack_spec(NODES, "r0=dn1;r1=dn1"), "two rack groups"),
    (lambda: ClusterTopology.from_rack_spec(NODES, "rack1=dn1;dn2"), "duplicate rack name"),
    (lambda: ClusterTopology.from_hierarchy(dict(GEO, region={"eu": ["r0", "r9"],
                                                              "us": ["r1", "r2"]})),
     "names unknown rack 'r9'"),
    (lambda: ClusterTopology.from_hierarchy(dict(GEO, edge_bytes={"rack": 1.0})),
     "missing a multiplier"),
    (lambda: ClusterTopology(NODES[:2], ("a", "b"), levels=(("region", ("x", "x")),),
                             edge_bytes=(0.5, 1.0)), "must be >= 1.0"),
    (lambda: ClusterTopology(NODES[:3], ("a", "a", "b"), levels=(("region", ("x", "y", "y")),)),
     "must nest inside"),
])
def test_topology_validation_names_the_fault(build, match):
    with pytest.raises(ValueError, match=match):
        build()


@pytest.mark.parametrize("kind", TOPOLOGIES)
def test_rng_placement_matches_the_reference(kind):
    (topo, rtopo), (m, rm) = _topologies(kind), _manifests(400, 3)
    rf = np.random.default_rng(3).integers(1, 5, size=400).astype(np.int32)
    got = place_replicas(m, rf, topo, seed=0)
    want = ref_place(rm, rf, rtopo, seed=0)
    np.testing.assert_array_equal(got.replica_map, want.replica_map)
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.storage_per_node, want.storage_per_node)
    np.testing.assert_array_equal(got.domain_counts(), want.domain_counts())
    if kind != "flat":
        # Replicas spread: two or more copies always span two racks.
        assert (got.domain_counts()[got.rf >= 2] >= 2).all()


@pytest.mark.parametrize("kind", TOPOLOGIES)
def test_hash_placement_matches_the_reference(kind):
    topo, rtopo = _topologies(kind)
    m, _ = _manifests(500, 4)
    fids = np.arange(500, dtype=np.int64)
    rf = np.random.default_rng(4).integers(1, 6, size=500).astype(np.int32)
    prim = primary_on_topology(m.nodes, m.primary_node_id, topo)
    local = np.random.default_rng(5).random(500) < 0.3 if kind == "geo" else None
    got = compute_placement(fids, rf, prim, topo, 7, chunk=128, local_mask=local)
    want = ref_compute(fids, rf, prim, rtopo, 7, chunk=128, local_mask=local)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # Subset rows equal the full computation's.
    sub = fids[::7]
    part = compute_placement(sub, rf[sub], prim[sub], topo, 7,
                             local_mask=None if local is None else local[sub])
    np.testing.assert_array_equal(part[0][:, :got[0].shape[1]][:, :part[0].shape[1]],
                                  got[0][sub][:, :part[0].shape[1]])


@pytest.mark.parametrize("kind", ["racks", "geo"])
def test_hierarchical_fill_matches_the_reference(kind):
    """The greedy highest-level-first fill on one packed priority block, and
    the region-locality clip, called directly."""
    from cdrs_tpu.placement_fn.compute import clip_shards_for_locality as ref_clip
    from cdrs_tpu.placement_fn.compute import hierarchical_fill as ref_fill
    from cdrs_tpu_torch.placement_fn import clip_shards_for_locality, hierarchical_fill
    from cdrs_tpu_torch.placement_fn.compute import NODE_MASK, PRIO_MAX

    topo, rtopo = _topologies(kind)
    rng = np.random.default_rng(11)
    m, n_nodes, max_rf = 257, len(NODES), 5
    prio = rng.integers(0, 1 << 20, size=(n_nodes, m), dtype=np.uint32)
    w = (prio << np.uint32(6)) | np.arange(n_nodes, dtype=np.uint32)[:, None]
    assert int(NODE_MASK) == 0x3F
    prim = rng.integers(0, n_nodes, size=m).astype(np.int32)
    w[prim, np.arange(m)] = PRIO_MAX
    outs = []
    for fill, t in ((hierarchical_fill, topo), (ref_fill, rtopo)):
        out = np.full((m, max_rf), -2, dtype=np.int32)
        out[:, 0] = prim
        ww = w.copy()
        fill(ww, out, prim, max_rf, t)
        outs.append((out, ww))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert (np.sort(outs[0][0], axis=1)[:, 1:] != np.sort(outs[0][0], axis=1)[:, :-1]).all()
    shards = rng.integers(1, 7, size=m).astype(np.int32)
    local = rng.random(m) < 0.5
    np.testing.assert_array_equal(clip_shards_for_locality(shards, prim, topo, local),
                                  ref_clip(shards, prim, rtopo, local))


# -- cluster state -------------------------------------------------------------

def _mutate(st, rng_seed, window):
    """A seeded sequence of the controller's mutations, on one state."""
    rng = np.random.default_rng(rng_seed)
    n = st.replica_map.shape[0]
    for f in rng.choice(n, size=40, replace=False).tolist():
        st.apply_rf_target(int(f), int(rng.integers(1, 5)))
    for f in rng.choice(n, size=20, replace=False).tolist():
        t = st.pick_repair_target(int(f), rotate=int(rng.integers(0, 3)))
        if t >= 0:
            st.add_replica(int(f), t)
    for f in rng.choice(n, size=10, replace=False).tolist():
        st.drop_crowded(int(f))
    for f in rng.choice(n, size=15, replace=False).tolist():
        st.verify_sources(int(f))
    st.trim_excess(np.full(n, 2, dtype=np.int64))
    return [int(st.pick_repair_target(int(f), new_domain_only=True))
            for f in rng.choice(n, size=10, replace=False)]


@pytest.mark.parametrize("kind", TOPOLOGIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_state_matches_the_reference(kind, seed):
    st, rst = _states(kind, seed=seed)
    _assert_states_equal(st, rst)
    rng = np.random.default_rng(seed)
    target = rng.integers(1, 5, size=300).astype(np.int64)
    cat = rng.integers(-1, 4, size=300).astype(np.int64)
    steps = [["corrupt:dn1@0:0.5", "flaky:dn3@0:0.5"], ["crash:dn2@1", "degrade:dn4@1:0.25"],
             ["partition:dn5+dn6@2", "corrupt:dn3#7@2"], ["heal:dn5+dn6@3", "recover:dn2@3"],
             ["decommission:dn4@4", "restore:dn4@4", "corrupt:dn6@4:1.0"],
             ["crash:dn1@5", "unflaky:dn3@5"]]
    for w, specs in enumerate(steps):
        sched, rsched = _events(specs)
        for ev, rev in zip(sched.for_window(w), rsched.for_window(w)):
            st.apply_event(ev)
            rst.apply_event(rev)
        got_t = _mutate(st, 10 * seed + w, w)
        want_t = _mutate(rst, 10 * seed + w, w)
        assert got_t == want_t
        _assert_states_equal(st, rst)
        assert st.durability(target, cat, CATEGORIES) == rst.durability(target, cat, CATEGORIES)
        assert st.integrity() == rst.integrity()
        np.testing.assert_array_equal(st.correlated_mask(target), rst.correlated_mask(target))
        np.testing.assert_array_equal(st.unreadable_mask(), rst.unreadable_mask())
        v, rv = st.placement_view(), rst.placement_view()
        np.testing.assert_array_equal(v.replica_map, rv.replica_map)
        np.testing.assert_array_equal(v.rf, rv.rf)
        np.testing.assert_array_equal(v.storage_per_node, rv.storage_per_node)
        pid = rng.integers(0, 300, size=64)
        a, b = read_view(pid, state=st), ref_read_view(pid, state=rst)
        for field in ("replica_map", "slot_ok", "node_throughput", "pid"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert (a.slot_corrupt is None) == (b.slot_corrupt is None)
    # The checkpoint round trip rebuilds the caches.
    fresh, _ = _states(kind, seed=seed)
    fresh.load_state_arrays(st.state_arrays())
    _assert_states_equal(fresh, rst)


def test_cluster_state_guards():
    st, _ = _states("flat", n=20)
    with pytest.raises(ValueError, match="unknown node"):
        st.apply_event(faults.FaultEvent(0, "crash", "dn9"))
    with pytest.raises(ValueError, match="pins file 99"):
        st.apply_event(faults.FaultEvent(0, "corrupt", "dn1", file=99))
    other, _ = _states("flat", n=21)
    with pytest.raises(ValueError, match="stale checkpoint"):
        st.load_state_arrays(other.state_arrays())


# -- repair and scrub ------------------------------------------------------------

@pytest.mark.parametrize("kind", TOPOLOGIES)
@pytest.mark.parametrize("budget", ["none", "bytes", "files"])
def test_repair_and_scrub_windows_match_the_reference(kind, budget):
    st, rst = _states(kind, seed=5, rf=np.full(300, 2, dtype=np.int32))
    sizes = st.sizes
    limits = {"none": (None, None), "bytes": (int(sizes.max()) * 6, None),
              "files": (None, 25)}[budget]
    target = np.random.default_rng(5).integers(2, 4, size=300).astype(np.int64)
    cat = np.zeros(300, dtype=np.int64)
    rs, rrs = faults.RepairScheduler(seed=3), ref_faults.RepairScheduler(seed=3)
    sc = faults.Scrubber(300, faults.ScrubConfig(bytes_per_window=int(sizes.mean()) * 40))
    rsc = ref_faults.Scrubber(300, ref_faults.ScrubConfig(bytes_per_window=int(sizes.mean()) * 40))
    steps = [["corrupt:dn3@0:0.4", "flaky:dn1@0:0.6"], ["crash:dn2@1", "degrade:dn5@1:0.5"],
             ["partition:dn5+dn6@2"], ["heal:dn5+dn6@3", "recover:dn2@3"], []]
    for w, specs in enumerate(steps):
        sched, rsched = _events(specs)
        for ev, rev in zip(sched.for_window(w), rsched.for_window(w)):
            st.apply_event(ev)
            rst.apply_event(rev)
        rs.sync(st, target)
        rrs.sync(rst, target)
        rep = rs.schedule(w, st, target, cat, max_bytes=limits[0], max_files=limits[1])
        rrep = rrs.schedule(w, rst, target, cat, max_bytes=limits[0], max_files=limits[1])
        assert dataclasses.asdict(rep) == dataclasses.asdict(rrep)
        for k, v in rrs.state_arrays().items():
            np.testing.assert_array_equal(rs.state_arrays()[k], v)
        left = None if limits[0] is None else max(limits[0] - rep.bytes_used, 0)
        if w == 1:
            sc.add_hints([3, 50, 7])
            rsc.add_hints([3, 50, 7])
        srep = sc.run_window(w, st, shared_left=left)
        rsrep = rsc.run_window(w, rst, shared_left=left)
        assert dataclasses.asdict(srep) == dataclasses.asdict(rsrep)
        for k, v in rsc.state_arrays().items():
            np.testing.assert_array_equal(sc.state_arrays()[k], v)
        _assert_states_equal(st, rst)
    fresh = faults.RepairScheduler()
    fresh.load_state_arrays(rs.state_arrays())
    assert list(fresh.backlog.items()) == list(rs.backlog.items())


def test_migration_reservations_match_the_reference():
    rng = np.random.default_rng(9)
    n = 400
    sizes = rng.integers(1, 1000, size=n)
    rf_old, rf_new = rng.integers(1, 4, size=n), rng.integers(1, 4, size=n)
    cat_old, cat_new = rng.integers(-1, 4, size=n), rng.integers(0, 4, size=n)
    prio = rng.random(n)
    for max_bytes, max_files, reserved in ((5000, None, 0), (5000, None, 4000),
                                           (5000, 40, 300), (None, 40, 0), (None, 40, 40),
                                           (0, None, 0), (100, 10, 200)):
        sch = MigrationScheduler(n, max_bytes, max_files, hysteresis_windows=1)
        ref = RefScheduler(n, max_bytes, max_files, hysteresis_windows=1)
        sch.submit(plan_diff(rf_old, rf_new, cat_old, cat_new, sizes, priority=prio))
        ref.submit(ref_plan_diff(rf_old, rf_new, cat_old, cat_new, sizes, priority=prio))
        for w in range(4):
            kw = dict(bytes_reserved=reserved * (w % 2), files_reserved=min(reserved, 3) * w)
            got, want = sch.schedule(w, **kw), ref.schedule(w, **kw)
            np.testing.assert_array_equal(got.file_index, want.file_index)
            assert (sch.last_deferred_budget, sch.last_deferred_hysteresis) == \
                (ref.last_deferred_budget, ref.last_deferred_hysteresis)


def test_integrity_digest_matches_the_reference():
    rows = [{"window": 0},
            {"window": 1, "integrity": {"corrupt_copies": 4, "files_corrupt": 3,
                                        "true_lost": 1, "detected_scrub": 2,
                                        "detected_repair": 1, "detected_read": 0},
             "scrub": {"bytes": 10, "copies_verified": 3, "starved": True}},
            {"window": 2, "integrity": {"corrupt_copies": 0, "files_corrupt": 0,
                                        "true_lost": 0, "detected_scrub": 1}}]
    assert integrity_digest(rows) == ref_integrity_digest(rows)
    assert integrity_digest(rows[:1]) is None
