"""Functional placement on the port (``cdrs_tpu_torch.placement_fn``, the hash
chooser of ``cluster.placement``, the functional states, the epoch diff and
the controller's ``functional``/``materialized_hash`` modes) against
``cdrs_tpu``: the counterparts of ``tests/test_placement_fn.py``'s cases.

Placements, epoch diffs and ``state_arrays()`` are held bit for bit; the
controllers run the port on the CPU in float32 from the reference's cold
init (``carried_init``) against ``backend="jax"`` and are held record for
record (drift scalars within 1e-6) at seeds 0, 1 and 2.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.cluster import place_replicas as ref_place_replicas  # noqa: E402
from cdrs_tpu.cluster import place_stripes as ref_place_stripes  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.faults import FaultEvent as RefEvent  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.placement_fn import EpochMap as RefEpochMap  # noqa: E402
from cdrs_tpu.placement_fn import FunctionalClusterState as RefFunctional  # noqa: E402
from cdrs_tpu.placement_fn import OverlayClusterState as RefOverlay  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServe  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402

import cdrs_tpu_torch.config as pcfg  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas, \
    place_stripes, primary_on_topology  # noqa: E402
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.faults import FaultEvent, FaultSchedule  # noqa: E402
from cdrs_tpu_torch.placement_fn import EpochMap, compute_placement  # noqa: E402
import cdrs_tpu_torch.placement_fn.state as fn_state  # noqa: E402
from cdrs_tpu_torch.placement_fn.state import FunctionalClusterState, \
    OverlayClusterState  # noqa: E402
from cdrs_tpu_torch.serve import ServeConfig  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

NODES6 = tuple(f"dn{i}" for i in range(1, 7))
RACKS6 = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
NODES12 = tuple(f"dn{i}" for i in range(1, 13))
GEO = {"nodes": list(NODES12), "levels": ["rack", "region"],
       "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
       "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
       "edge_bytes": {"rack": 1.0, "region": 4.0},
       "edge_latency": {"rack": 1.5, "region": 8.0}}
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")


def _topologies(kind):
    """(port, reference) topology of one kind: flat, racks or geo."""
    if kind == "flat":
        return ClusterTopology(NODES6), RefTopology(NODES6)
    if kind == "racks":
        return (ClusterTopology.from_rack_spec(NODES6, RACKS6),
                RefTopology.from_rack_spec(NODES6, RACKS6))
    return ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)


def _populations(n, seed, nodes):
    return (generate_population(pcfg.GeneratorConfig(n_files=n, seed=seed, nodes=nodes)),
            ref_generate(jcfg.GeneratorConfig(n_files=n, seed=seed, nodes=nodes)))


def _arrays_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


# -- the hash chooser -----------------------------------------------------------------

@pytest.mark.parametrize("kind,local", [("flat", False), ("racks", False), ("geo", False),
                                        ("geo", True)])
def test_place_replicas_hash_matches_the_reference(kind, local):
    topo, rtopo = _topologies(kind)
    m, rm = _populations(600, 14, topo.nodes)
    rng = np.random.default_rng(3)
    rf = rng.integers(1, 7, len(m)).astype(np.int32)
    mask = rng.random(len(m)) < 0.4 if local else None
    got = place_replicas(m, rf, topo, seed=5, method="hash", local_mask=mask)
    want = ref_place_replicas(rm, rf, rtopo, seed=5, method="hash", local_mask=mask)
    assert np.array_equal(got.replica_map, want.replica_map)
    assert np.array_equal(got.rf, want.rf)
    assert np.array_equal(got.storage_per_node, want.storage_per_node)
    shard_bytes = np.asarray(m.size_bytes, dtype=np.int64) // 3 + 1
    gs = place_stripes(m, rf, topo, seed=5, shard_bytes=shard_bytes, method="hash",
                       local_mask=mask)
    ws = ref_place_stripes(rm, rf, rtopo, seed=5, shard_bytes=shard_bytes, method="hash",
                           local_mask=mask)
    assert np.array_equal(gs.replica_map, ws.replica_map)
    assert np.array_equal(gs.storage_per_node, ws.storage_per_node)


def test_unknown_placement_method_raises():
    m, _ = _populations(20, 1, NODES6)
    with pytest.raises(ValueError, match="'rng' or 'hash'"):
        place_replicas(m, np.full(20, 2), ClusterTopology(NODES6), method="crush")


@pytest.mark.parametrize("kind,local", [("flat", False), ("racks", False), ("geo", False),
                                        ("geo", True)])
def test_single_row_memo_is_the_computed_row(kind, local):
    """A functional state's one-file rows (a prefix of the file's whole
    computed order) equal ``compute_placement`` at every shard count."""
    topo, _ = _topologies(kind)
    m, _ = _populations(300, 15, topo.nodes)
    prim = primary_on_topology(m.nodes, m.primary_node_id, topo)
    st = OverlayClusterState.from_base(topo, np.asarray(m.size_bytes, dtype=np.int64),
                                       n_shards=np.full(len(m), 2), primary=prim, seed=7)
    if local:
        st.region_local[::3] = True
    fids = np.arange(len(m), dtype=np.int64)
    st.prefetch_rows(fids[::2])     # half from one pass, half one by one
    for s in range(0, len(topo.nodes) + 2):
        want, _ = compute_placement(fids, np.full(len(m), s), prim, topo, 7,
                                    out_width=len(topo.nodes),
                                    local_mask=st.region_local if local else None)
        got = np.stack([st._fn_base_row(int(f), s) for f in fids])
        assert np.array_equal(got, want), s


# -- the epoch diff ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_diff_matches_the_reference(seed):
    m, rm = _populations(3000, 14 + seed, NODES6)
    shards = np.random.default_rng(seed).integers(1, 5, len(m)).astype(np.int32)
    topo, rtopo = _topologies("racks")
    emap, remap = EpochMap(m.nodes, topo, seed=0), RefEpochMap(rm.nodes, rtopo, seed=0)
    assert len(emap.diff(0, 0, shards, m.primary_node_id)) == 0
    emap.advance(ClusterTopology(topo.nodes, topo.domains))
    remap.advance(RefTopology(rtopo.nodes, rtopo.domains))
    assert len(emap.diff(0, 1, shards, m.primary_node_id)) == 0
    survivors = tuple(x for x in NODES6 if x != "dn4")
    spec = "r0=dn1,dn2;r1=dn3;r2=dn5,dn6"
    emap.advance(ClusterTopology.from_rack_spec(survivors, spec))
    remap.advance(RefTopology.from_rack_spec(survivors, spec))
    # A rack move of a survivor is no pure removal: the full compare runs.
    emap.advance(ClusterTopology.from_rack_spec(survivors, "r0=dn1,dn2,dn3;r2=dn5,dn6"))
    remap.advance(RefTopology.from_rack_spec(survivors, "r0=dn1,dn2,dn3;r2=dn5,dn6"))
    for old, new, prune in ((0, 2, True), (0, 2, False), (0, 3, True), (2, 0, True)):
        got = emap.diff(old, new, shards, m.primary_node_id, prune=prune, chunk=1000)
        want = remap.diff(old, new, shards, rm.primary_node_id, prune=prune, chunk=1000)
        assert got.pruned == want.pruned and got.n_checked == want.n_checked
        for f in ("moved", "old_slots", "new_slots"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), (old, new, f)
    pruned = emap.diff(0, 2, shards, m.primary_node_id)
    full = emap.diff(0, 2, shards, m.primary_node_id, prune=False)
    assert pruned.pruned and not full.pruned and len(pruned) > 0
    assert np.array_equal(np.sort(pruned.moved), np.sort(full.moved))


# -- the functional states -------------------------------------------------------------

def _states(kind, n=400, seed=0, rf=None, overlay=True):
    """(port state, reference state) over the same hash placement."""
    topo, rtopo = _topologies(kind)
    m, rm = _populations(n, 14 + seed, topo.nodes)
    if rf is None:
        rf = np.random.default_rng(seed).integers(2, 4, len(m)).astype(np.int32)
    prim = primary_on_topology(m.nodes, m.primary_node_id, topo)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    if overlay:
        return (OverlayClusterState.from_base(topo, sizes, n_shards=rf, primary=prim),
                RefOverlay.from_base(rtopo, sizes, n_shards=rf, primary=prim), rf)
    return (FunctionalClusterState(place_replicas(m, rf, topo, method="hash"), sizes,
                                   primary=prim),
            RefFunctional(ref_place_replicas(rm, rf, rtopo, method="hash"), sizes,
                          primary=prim), rf)


def _damage(state, event_cls, seed, n):
    """The reference test's damage (a crash, rf retargets, rot), a strategy
    re-encode, a repair-style add and a decommission, in one order."""
    rng = np.random.default_rng(seed)
    state.apply_event(event_cls(0, "crash", "dn3"))
    for f in rng.integers(0, n, 40):
        state.apply_rf_target(int(f), int(rng.integers(1, 5)))
    state.apply_event(event_cls(1, "corrupt", "dn2", fail_prob=0.3))
    for f in rng.integers(0, n, 10):
        state.apply_strategy_target(int(f), 2, int(state.sizes[f]) // 2 + 1, 2, 3)
    for f in rng.integers(0, n, 10):     # region-local copies (geo only)
        state.apply_strategy_target(int(f), 1, int(state.sizes[f]), 0, 3,
                                    region_local=state.topology.n_levels > 0)
    for f in rng.integers(0, n, 20):
        t = state.pick_repair_target(int(f))
        if t >= 0:
            state.add_replica(int(f), t)
    state.verify_sources(int(rng.integers(0, n)))
    state.apply_event(event_cls(2, "decommission", "dn5"))
    state.trim_excess(np.full(n, 2))


@pytest.mark.parametrize("overlay", [False, True], ids=["functional", "overlay"])
@pytest.mark.parametrize("kind", ["racks", "geo"])
def test_functional_state_sparse_roundtrip_matches_the_reference(kind, overlay):
    st, ref, rf = _states(kind, overlay=overlay)
    n = len(rf)
    _damage(st, FaultEvent, 0, n)
    _damage(ref, RefEvent, 0, n)
    arrays = st.state_arrays(rf_hint=rf)
    _arrays_equal(arrays, ref.state_arrays(rf_hint=rf))
    _arrays_equal(st.state_arrays(), ref.state_arrays())
    assert np.array_equal(st.exception_fids(), ref.exception_fids())
    assert st.exception_fids().size > 0
    arrays["current_rf"] = rf
    fresh, _, _ = _states(kind, overlay=overlay)
    fresh.load_state_arrays(arrays)
    for attr in ("replica_map", "slot_corrupt", "min_live", "shard_bytes", "ec_k",
                 "installed_shards", "node_up", "node_bytes", "_live_counts",
                 "_reach_counts", "_dom_spread"):
        assert np.array_equal(getattr(fresh, attr), getattr(st, attr)), attr
    assert fresh._n_corrupt == st._n_corrupt
    assert np.array_equal(fresh.exception_fids(), st.exception_fids())


def test_overlay_equals_the_dense_functional_state():
    """The overlay (no dense map) and the dense functional state make the
    same mutations from the same calls."""
    ov, _, rf = _states("geo", overlay=True)
    dense, _, _ = _states("geo", overlay=False)
    for st in (ov, dense):
        _damage(st, FaultEvent, 1, len(rf))
    for attr in ("replica_map", "slot_corrupt", "node_bytes", "_live_counts",
                 "_reach_counts", "_dom_spread", "_top_spread"):
        assert np.array_equal(getattr(ov, attr), getattr(dense, attr)), attr
    _arrays_equal(ov.state_arrays(rf_hint=rf), dense.state_arrays(rf_hint=rf))
    assert np.array_equal(ov.assigned_counts(), dense.assigned_counts())
    assert ov.region_local.any()
    uniq = np.arange(0, len(rf), 7)
    rows, ok, corrupt = ov.read_rows(uniq)
    assert np.array_equal(rows, dense.replica_map[uniq])
    assert np.array_equal(ok, dense.reachable_mask()[uniq])
    assert np.array_equal(corrupt, dense.slot_corrupt[uniq])


@pytest.mark.parametrize("overlay", [False, True], ids=["functional", "overlay"])
def test_healthy_retargets_stay_in_base_form(overlay):
    st, ref, rf = _states("racks", overlay=overlay)
    rng = np.random.default_rng(0)
    for f, r in zip(rng.integers(0, len(rf), 100), rng.integers(1, 5, 100)):
        st.apply_rf_target(int(f), int(r))
        ref.apply_rf_target(int(f), int(r))
    assert st.exception_fids().size == 0 == ref.exception_fids().size
    assert np.array_equal(st.installed_shards, ref.installed_shards)
    assert np.array_equal(st.replica_map, ref.replica_map)


def test_grow_pin_and_retarget_match_the_reference():
    """Elastic growth on both states: the moved rows pinned, the topology
    grown, half the moved files retargeted to their new computed rows."""
    from cdrs_tpu.control import ElasticPolicy as RefPolicy
    from cdrs_tpu.placement_fn import addition_moved as ref_addition_moved

    from cdrs_tpu_torch.control.elastic import ElasticPolicy
    from cdrs_tpu_torch.placement_fn.epoch import addition_moved

    st, ref, rf = _states("geo", overlay=True)
    pool = ({"name": "sb1", "domains": ("rs0", "eu")}, {"name": "sb2", "domains": ("rs1", "us")})
    topo_new = ElasticPolicy(pool=pool).grown_topology(st.topology, ("sb1", "sb2"))
    rtopo_new = RefPolicy(pool=pool).grown_topology(ref.topology, ("sb1", "sb2"))
    moved = addition_moved(st.topology, topo_new, st.installed_shards, st._fn_primary)
    assert np.array_equal(moved, ref_addition_moved(ref.topology, rtopo_new,
                                                    ref.installed_shards, ref._fn_primary))
    assert moved.size > 0
    for s, t in ((st, topo_new), (ref, rtopo_new)):
        s.apply_event(FaultEvent(0, "corrupt", "dn1", fail_prob=0.5) if s is st
                      else RefEvent(0, "corrupt", "dn1", fail_prob=0.5))
        s.pin_rows(moved)
        s.grow(t)
        for f in moved[::2].tolist():
            s.retarget_row(f, s._fn_base_rows(np.asarray([f]))[0])
    _arrays_equal(st.state_arrays(rf_hint=rf), ref.state_arrays(rf_hint=rf))
    assert st._fn_epoch == ref._fn_epoch == 1
    assert np.array_equal(st.node_bytes, ref.node_bytes)


def test_overlay_state_holds_no_dense_map():
    st, _, _ = _states("geo", rf=np.full(400, 3, np.int32))
    assert "replica_map" not in st.__dict__ and "slot_corrupt" not in st.__dict__
    big = [k for k, v in vars(st).items()
           if isinstance(v, np.ndarray) and v.size >= 400 * len(st.nodes)]
    assert big == []
    assert st.exception_fids().size == 0
    st.apply_rf_target(5, 4)
    assert st.exception_fids().size == 0
    st.apply_event(FaultEvent(0, "decommission", "dn1"))
    exc = st.exception_fids()
    assert exc.size > 0
    base = st._fn_base_rows(exc)
    assert ((st.replica_map[exc] != base).any(axis=1)).all()


# -- the controller's placement modes -------------------------------------------------

def _cfg(mod, cls, topo_cls, sched_cls, serve_cls, mode, faults=True, **kw):
    return cls(window_seconds=120.0, default_rf=2, drift_threshold=0.02,
               kmeans=mod.KMeansConfig(k=8, seed=42), scoring=mod.validated_scoring_config(),
               topology=topo_cls.from_rack_spec(NODES6, RACKS6) if faults else None,
               fault_schedule=sched_cls.from_specs(["crash:dn3@2-4"]) if faults else None,
               placement_mode=mode, serve=serve_cls(policy="p2c"), **kw)


def _port_ctl(m, mode, **kw):
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    return ReplicationController(m, _cfg(pcfg, ControllerConfig, ClusterTopology,
                                         FaultSchedule, ServeConfig, mode, device="cpu",
                                         max_bytes_per_window=int(sizes.sum() * 0.25), **kw))


def _ref_ctl(m, mode, **kw):
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    return RefController(m, _cfg(jcfg, RefConfig, RefTopology, RefSchedule, RefServe, mode,
                                 backend="jax", max_bytes_per_window=int(sizes.sum() * 0.25),
                                 **kw))


def _strip(records, drop=("seconds",)):
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def _assert_records_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        for key in w:
            if key == "seconds":
                continue
            if key in DRIFT_KEYS and w[key] is not None:
                assert abs(g[key] - w[key]) <= 1e-6, (w["window"], key)
            else:
                assert g[key] == w[key], (w["window"], key, g[key], w[key])


@pytest.fixture(scope="module", params=[0, 1, 2])
def chaos_world(request):
    seed = request.param
    m, rm = _populations(300, 14 + seed, NODES6)
    cfg = pcfg.SimulatorConfig(duration_seconds=720.0, seed=15 + seed)
    ev = simulate_access(m, cfg)
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=720.0, seed=15 + seed))
    return seed, m, ev, rm, rev


@pytest.mark.parametrize("mode", ["functional", "materialized_hash"])
def test_placement_mode_matches_the_reference(chaos_world, mode):
    """Every record (durability tiers, repairs, plan hashes, serving, the
    ``placement`` stamp), the final plan and ``state_arrays()`` equal the
    reference's in the same mode, and functional equals its oracle."""
    _, m, ev, rm, rev = chaos_world
    ctl = _port_ctl(m, mode)
    with carried_init():
        got = ctl.run(ev)
    ref = _ref_ctl(rm, mode)
    want = ref.run(rev)
    _assert_records_match(got.records, want.records)
    assert np.array_equal(got.rf, want.rf)
    assert np.array_equal(got.category_idx, want.category_idx)
    hint = {"rf_hint": got.rf} if mode == "functional" else {}
    _arrays_equal(ctl._cluster_state.state_arrays(**hint),
                  ref._cluster_state.state_arrays(**hint))
    assert all(r["placement"]["mode"] == mode for r in got.records)
    assert all(("exceptions" in r["placement"]) == (mode == "functional")
               for r in got.records)
    assert any(r["repair_moves"] for r in got.records)


@pytest.mark.parametrize("memo_max", [0, 7])
def test_memo_off_or_overflowing_matches_the_reference(monkeypatch, memo_max):
    """The single-row memo turned off (``_MEMO_MAX`` 0), or so small that it
    starts over every few files, changes no decision: the functional
    controller still equals the reference in every record and in
    ``state_arrays()``."""
    m, rm = _populations(300, 14, NODES6)
    ev = simulate_access(m, pcfg.SimulatorConfig(duration_seconds=720.0, seed=15))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=720.0, seed=15))
    monkeypatch.setattr(fn_state, "_MEMO_MAX", memo_max)
    overflows = []
    room = FunctionalClusterState._fn_memo_room

    def counted_room(self, n):
        if memo_max and len(self._fn_memo) + n > memo_max:
            overflows.append(n)
        return room(self, n)

    monkeypatch.setattr(FunctionalClusterState, "_fn_memo_room", counted_room)
    ctl = _port_ctl(m, "functional")
    with carried_init():
        got = ctl.run(ev)
    ref = _ref_ctl(rm, "functional")
    want = ref.run(rev)
    _assert_records_match(got.records, want.records)
    _arrays_equal(ctl._cluster_state.state_arrays(rf_hint=got.rf),
                  ref._cluster_state.state_arrays(rf_hint=got.rf))
    assert any(r["repair_moves"] for r in got.records)
    if memo_max:
        assert len(overflows) > 10
    else:
        assert not ctl._cluster_state._fn_memo


def test_functional_kill_resume_and_mode_mismatch(chaos_world, tmp_path):
    _, m, ev, _, _ = chaos_world
    with carried_init():
        full = _port_ctl(m, "functional").run(ev)
        oracle = _port_ctl(m, "materialized_hash").run(ev)
        ck = str(tmp_path / "c.npz")
        a = _port_ctl(m, "functional").run(ev, checkpoint_path=ck, max_windows=3)
        b = _port_ctl(m, "functional").run(ev, checkpoint_path=ck)
        with pytest.raises(ValueError, match="placement"):
            _port_ctl(m, "materialized_hash").run(ev, checkpoint_path=ck)
        with pytest.raises(ValueError, match="placement"):
            _port_ctl(m, "materialized").run(ev, checkpoint_path=ck)
    assert _strip(a.records) + _strip(b.records) == _strip(full.records)
    assert np.array_equal(b.rf, full.rf)
    assert a.checkpoints and a.checkpoints[-1]["bytes"] > 0
    drop = ("seconds", "placement")
    assert _strip(full.records, drop) == _strip(oracle.records, drop)


def test_functional_serve_without_faults_matches_the_reference():
    """No fault path: reads resolve through ``_fn_static_rows`` (only the
    window's files), routed as over the oracle's full map and as the
    reference's."""
    m, rm = _populations(300, 21, NODES6)
    ev = simulate_access(m, pcfg.SimulatorConfig(duration_seconds=600.0, seed=22))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=600.0, seed=22))
    with carried_init():
        fn = _port_ctl(m, "functional", faults=False).run(ev)
        orc = _port_ctl(m, "materialized_hash", faults=False).run(ev)
    want = _ref_ctl(rm, "functional", faults=False).run(rev)
    _assert_records_match(fn.records, want.records)
    assert _strip(fn.records, ("seconds", "placement")) == \
        _strip(orc.records, ("seconds", "placement"))
    assert all(r["placement"] == {"mode": "functional", "epoch": 0} for r in fn.records)


@pytest.mark.parametrize("mode,match", [("crush", "unknown placement_mode"),
                                        ("materialized", "hash placement")])
def test_placement_config_validation(mode, match):
    from cdrs_tpu_torch.control.elastic import ElasticPolicy

    with pytest.raises(ValueError, match=match):
        ControllerConfig(placement_mode=mode, serve=ServeConfig(),
                         elastic=ElasticPolicy(pool=("sb1",)))
    with pytest.raises(ValueError, match="elastic requires serve"):
        ControllerConfig(placement_mode="functional", elastic=ElasticPolicy(pool=("sb1",)))
