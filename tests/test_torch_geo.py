"""Geo hierarchies, region loss and elasticity on the port against ``cdrs_tpu``:
the counterparts of ``tests/test_geo.py``'s cases over the hash chooser,
the functional states, ``addition_moved`` and ``ElasticPolicy``.

Placements and state arrays are held bit for bit; the controllers run the
port on the CPU in float32 from the reference's cold init
(``carried_init``) against ``backend="jax"``, record for record (drift
scalars within 1e-6).
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.cluster import place_replicas as ref_place_replicas  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ElasticPolicy as RefPolicy  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.faults import ClusterState as RefState  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.faults import RepairScheduler as RefRepairs  # noqa: E402
from cdrs_tpu.placement_fn import addition_moved as ref_addition_moved  # noqa: E402
from cdrs_tpu.placement_fn import compute_placement as ref_compute  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServe  # noqa: E402
from cdrs_tpu.serve import SloSpec as RefSlo  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.access import simulate_flash_crowd as ref_flash  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402
from cdrs_tpu.storage import resolve_storage_config as ref_storage  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402

import cdrs_tpu_torch.config as pcfg  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas  # noqa: E402
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.control.elastic import ElasticPolicy  # noqa: E402
from cdrs_tpu_torch.faults import ClusterState, FaultSchedule, RepairScheduler  # noqa: E402
from cdrs_tpu_torch.placement_fn import compute_placement  # noqa: E402
from cdrs_tpu_torch.placement_fn.epoch import addition_moved  # noqa: E402
from cdrs_tpu_torch.scenarios import ScenarioSpec  # noqa: E402
from cdrs_tpu_torch.serve import ServeConfig, SloSpec  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access, simulate_flash_crowd  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402
from cdrs_tpu_torch.storage import resolve_storage_config  # noqa: E402

SEED = int(os.environ.get("CDRS_CHAOS_SEED", "0"))
NODES12 = tuple(f"dn{i}" for i in range(1, 13))
GEO = {"nodes": list(NODES12), "levels": ["rack", "region"],
       "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
       "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
       "edge_bytes": {"rack": 1.0, "region": 4.0},
       "edge_latency": {"rack": 1.5, "region": 8.0}}
#: The same nodes in racks only: the contrast without a region level.
FLAT = {"nodes": list(NODES12), "levels": ["rack"], "rack": GEO["rack"]}
EU = ("dn1", "dn2", "dn3", "dn4")
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
GROWN = {**GEO, "nodes": list(NODES12) + ["sb1", "sb2"],
         "rack": {**GEO["rack"], "rs0": ["sb1"], "rs1": ["sb2"]},
         "region": {"eu": ["r0", "r1", "rs0"], "us": ["r2", "r3", "rs1"], "ap": ["r4", "r5"]}}


def _rand_inputs(n=2000, rf_hi=6, seed=SEED):
    rng = np.random.default_rng(300 + seed)
    return (np.arange(n, dtype=np.int64), rng.integers(1, rf_hi, n).astype(np.int32),
            rng.integers(0, 12, n).astype(np.int32))


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


# -- the hierarchical chooser ------------------------------------------------------

def test_one_level_hierarchy_degenerates_to_racks_in_both_choosers():
    flat = ClusterTopology.from_hierarchy(FLAT)
    assert flat.levels == () and flat.n_levels == 0
    racks = ClusterTopology.from_racks(NODES12, dict(zip(flat.nodes, flat.domains)))
    man = generate_population(pcfg.GeneratorConfig(n_files=500, seed=30 + SEED, nodes=NODES12))
    rman = ref_generate(jcfg.GeneratorConfig(n_files=500, seed=30 + SEED, nodes=NODES12))
    rf = np.random.default_rng(SEED).integers(1, 5, 500).astype(np.int32)
    for method in ("rng", "hash"):
        a = place_replicas(man, rf, flat, seed=SEED, method=method)
        b = place_replicas(man, rf, racks, seed=SEED, method=method)
        want = ref_place_replicas(rman, rf, RefTopology.from_hierarchy(FLAT), seed=SEED,
                                  method=method)
        assert np.array_equal(a.replica_map, b.replica_map), method
        assert np.array_equal(a.replica_map, want.replica_map), method


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hierarchical_chooser_matches_the_reference(seed):
    """The geo fill equals the reference's (region-local mask included),
    and keeps its contracts: distinct nodes, the primary first, region
    counts within one, nested in rf, subsets equal to the full rows."""
    fids, rf, prim = _rand_inputs(seed=seed)
    topo, rtopo = ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)
    local = np.random.default_rng(seed + 1).random(len(fids)) < 0.5
    for mask in (None, local):
        full, rfc = compute_placement(fids, rf, prim, topo, seed, local_mask=mask)
        want, wrf = ref_compute(fids, rf, prim, rtopo, seed, local_mask=mask)
        assert np.array_equal(full, want) and np.array_equal(rfc, wrf)
    full, rfc = compute_placement(fids, rf, prim, topo, seed)
    dom_top = topo.top_domain_index()
    for i in range(len(fids)):
        row = full[i][full[i] >= 0]
        assert len(row) == rfc[i] == len(set(row.tolist())) and row[0] == prim[i]
        counts = np.bincount(dom_top[row], minlength=3)
        assert counts.max() - counts.min() <= 1
    lo, lo_rf = compute_placement(fids, np.maximum(rf - 1, 1), prim, topo, seed)
    assert all(np.array_equal(lo[i][:lo_rf[i]], full[i][:lo_rf[i]]) for i in range(len(fids)))
    sub = np.random.default_rng(seed).choice(len(fids), 137, replace=False)
    rows, _ = compute_placement(fids[sub], rf[sub], prim[sub], topo, seed,
                                out_width=full.shape[1], chunk=29)
    assert np.array_equal(rows, full[sub])
    slots, rfl = compute_placement(fids, rf, prim, topo, seed, local_mask=local)
    for i in np.flatnonzero(local):
        assert (dom_top[slots[i][slots[i] >= 0]] == dom_top[prim[i]]).all()
        assert rfl[i] == min(rf[i], 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_addition_moved_is_exact(seed):
    topo_old, topo_new = ClusterTopology.from_hierarchy(GEO), ClusterTopology.from_hierarchy(GROWN)
    fids, rf, prim = _rand_inputs(n=3000, seed=seed)
    moved = addition_moved(topo_old, topo_new, rf, prim, seed, chunk=700)
    want = ref_addition_moved(RefTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GROWN),
                              rf, prim, seed)
    assert np.array_equal(moved, want)
    old_s, _ = compute_placement(fids, rf, prim, topo_old, seed)
    new_s, _ = compute_placement(fids, rf, prim, topo_new, seed)
    brute = [i for i in range(len(fids))
             if {topo_old.nodes[x] for x in old_s[i] if x >= 0}
             != {topo_new.nodes[x] for x in new_s[i] if x >= 0}]
    assert np.array_equal(moved, np.asarray(brute, dtype=np.int64)) and len(brute) > 0
    with pytest.raises(ValueError, match="appended"):
        addition_moved(topo_new, topo_old, rf, prim, seed)


def test_wan_copy_charge_and_region_rebalance_match_the_reference():
    """On the hash placement: the in-region source wins the copy election,
    a cross-region copy pays the 4x WAN multiplier, and a file forced into
    one region is flagged at the region level and rebalanced out of it, as
    in the reference."""
    topo, rtopo = ClusterTopology.from_hierarchy(GEO), RefTopology.from_hierarchy(GEO)
    man = generate_population(pcfg.GeneratorConfig(n_files=60, seed=50 + SEED, nodes=NODES12))
    rman = ref_generate(jcfg.GeneratorConfig(n_files=60, seed=50 + SEED, nodes=NODES12))
    rf = np.full(60, 2, np.int32)
    st = ClusterState(place_replicas(man, rf, topo, seed=SEED, method="hash"),
                      np.asarray(man.size_bytes, np.int64))
    ref = RefState(ref_place_replicas(rman, rf, rtopo, seed=SEED, method="hash"),
                   np.asarray(rman.size_bytes, np.int64))
    charges = [[s.copy_charge(f, t) for f in range(0, 60, 7) for t in range(12)]
               for s in (st, ref)]
    assert charges[0] == charges[1]
    rf64, cat = rf.astype(np.int64), np.full(60, -1, np.int64)
    for s, sched in ((st, RepairScheduler(seed=SEED)), (ref, RefRepairs(seed=SEED))):
        for x in [int(v) for v in s.row(0) if v >= 0]:
            s.drop_replica(0, x)
        s.add_replica(0, 0)
        s.add_replica(0, 2)     # two racks of one region (eu)
        d = s.durability(rf64, cat, ("Hot",))
        assert d["correlated_risk_levels"]["region"] == 1
        only = int(topo.top_domain_index()[0])
        out_t = next(i for i in range(12) if int(topo.top_domain_index()[i]) != only)
        assert s.copy_charge(0, out_t) == int(np.ceil(int(s.shard_bytes[0]) * 4.0))
        sched.sync(s, rf64)
        assert sched.schedule(1, s, rf64, cat).rebalanced >= 1
        assert s.durability(rf64, cat, ("Hot",))["correlated_risk_levels"]["region"] == 0
    assert np.array_equal(st.replica_map, ref.replica_map)
    assert np.array_equal(st.node_bytes, ref.node_bytes)


# -- region loss ------------------------------------------------------------------

def _region_loss_cfg(mod, cls, topo_cls, sched_cls, storage_fn, spec, mode, storage, sizes,
                     **kw):
    specs = (["crash:region:eu@3-6"] if "region" in spec["levels"]
             else [f"crash:{n}@3-6" for n in EU])
    scoring = mod.validated_scoring_config()
    rfs = dict(scoring.replication_factors)
    rfs["Moderate"] = max(2, rfs["Moderate"])
    scoring = dataclasses.replace(scoring, replication_factors=rfs)
    return cls(window_seconds=120.0, default_rf=2, drift_threshold=0.02,
               max_bytes_per_window=int(sizes.sum() * 0.25),
               kmeans=mod.KMeansConfig(k=10, seed=42), scoring=scoring,
               topology=topo_cls.from_hierarchy(spec),
               fault_schedule=sched_cls.from_specs(specs), placement_mode=mode,
               storage=storage_fn("ec_archival", scoring) if storage else None, **kw)


@pytest.fixture(scope="module")
def geo_world():
    m = generate_population(pcfg.GeneratorConfig(n_files=300, seed=60 + SEED, nodes=NODES12))
    ev = simulate_access(m, pcfg.SimulatorConfig(duration_seconds=1200.0, seed=61 + SEED))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=300, seed=60 + SEED, nodes=NODES12))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=1200.0, seed=61 + SEED))
    return m, ev, rm, rev


def _port_region_loss(world, spec, mode, storage):
    m = world[0]
    return ReplicationController(m, _region_loss_cfg(
        pcfg, ControllerConfig, ClusterTopology, FaultSchedule, resolve_storage_config, spec,
        mode, storage, np.asarray(m.size_bytes, np.int64), device="cpu"))


@pytest.mark.parametrize("storage", [False, True], ids=["replicate", "ec"])
@pytest.mark.parametrize("mode", ["materialized", "functional"])
def test_region_loss_zero_lost_hier_vs_measurable_flat(geo_world, mode, storage):
    """A whole region crashed loses nothing under the hierarchy-aware
    placement and loses files on the racks-only topology (same node kill),
    in both modes; the hierarchy run equals the reference's."""
    m, ev, rm, rev = geo_world
    ctl = _port_region_loss(geo_world, GEO, mode, storage)
    with carried_init():
        hier = ctl.run(ev)
        flat = _port_region_loss(geo_world, FLAT, mode, storage).run(ev)
    ref = RefController(rm, _region_loss_cfg(
        jcfg, RefConfig, RefTopology, RefSchedule, ref_storage, GEO, mode, storage,
        np.asarray(rm.size_bytes, np.int64), backend="jax"))
    _assert_records_match(hier.records, ref.run(rev).records)
    hint = {"rf_hint": hier.rf} if mode == "functional" else {}
    got, want = ctl._cluster_state.state_arrays(**hint), ref._cluster_state.state_arrays(**hint)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert max(r["durability"]["lost"] for r in hier.records) == 0
    assert max(r["durability"]["lost"] for r in flat.records) > 0


def test_region_loss_functional_matches_oracle_and_resume(geo_world, tmp_path):
    m, ev, _, _ = geo_world
    with carried_init():
        fn = _port_region_loss(geo_world, GEO, "functional", True).run(ev)
        orc = _port_region_loss(geo_world, GEO, "materialized_hash", True).run(ev)
        ck = str(tmp_path / "c.npz")
        a = _port_region_loss(geo_world, GEO, "functional", True).run(
            ev, checkpoint_path=ck, max_windows=5)
        b = _port_region_loss(geo_world, GEO, "functional", True).run(ev, checkpoint_path=ck)
    assert _strip(fn.records, ("seconds", "placement")) == \
        _strip(orc.records, ("seconds", "placement"))
    assert np.array_equal(fn.rf, orc.rf)
    assert all(r["placement"]["mode"] == "functional" for r in fn.records)
    assert _strip(a.records) + _strip(b.records) == _strip(fn.records)
    assert np.array_equal(b.rf, fn.rf)


# -- elasticity -------------------------------------------------------------------

def test_elastic_policy_validation_and_growth():
    pol = ElasticPolicy(pool=({"name": "sb1", "domains": ("rs0", "eu")},))
    topo = ClusterTopology.from_hierarchy(GEO)
    pol.validate_against(topo)
    grown = pol.grown_topology(topo, ("sb1",))
    assert grown.nodes == topo.nodes + ("sb1",) and grown.domains[-1] == "rs0"
    assert grown.levels[0][1][-1] == "eu" and grown.edge_bytes == topo.edge_bytes
    ref = RefPolicy(pool=({"name": "sb1", "domains": ("rs0", "eu")},))
    assert pol.to_dict() == ref.to_dict()
    assert ElasticPolicy.from_dict(pol.to_dict()) == pol
    assert grown.to_hierarchy_dict() == ref.grown_topology(
        RefTopology.from_hierarchy(GEO), ("sb1",)).to_hierarchy_dict()
    assert pol.next_activation(()) == ("sb1",) and pol.next_activation(("sb1",)) == ()
    with pytest.raises(ValueError, match="declares 0 domains"):
        ElasticPolicy(pool=("sb9",)).validate_against(topo)
    with pytest.raises(ValueError, match="already exists"):
        ElasticPolicy(pool=({"name": "dn1", "domains": ("r0", "eu")},)).validate_against(topo)
    with pytest.raises(ValueError, match="non-empty pool"):
        ElasticPolicy(pool=())
    with pytest.raises(ValueError, match="unknown elastic policy keys"):
        ElasticPolicy.from_dict({"pool": ["sb1"], "hot": 3})
    with pytest.raises(ValueError, match="hash"):
        ScenarioSpec(name="x", serve={"policy": "p2c"}, elastic={"pool": ["sb1"]})


def test_elastic_scale_out_drain_and_resume(tmp_path):
    """Scale-out from SLO burn, a rebalance equal to the epoch diff inside
    the shared budget, the drain back to the baseline, and kill/resume
    across the scale-out, equal to the reference and to the oracle."""
    m = generate_population(pcfg.GeneratorConfig(n_files=300, seed=70 + SEED))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=300, seed=70 + SEED))
    cohort = np.asarray([c == "hot" for c in m.category])
    ev, _ = simulate_flash_crowd(m, pcfg.SimulatorConfig(duration_seconds=1800.0, seed=71 + SEED),
                                 cohort=cohort, start=450.0, duration=540.0, boost=25.0)
    rev, _ = ref_flash(rm, jcfg.SimulatorConfig(duration_seconds=1800.0, seed=71 + SEED),
                       cohort=cohort, start=450.0, duration=540.0, boost=25.0)
    mb = int(np.asarray(m.size_bytes, np.int64).sum() * 0.25)
    knobs = dict(burn_hot=1.0, util_hot=0.9, hot_windows=2, util_cool=0.5, cool_windows=2,
                 drain_spacing=1)

    def cfg(mod, cls, pol, serve, slo, mode, **kw):
        return cls(window_seconds=120.0, default_rf=2, drift_threshold=0.02,
                   max_bytes_per_window=mb, kmeans=mod.KMeansConfig(k=8, seed=42),
                   scoring=mod.validated_scoring_config(), placement_mode=mode,
                   elastic=pol(pool=("sb1", "sb2", "sb3"), **knobs),
                   serve=serve(policy="p2c", service_ms=6.0, slo=slo(target_ms=60.0)), **kw)

    def run(mode, ck=None, maxw=None):
        ctl = ReplicationController(m, cfg(pcfg, ControllerConfig, ElasticPolicy, ServeConfig,
                                           SloSpec, mode, device="cpu"))
        return ctl.run(ev, checkpoint_path=ck, max_windows=maxw)

    with carried_init():
        fn = run("functional")
        orc = run("materialized_hash")
        ck = str(tmp_path / "c.npz")
        a = run("functional", ck=ck, maxw=8)
        b = run("functional", ck=ck)
    want = RefController(rm, cfg(jcfg, RefConfig, RefPolicy, RefServe, RefSlo, "functional",
                                 backend="jax")).run(rev)
    _assert_records_match(fn.records, want.records)
    el = [r.get("elastic") or {} for r in fn.records]
    assert any("added" in e for e in el)
    moved = sum(e.get("moved", 0) for e in el)
    assert moved == sum(e.get("rebalanced", 0) for e in el) > 0
    assert el[-1].get("queue", 0) == 0
    assert [n for e in el for n in e.get("drained", ())] == ["sb1", "sb2", "sb3"]
    assert fn.records[-1]["durability"]["nodes_up"] == 3
    assert all(r.get("repair_bytes", 0) + r["bytes_migrated"]
               + (r.get("elastic") or {}).get("rebalance_bytes", 0) <= mb for r in fn.records)
    assert _strip(fn.records, ("seconds", "placement")) == \
        _strip(orc.records, ("seconds", "placement"))
    assert _strip(a.records) + _strip(b.records) == _strip(fn.records)
    # The kill lands after the scale-out: the resume replays the growth.
    assert any("added" in (r.get("elastic") or {}) for r in a.records)


# -- the CLI ----------------------------------------------------------------------

@pytest.mark.parametrize("command", ["chaos", "daemon"])
def test_cli_functional_placement_matches_the_reference(command, tmp_path, monkeypatch):
    """``chaos``/``daemon --placement functional`` on the 12-node geo
    topology with a region crash, serving and a checkpoint: the summary
    (digest) equals ``cdrs_tpu``'s at ``--backend jax`` apart from the
    wall-clock fields, and a rerun resumes from the sparse checkpoint."""
    import io
    import json
    from contextlib import redirect_stdout

    from cdrs_tpu.cli import main as reference_main

    from cdrs_tpu_torch import cli as port_cli

    monkeypatch.chdir(tmp_path)
    assert port_cli.main(["gen", "--n", "200", "--seed", "5", "--nodes", ",".join(NODES12),
                          "--out_manifest", "m.csv"]) == 0
    assert port_cli.main(["simulate", "--manifest", "m.csv", "--out", "a.cdrsb",
                          "--duration_seconds", "300", "--seed", "6"]) == 0
    (tmp_path / "topo.json").write_text(json.dumps(GEO))
    args = [command, "--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds",
            "60", "--k", "4", "--scoring_config", "validated", "--default_rf", "2",
            "--placement", "functional", "--serve"]
    if command == "chaos":
        args += ["--topology", "topo.json", "--kill", "region:eu@2-3"]
    wall = ("seconds", "windows_per_sec", "plan_seconds_fraction", "checkpoint",
            "decision_p50_seconds", "decision_p99_seconds")
    outs = []
    with carried_init():
        for main, extra, ck in ((port_cli.main, ["--device", "cpu"], "p.npz"),
                                (reference_main, ["--backend", "jax"], "r.npz")):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert main(args + extra + ["--checkpoint", ck]) == 0
            outs.append({k: v for k, v in json.loads(buf.getvalue()).items() if k not in wall})
    got, want = outs
    assert got == want
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port_cli.main(args + ["--device", "cpu", "--checkpoint", "p.npz"]) == 0
    again = json.loads(buf.getvalue())
    assert again.get("windows", again.get("windows_processed")) == 0
