"""The storage controller (``ControllerConfig.storage``) against ``cdrs_tpu``'s
``backend="jax"`` controller: the cases of the reference's
``tests/test_storage.py`` that run a controller, its daemon, and the chaos
CLI with ``--storage_config``.

The port runs on the CPU in float32, its cold re-clusters starting from the
reference's D² init of the same snapshot (``carried_init``, as the scenario
parity tests do).  Every window record is equal (the ``storage`` record,
``storage_conversions_retried`` and the plan hashes included; drift scalars
within 1e-6), and so are the final plan and ``ClusterState.state_arrays()``.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu import cli as ref_cli  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServe  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402
from cdrs_tpu.storage import Strategy as RefStrategy  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402

import cdrs_tpu_torch.config as pcfg  # noqa: E402
from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.daemon import StreamDaemon  # noqa: E402
from cdrs_tpu_torch.faults import FaultSchedule  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import storage_digest  # noqa: E402
from cdrs_tpu_torch.serve import ReadRouter, ServeConfig  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402
from cdrs_tpu_torch.storage import Strategy  # noqa: E402

NODES = tuple(f"dn{i}" for i in range(1, 13))
RACK_SPEC = "r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;r2=dn7,dn8,dn9;r3=dn10,dn11,dn12"
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
RACK_KILL = [f"crash:dn{i}@3" for i in (4, 5, 6)]
#: 7 of 12 nodes behind a partition for the whole run: 5 reachable < k = 6.
LONG_PARTITION = ["partition:" + "+".join(f"dn{i}" for i in range(6, 13)) + "@0-9999"]


def _min_rf2(mod):
    base = mod.validated_scoring_config()
    rf = dict(base.replication_factors)
    rf["Moderate"] = max(2, rf["Moderate"])
    return dataclasses.replace(base, replication_factors=rf)


@pytest.fixture(scope="module")
def workload():
    """``tests/test_storage.py``'s workload in both packages."""
    m = generate_population(GeneratorConfig(n_files=160, seed=71, nodes=NODES))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=600.0, seed=72))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=160, seed=71, nodes=NODES))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=600.0, seed=72))
    return m, ev, rm, rev


STORAGES = {
    None: lambda mod, sc: None,
    "replicate": lambda mod, sc: mod.StorageConfig.from_scoring(sc),
    "ec_archival": lambda mod, sc: mod.StorageConfig.ec_archival(sc),
}


def _cfg(mod, cls, serve_cls, topo_cls, sched_cls, storage, faults, serve, **kw):
    sc = _min_rf2(mod)
    if isinstance(storage, str) or storage is None:
        storage = STORAGES[storage]
    return cls(window_seconds=60.0, default_rf=2, kmeans=mod.KMeansConfig(k=8, seed=42),
               scoring=sc, fault_schedule=None if faults is None else sched_cls.from_specs(
                   faults),
               topology=topo_cls.from_rack_spec(NODES, RACK_SPEC) if faults else None,
               serve=None if serve is None else serve_cls(**serve),
               storage=storage(_storage_mod(mod), sc), **kw)


def _storage_mod(mod):
    """The storage module of the package whose config module is ``mod``."""
    import cdrs_tpu.storage as rs
    import cdrs_tpu_torch.storage as ps

    return ps if mod is pcfg else rs


def _port(m, storage=None, faults=None, serve=None, **kw):
    return ReplicationController(m, _cfg(pcfg, ControllerConfig, ServeConfig, ClusterTopology,
                                         FaultSchedule, storage, faults, serve, device="cpu",
                                         **kw))


def _ref(m, storage=None, faults=None, serve=None, **kw):
    return RefController(m, _cfg(jcfg, RefConfig, RefServe, RefTopology, RefSchedule,
                                 storage, faults, serve, backend="jax", **kw))


def _strip(records, drop=("seconds",)):
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


def _assert_records_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        for key in w:
            if key == "seconds":
                assert set(g[key]) == set(w[key])
            elif key in DRIFT_KEYS and w[key] is not None:
                assert abs(g[key] - w[key]) <= 1e-6, (w["window"], key, g[key], w[key])
            else:
                assert g[key] == w[key], (w["window"], key, g[key], w[key])


def _assert_states_match(got_ctl, want_ctl):
    ga = got_ctl._cluster_state.state_arrays()
    wa = want_ctl._cluster_state.state_arrays()
    assert set(ga) == set(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype and np.array_equal(ga[k], wa[k]), k
    assert np.array_equal(got_ctl._installed_cat, want_ctl._installed_cat)


def _run_pair(workload, storage, faults=None, serve=None, **kw):
    m, ev, rm, rev = workload
    gc, wc = _port(m, storage, faults, serve, **kw), _ref(rm, storage, faults, serve, **kw)
    with carried_init():
        got = gc.run(ev)
    want = wc.run(rev)
    _assert_records_match(got.records, want.records)
    assert np.array_equal(got.rf, want.rf) and np.array_equal(got.category_idx,
                                                              want.category_idx)
    if faults is not None:
        _assert_states_match(gc, wc)
    g, w = got.summary(), want.summary()
    assert g.get("storage") == w.get("storage")
    assert g["final_plan_hash"] == w["final_plan_hash"]
    return gc, got


# -- the controller against the reference ---------------------------------------------

@pytest.mark.parametrize("storage", ["replicate", "ec_archival"])
@pytest.mark.parametrize("faults", [None, RACK_KILL], ids=["plain", "rack-kill"])
def test_storage_controller_matches_the_reference(workload, storage, faults):
    _, got = _run_pair(workload, storage, faults)
    assert all("storage" in r for r in got.records)
    if faults:
        assert all("storage_conversions_retried" in r for r in got.records)


def test_all_replicate_config_is_bit_identical(workload):
    """A replicate-only config gives the records, plan and state arrays of
    a run without storage, plus the ``storage`` record."""
    m, ev, _, _ = workload
    with carried_init():
        base_ctl = _port(m, None, RACK_KILL)
        base = base_ctl.run(ev)
        rep_ctl = _port(m, "replicate", RACK_KILL)
        rep = rep_ctl.run(ev)
    drop = ("seconds", "storage", "storage_conversions_retried")
    assert _strip(base.records, drop) == _strip(rep.records, drop)
    assert np.array_equal(base.rf, rep.rf) and np.array_equal(base.category_idx,
                                                              rep.category_idx)
    ba, ra = base_ctl._cluster_state.state_arrays(), rep_ctl._cluster_state.state_arrays()
    assert all(np.array_equal(ba[k], ra[k]) for k in ba)
    assert rep.records[-1]["storage"]["ec_files"] == 0
    assert rep.records[-1]["storage"]["bytes_stored"] > 0


def test_ec_rack_kill_zero_lost_and_cheaper(workload):
    m, ev, _, _ = workload
    with carried_init():
        ec = _port(m, "ec_archival", RACK_KILL).run(ev)
        rf4 = _port(m, "replicate", RACK_KILL).run(ev)
    assert max(r["durability"]["lost"] for r in ec.records) == 0
    last = ec.records[-1]["storage"]
    arch_ec = last["per_category_bytes"].get("Archival", 0)
    assert last["ec_files"] > 0 and arch_ec > 0
    assert np.array_equal(ec.category_idx, rf4.category_idx)
    assert rf4.records[-1]["storage"]["per_category_bytes"].get("Archival", 0) >= 2 * arch_ec
    # Archival rf 2 -> ec(6,3) writes about 1.5x raw, less than rf 2 -> 4.
    ec0 = next(r["bytes_migrated"] for r in ec.records if r["moves_applied"])
    rf0 = next(r["bytes_migrated"] for r in rf4.records if r["moves_applied"])
    assert ec0 < rf0
    assert "cold" in last["per_tier_bytes"]
    assert ec.summary()["storage"]["ec_files_final"] == last["ec_files"]
    assert any((r.get("causes") or {}).get("conversion") for r in ec.records)


def test_ec_checkpoint_resume_bit_identical(workload, tmp_path):
    m, ev, _, _ = workload
    faults = [f"crash:dn{i}@3-6" for i in (4, 5, 6)]
    ck = str(tmp_path / "ec.npz")
    with carried_init():
        full_ctl = _port(m, "ec_archival", faults)
        full = full_ctl.run(ev)
        a = _port(m, "ec_archival", faults).run(ev, checkpoint_path=ck, max_windows=4)
        b_ctl = _port(m, "ec_archival", faults)
        b = b_ctl.run(ev, checkpoint_path=ck)
    assert _strip(a.records) + _strip(b.records) == _strip(full.records)
    assert [r.get("storage") for r in a.records + b.records] == \
        [r.get("storage") for r in full.records]
    assert np.array_equal(b.rf, full.rf)
    fa, ba = full_ctl._cluster_state.state_arrays(), b_ctl._cluster_state.state_arrays()
    assert all(np.array_equal(fa[k], ba[k]) for k in fa)
    assert np.array_equal(full_ctl._installed_cat, b_ctl._installed_cat)


def test_storage_checkpoint_flag_mismatch(workload, tmp_path):
    m, ev, _, _ = workload
    ck = str(tmp_path / "c.npz")
    with carried_init():
        _port(m, "ec_archival", ["crash:dn4@2"]).run(ev, checkpoint_path=ck, max_windows=3)
    with pytest.raises(ValueError, match="storage=True"):
        _port(m, None, ["crash:dn4@2"]).run(ev, checkpoint_path=ck)


@pytest.mark.parametrize("ec_m", [1, 2])
def test_ec_1_m_equals_replicate_m_plus_1(workload, ec_m):
    """ec(1, m) is m + 1 full copies read from one: the records, plan and
    state equal replicate(m + 1)'s, and the EC run equals the reference's."""
    m, ev, rm, rev = workload
    faults = ["crash:dn4@2-5", "degrade:dn8@3-6:0.5"]

    def storage(strategy):
        def make(mod, sc):
            return mod.StorageConfig(strategies={
                **{c: mod.Strategy(kind="replicate", rf=r)
                   for c, r in sc.replication_factors.items() if c != "Archival"},
                "Archival": mod.Strategy.from_spec(strategy)})
        return make

    ec_ctl, ec = _run_pair(workload, storage(f"ec(1,{ec_m})"), faults)
    with carried_init():
        rep_ctl = _port(m, storage(f"replicate({ec_m + 1})"), faults)
        rep = rep_ctl.run(ev)
    assert _strip(ec.records, ("seconds", "storage")) == \
        _strip(rep.records, ("seconds", "storage"))
    assert [r["storage"]["bytes_stored"] for r in ec.records] == \
        [r["storage"]["bytes_stored"] for r in rep.records]
    assert np.array_equal(ec.rf, rep.rf)
    ea, ra = ec_ctl._cluster_state.state_arrays(), rep_ctl._cluster_state.state_arrays()
    assert all(np.array_equal(ea[k], ra[k]) for k in ea)
    assert Strategy.from_spec(f"ec(1,{ec_m})").n_shards == \
        RefStrategy.from_spec(f"replicate({ec_m + 1})").n_shards


# -- the serve plane ----------------------------------------------------------------

def test_degraded_ec_read_penalty(workload):
    """A cold EC read pays the tier's stretch, one whose primary shard is
    down also the k-shard gather; a hot replicate read pays nothing; and
    the router adds the penalty to the latency samples."""
    m, _, _, _ = workload
    ctl = _port(m, "ec_archival", ["crash:dn4@9999"],
                serve=dict(policy="primary", seed=1, service_ms=2.0))
    cs = ctl._cluster_state
    arch = list(ctl._storage.categories).index("Archival")
    hot = list(ctl._storage.categories).index("Hot")
    ctl.current_cat[:] = hot
    ctl.current_cat[:4] = arch
    ctl._installed_cat[:] = ctl.current_cat
    for f in range(4):
        cs.set_file_strategy(f, 6, int(cs.sizes[f] // 6) + 1, 6)
    slot_ok = cs.reachable_mask().copy()
    slot_ok[1, 0] = False
    pen = ctl._serve_penalty_ms(slot_ok)
    cold_stretch = 2.0 * (1 / 0.25 - 1.0)
    gather = 2.0 * (6 - 1) * (1 / 0.25)
    assert pen[0] == pytest.approx(cold_stretch)
    assert pen[1] == pytest.approx(cold_stretch + gather)
    assert pen[10] == 0.0
    router = ReadRouter(2, ServeConfig(policy="primary", seed=0, service_ms=1.0))
    rm = np.asarray([[0, 1]], dtype=np.int32)
    kw = dict(ts=np.asarray([0.0, 10.0]), pid=np.zeros(2, dtype=np.int64),
              client=np.full(2, -1, dtype=np.int64))
    base = router.route(rm, rm >= 0, np.ones(2), rng=np.random.default_rng(0), **kw)
    bumped = router.route(rm, rm >= 0, np.ones(2), rng=np.random.default_rng(0),
                          extra_ms=np.asarray([5.0, 0.0]), **kw)
    assert bumped.latency_ms[0] == pytest.approx(base.latency_ms[0] + 5.0)
    assert bumped.latency_ms[1] == pytest.approx(base.latency_ms[1])


@pytest.mark.parametrize("faults", [None, RACK_KILL], ids=["plain", "rack-kill"])
def test_serving_storage_controller_matches_the_reference(workload, faults):
    """The degraded-read and tier penalties in every latency record."""
    _, got = _run_pair(workload, "ec_archival", faults,
                       serve=dict(policy="p2c", seed=1, service_ms=2.0))
    busy = [r for r in got.records if r["n_events"]]
    assert busy and all(np.isfinite(r["latency_p99_ms"]) for r in busy)


def test_unreadable_stripe_routes_unavailable(workload):
    partition = ["partition:" + "+".join(f"dn{i}" for i in range(1, 8)) + "@1-9"]
    _, res = _run_pair(workload, "ec_archival", partition, serve=dict(policy="p2c", seed=1))
    ec_w = [r for r in res.records if r["storage"]["ec_files"]
            and r["durability"]["unreachable"] and r.get("reads_routed") is not None]
    assert ec_w, "scenario never produced unreachable EC windows"
    for r in ec_w:
        assert r["reads_routed"] + r["reads_unavailable"] == r["n_reads"]
        assert r["reads_unavailable"] == r["unavailable_reads"]


# -- deferred conversions -------------------------------------------------------------

def test_deferred_conversion_repair_maintains_installed_form(workload):
    """While replicate -> EC conversions defer (5 reachable < k), repair
    keeps the installed replicate form, never the unapplied 9-shard one."""
    ctl, _ = _run_pair(workload, "ec_archival", LONG_PARTITION)
    cs = ctl._cluster_state
    arch = list(ctl._storage.categories).index("Archival")
    deferred = np.flatnonzero((ctl.current_cat == arch) & (cs.ec_k == 0))
    assert len(deferred), "scenario never deferred an Archival conversion"
    assert (cs.replica_map[deferred] >= 0).sum(axis=1).max() <= 3
    assert (ctl.current_rf[deferred] == 9).all()


def test_deferred_conversion_bills_installed_tier(workload):
    ctl, res = _run_pair(workload, "ec_archival", LONG_PARTITION,
                         serve=dict(policy="primary", seed=1, service_ms=2.0))
    cs = ctl._cluster_state
    arch = list(ctl._storage.categories).index("Archival")
    deferred = np.flatnonzero((ctl.current_cat == arch) & (cs.ec_k == 0))
    assert len(deferred) and not (ctl._installed_cat[deferred] == arch).any()
    last = res.records[-1]["storage"]
    assert "cold" not in last["per_tier_bytes"]
    assert last["cost_units"] == pytest.approx(last["bytes_stored"])
    pen = ctl._serve_penalty_ms(np.ones((len(ctl.manifest), cs.replica_map.shape[1]),
                                        dtype=bool))
    assert (pen[deferred] == 0.0).all()


def test_deferred_conversion_lands_after_heal(workload):
    """Conversions deferred behind a partition land when it heals
    (``storage_conversions_retried``), equal to the reference's."""
    partition = ["partition:" + "+".join(f"dn{i}" for i in range(6, 13)) + "@0-5"]
    ctl, res = _run_pair(workload, "ec_archival", partition)
    assert sum(r["storage_conversions_retried"] for r in res.records) > 0
    assert np.array_equal(ctl._installed_cat, ctl.current_cat)


# -- digests, daemon and the CLI -----------------------------------------------------

def test_storage_digest(workload):
    _, res = _run_pair(workload, "ec_archival", ["crash:dn4@2"])
    assert storage_digest([{"n_events": 1}]) is None
    d = storage_digest(res.records)
    last = res.records[-1]["storage"]
    assert d["bytes_stored_final"] == last["bytes_stored"]
    assert d["windows"] == len(res.records)
    assert d["overhead_ratio_max"] >= d["overhead_ratio_final"]
    assert d == res.summary()["storage"]


def test_daemon_with_storage_matches_the_reference(workload, tmp_path):
    """The daemon over a controller with storage: its window records,
    epochs and checkpointed state equal the reference daemon's, and a
    stop/resume stitches exactly."""
    m, ev, rm, rev = workload
    log, rlog = str(tmp_path / "p.cdrsb"), str(tmp_path / "r.cdrsb")
    ev.write_binary(log, m)
    rev.write_binary(rlog, rm)
    with carried_init():
        gd = StreamDaemon(_port(m, "ec_archival", RACK_KILL))
        gdig = gd.run(log)
    wd = RefDaemon(_ref(rm, "ec_archival", RACK_KILL))
    wdig = wd.run(rlog)
    _assert_records_match(gd.records, wd.records)
    _assert_states_match(gd.controller, wd.controller)
    assert gdig["windows_processed"] == wdig["windows_processed"]
    assert gdig["epochs_published"] == wdig["epochs_published"]
    ck = str(tmp_path / "d.npz")
    from cdrs_tpu_torch.daemon import DaemonConfig

    with carried_init():
        a = StreamDaemon(_port(m, "ec_archival", RACK_KILL), DaemonConfig(max_windows=4))
        a.run(log, checkpoint_path=ck)
        b = StreamDaemon(_port(m, "ec_archival", RACK_KILL))
        b.run(log, checkpoint_path=ck)
    assert _strip(a.records) + _strip(b.records) == _strip(gd.records)
    _assert_states_match(b.controller, wd.controller)


def test_cli_chaos_storage_matches_the_reference(tmp_path):
    """``chaos --storage_config ec_archival`` on 12 nodes in 4 racks with a
    rack kill: the summary (its ``storage`` block included) and the window
    records equal the reference CLI's."""
    manifest, log = str(tmp_path / "m.csv"), str(tmp_path / "a.cdrsb")
    assert port_cli.main(["gen", "--n", "150", "--seed", "5", "--nodes", ",".join(NODES),
                          "--out_manifest", manifest]) == 0
    assert port_cli.main(["simulate", "--manifest", manifest, "--out", log,
                          "--duration_seconds", "240", "--seed", "6"]) == 0
    args = ["chaos", "--manifest", manifest, "--access_log", log, "--window_seconds", "60",
            "--k", "4", "--default_rf", "2", "--scoring_config", "validated",
            "--storage_config", "ec_archival", "--racks", RACK_SPEC,
            "--kill", "dn4@2", "--kill", "dn5@2", "--kill", "dn6@2"]
    out = {}
    for name, main, extra in (("port", port_cli.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--backend", "jax"])):
        metrics = str(tmp_path / f"{name}.jsonl")
        buf = io.StringIO()
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            if name == "port":
                with carried_init():
                    assert main(args + extra + ["--metrics", metrics]) == 0
            else:
                assert main(args + extra + ["--metrics", metrics]) == 0
        summary = json.loads(buf.getvalue())
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
        out[name] = (summary, [r for r in recs if r.get("kind") == "window"])
    (gs, gr), (ws, wr) = out["port"], out["ref"]
    assert gs["storage"] == ws["storage"] and gs["durability"] == ws["durability"]
    assert gs["final_plan_hash"] == ws["final_plan_hash"]
    _assert_records_match(gr, wr)
    assert gs["storage"]["windows"] == len(gr) and os.path.exists(tmp_path / "port.jsonl")


# -- geo: a region loss under EC (tests/test_geo.py's [materialized-ec] case) ---------

#: ``tests/test_geo.py``'s three regions of two racks of two nodes, and its
#: racks-only contrast over the same nodes.
GEO = {
    "nodes": list(NODES), "levels": ["rack", "region"],
    "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
    "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
    "edge_bytes": {"rack": 1.0, "region": 4.0},
    "edge_latency": {"rack": 1.5, "region": 8.0},
}
FLAT = {"nodes": list(NODES), "levels": ["rack"], "rack": GEO["rack"]}


def _region_loss_cfg(mod, cls, topo_cls, sched_cls, storage_mod, topo_spec, sizes, **kw):
    specs = (["crash:region:eu@5-9"] if "region" in topo_spec["levels"]
             else [f"crash:{n}@5-9" for n in ("dn1", "dn2", "dn3", "dn4")])
    sc = _min_rf2(mod)
    return cls(window_seconds=120.0, default_rf=2, drift_threshold=0.02,
               max_bytes_per_window=int(sizes.sum() * 0.25),
               kmeans=mod.KMeansConfig(k=10, seed=42), scoring=sc,
               topology=topo_cls.from_hierarchy(topo_spec),
               fault_schedule=sched_cls.from_specs(specs),
               storage=storage_mod.resolve_storage_config("ec_archival", sc), **kw)


@pytest.mark.parametrize("topo", ["geo", "flat"])
def test_region_loss_ec_matches_the_reference(topo):
    """Killing the eu region under EC loses nothing on the hierarchy and
    loses files on the racks-only topology, and both runs equal the
    reference's window for window, state arrays included."""
    import cdrs_tpu.storage as rs
    import cdrs_tpu_torch.storage as ps

    spec = GEO if topo == "geo" else FLAT
    m = generate_population(GeneratorConfig(n_files=400, seed=60, nodes=NODES))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=1800.0, seed=61))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=400, seed=60, nodes=NODES))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=1800.0, seed=61))
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    gc = ReplicationController(m, _region_loss_cfg(pcfg, ControllerConfig, ClusterTopology,
                                                   FaultSchedule, ps, spec, sizes,
                                                   device="cpu"))
    wc = RefController(rm, _region_loss_cfg(jcfg, RefConfig, RefTopology, RefSchedule, rs,
                                            spec, sizes, backend="jax"))
    with carried_init():
        got = gc.run(ev)
    want = wc.run(rev)
    _assert_records_match(got.records, want.records)
    _assert_states_match(gc, wc)
    lost = max(r["durability"]["lost"] for r in got.records)
    assert (lost == 0) if topo == "geo" else (lost > 0)
    assert any(r["storage"]["ec_files"] for r in got.records)
