"""The port's fault path (``ControllerConfig.fault_schedule``, ``topology``,
``scrub``) against ``cdrs_tpu.control.ReplicationController(backend="jax")``.

The cases are those of the reference's ``test_faults.py``,
``test_partitions.py`` and ``test_integrity.py`` that need no serving,
storage or degraded mode, at their sizes (120-150 files, 60-120 s
windows).  The port runs on the CPU in float32, as the reference does on
its jax backend, and its cold inits carry the reference's D² init across.
Every window record is equal apart from ``seconds`` (drift scalars within
1e-6), and so are the final plan and ``ClusterState.state_arrays()`` bit
for bit.  Each case also holds the reference test's own invariants.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu import faults as ref_faults  # noqa: E402
from cdrs_tpu.cli import main as reference_main  # noqa: E402
from cdrs_tpu.cluster import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import BrownoutConfig as RefBrownout  # noqa: E402
from cdrs_tpu.daemon import DaemonConfig as RefDaemonConfig  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch import faults  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology  # noqa: E402
from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig,  # noqa: E402
                                   SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import (ControllerConfig,  # noqa: E402
                                               ReplicationController)
from cdrs_tpu_torch.daemon import BrownoutConfig, DaemonConfig, StreamDaemon  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

K = 8
KMEANS_SEED = 42
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
NODES = tuple(f"dn{i}" for i in range(1, 7))
RACKS = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"


def _workload(n_nodes, seed, n_files=150, duration=600.0):
    """Port and reference populations and logs, generated alike."""
    nodes = NODES[:n_nodes]
    m = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=nodes))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=n_files, seed=seed, nodes=nodes))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    return m, ev, rm, rev


def _rf2(scoring):
    """Every category at rf >= 2."""
    return dataclasses.replace(
        scoring, replication_factors={c: max(2, r) for c, r in
                                      scoring.replication_factors.items()})


def _configs(m, specs, *, racks=False, scrub=None, rf2=False, **kw):
    """(port, reference) ControllerConfigs of one fault-path run; ``scrub``
    is a byte budget per window."""
    port_scoring, ref_scoring = validated_scoring_config(), jcfg.validated_scoring_config()
    if rf2:
        port_scoring, ref_scoring = _rf2(port_scoring), _rf2(ref_scoring)
    port = dict(kw, kmeans=KMeansConfig(k=K, seed=KMEANS_SEED), scoring=port_scoring,
                device="cpu", fault_schedule=faults.FaultSchedule.from_specs(specs))
    ref = dict(kw, kmeans=jcfg.KMeansConfig(k=K, seed=KMEANS_SEED), scoring=ref_scoring,
               backend="jax", fault_schedule=ref_faults.FaultSchedule.from_specs(specs))
    if racks:
        port["topology"] = ClusterTopology.from_rack_spec(tuple(m.nodes), RACKS)
        ref["topology"] = RefTopology.from_rack_spec(tuple(m.nodes), RACKS)
    if scrub is not None:
        port["scrub"] = faults.ScrubConfig(bytes_per_window=int(scrub))
        ref["scrub"] = ref_faults.ScrubConfig(bytes_per_window=int(scrub))
    return ControllerConfig(**port), RefConfig(**ref)


def _controller(manifest, cfg):
    """The port's controller with the reference's cold init carried in."""
    ctl = ReplicationController(manifest, cfg)
    run = ctl._model_full.run

    def run_from_reference_init(X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(
                X.cpu().numpy(), K, seed=KMEANS_SEED, max_iter=0, tol=0.0)[0])
        return run(X, init_centroids=init_centroids, **kw)

    ctl._model_full.run = run_from_reference_init
    return ctl


def _strip(records):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in records]


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


def _assert_states_equal(ctl, ref):
    a, b = ctl._cluster_state.state_arrays(), ref._cluster_state.state_arrays()
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for k, v in ref._repairs.state_arrays().items():
        np.testing.assert_array_equal(ctl._repairs.state_arrays()[k], v)


def _run_pair(workload, specs, **kw):
    """Run the port and the reference over one workload; assert every
    record, the final plan and the cluster state equal.  Returns the port's
    result."""
    m, ev, rm, rev = workload
    cfg, ref_cfg = _configs(m, specs, **kw)
    ref = RefController(rm, ref_cfg)
    want = ref.run(rev)
    ctl = _controller(m, cfg)
    got = ctl.run(ev)
    _assert_records_match(got.records, want.records)
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.category_idx, want.category_idx)
    _assert_states_equal(ctl, ref)
    g, w = got.summary(), want.summary()
    assert set(g) == set(w)
    for key in ("durability", "integrity", "final_plan_hash", "moves_applied"):
        assert g.get(key) == w.get(key), key
    return got


# -- parity, case by case -------------------------------------------------------

MIXED = ["crash:dn2@1-2", "flaky:dn3@2-3:0.8", "partition:dn4+dn5@2-3",
         "degrade:dn6@1-3:0.25", "corrupt:dn1@1:0.5"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_faults_on_racks_match_the_reference(seed):
    """Every fault kind at once on a racked 6-node cluster, with the
    scrubber and a byte budget that repairs, scrub and migrations share."""
    wl = _workload(6, 21 + seed)
    sizes = np.asarray(wl[0].size_bytes, dtype=np.int64)
    got = _run_pair(wl, MIXED, racks=True, rf2=True, window_seconds=120.0, default_rf=2,
                    max_bytes_per_window=int(3 * sizes.max()),
                    scrub=int(sizes.mean() * 4))
    assert sum(r["repair_moves"] for r in got.records) > 0
    assert all("integrity" in r and "durability" in r for r in got.records)
    # Repairs spend first (a straggler's inflated first copy may overrun);
    # scrub and migrations get only what they left.
    budget = int(3 * sizes.max())
    assert all(r["scrub"]["bytes"] + r["bytes_migrated"] <= max(budget - r["repair_bytes"], 0)
               for r in got.records)


def test_heal_after_kill():
    got = _run_pair(_workload(5, 21), ["crash:dn2@2"], rf2=True, window_seconds=120.0,
                    default_rf=2)
    kill = got.records[2]
    assert kill["fault_events"] == ["crash:dn2@2"]
    assert kill["durability"]["nodes_up"] == 4
    d = got.summary()["durability"]
    assert d["repair_moves_total"] > 0 and d["files_lost_max"] == 0
    last = got.records[-1]["durability"]
    assert last["under_replicated"] == 0 and last["at_risk"] == 0


def test_lost_files_heal_only_after_recover():
    got = _run_pair(_workload(5, 21), ["crash:dn2@1-2"], window_seconds=120.0,
                    drift_threshold=10.0)
    by_w = {r["window"]: r for r in got.records}
    assert by_w[1]["durability"]["lost"] > 0
    assert by_w[3]["durability"]["lost"] == 0
    assert got.records[-1]["durability"]["under_replicated"] == 0


def test_repair_and_migration_share_the_budget():
    wl = _workload(5, 21)
    budget = int(3 * np.asarray(wl[0].size_bytes).max())
    got = _run_pair(wl, ["crash:dn2@2"], window_seconds=120.0, default_rf=2,
                    max_bytes_per_window=budget, hysteresis_windows=0)
    assert all(r["repair_bytes"] + r["bytes_migrated"] <= budget for r in got.records)
    assert sum(r["repair_bytes"] for r in got.records[2:]) > 0
    assert any(r["deferred_budget"] or r["repair_deferred_budget"] for r in got.records)


def test_flaky_copies_back_off():
    got = _run_pair(_workload(5, 21), ["crash:dn2@1-3", "flaky:dn1@1-3:1.0",
                                       "flaky:dn3@1-3:0.9"],
                    window_seconds=120.0, default_rf=2, repair_seed=3)
    assert sum(r["repair_failed"] for r in got.records) > 0
    assert sum(r["repair_deferred_backoff"] for r in got.records) > 0


def test_partition_stalls_then_heals():
    got = _run_pair(_workload(6, 51), ["partition:dn2@1-2"], window_seconds=120.0,
                    drift_threshold=10.0)
    d = got.summary()["durability"]
    assert got.records[1]["durability"]["unreachable"] > 0
    assert got.records[1]["durability"]["lost"] == 0
    assert d["unreachable_max"] > 0 and d["unreachable_final"] == 0
    assert got.records[1]["unavailable_reads"] > 0


def test_rack_partition_with_a_straggler():
    got = _run_pair(_workload(6, 51), ["partition:dn3+dn4@1-2", "degrade:dn5@1-3:0.25"],
                    racks=True, rf2=True, window_seconds=120.0, default_rf=2)
    assert all(r["durability"]["lost"] == 0 and r["durability"]["unreachable"] == 0
               for r in got.records)
    last = got.records[-1]["durability"]
    assert last["correlated_risk"] == 0 and last["under_replicated"] == 0


def test_scrub_detects_and_heals():
    wl = _workload(4, 41, n_files=120, duration=420.0)
    sizes = np.asarray(wl[0].size_bytes, dtype=np.int64)
    got = _run_pair(wl, ["corrupt:dn2@1:1.0"], rf2=True, window_seconds=60.0, default_rf=2,
                    scrub=int(sizes.sum()) * 3)
    integ = got.summary()["integrity"]
    assert integ["detected_scrub"] > 0 and integ["corrupt_copies_final"] == 0
    assert integ["true_lost_final"] == 0 and integ["scrub_starved_windows"] == 0
    assert integ["detected_read"] == 0


def test_deferred_scrub_holds_its_cursor():
    """The brownout's ``defer_scrub`` mode skips the pass (cursor held), as
    the reference does."""
    m, ev, rm, rev = _workload(4, 41, n_files=120, duration=420.0)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    cfg, ref_cfg = _configs(m, ["corrupt:dn2@1:1.0"], rf2=True, window_seconds=60.0,
                            default_rf=2, scrub=int(sizes.sum()))
    ref = RefController(rm, ref_cfg)
    ctl = _controller(m, cfg)
    for c in (ref, ctl):
        c.degraded_modes = frozenset({"defer_scrub"})
    want, got = ref.run(rev), ctl.run(ev)
    _assert_records_match(got.records, want.records)
    assert all(r["scrub"]["deferred"] and r["scrub"]["cursor"] == 0 for r in got.records)
    assert ctl._scrub.cursor == 0 and got.summary()["integrity"]["detected_scrub"] == 0


@pytest.mark.parametrize("scrub", [False, True])
def test_unscrubbed_rot_plus_a_kill(scrub):
    """Without the scrubber, rot stays latent until a kill takes the clean
    copies: ground-truth losses; the same schedule with it loses nothing."""
    wl = _workload(4, 41, n_files=120, duration=420.0)
    sizes = np.asarray(wl[0].size_bytes, dtype=np.int64)
    got = _run_pair(wl, ["corrupt:dn2@1:1.0", "crash:dn3@3"], rf2=True, window_seconds=60.0,
                    default_rf=2, scrub=int(sizes.sum()) * 3 if scrub else None)
    integ = got.summary()["integrity"]
    if scrub:
        assert integ["true_lost_final"] == 0 and integ["detected_total"] > 0
    else:
        assert integ["true_lost_final"] >= 1
        assert got.summary()["durability"]["lost_final"] <= integ["true_lost_final"]


# -- kill and resume ------------------------------------------------------------

RESUME_CASES = {
    "mid-fault": (5, 21, dict(specs=["crash:dn2@1-2", "flaky:dn3@2-3:0.8"],
                              window_seconds=120.0, default_rf=2), None),
    "mid-scrub": (4, 41, dict(specs=["corrupt:dn2@1:0.6", "crash:dn3@2-3"], rf2=True,
                              window_seconds=60.0, default_rf=2), 4),
    "mid-partition": (6, 51, dict(specs=["partition:dn3+dn4@1-2", "degrade:dn5@1-3:0.25"],
                                  racks=True, rf2=True, window_seconds=120.0,
                                  default_rf=2), None),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_kill_and_resume_is_bit_identical(tmp_path, case):
    n_nodes, seed, kw, scrub_mult = RESUME_CASES[case]
    n_files, duration = (120, 420.0) if n_nodes == 4 else (150, 600.0)
    wl = _workload(n_nodes, seed, n_files=n_files, duration=duration)
    m, ev = wl[0], wl[1]
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    kw = dict(kw, max_bytes_per_window=int(3 * sizes.max()))
    if scrub_mult:
        kw["scrub"] = int(sizes.mean()) * scrub_mult
    specs = kw.pop("specs")
    full = _run_pair(wl, specs, **kw)
    assert len(full.records) >= 4
    cfg, _ = _configs(m, specs, **kw)
    ck = str(tmp_path / "chaos.npz")
    a = _controller(m, cfg).run(ev, checkpoint_path=ck, max_windows=2)
    resumed = _controller(m, cfg)
    b = resumed.run(ev, checkpoint_path=ck)
    assert _strip(a.records) + _strip(b.records) == _strip(full.records)
    np.testing.assert_array_equal(b.rf, full.rf)
    uninterrupted = _controller(m, cfg)
    uninterrupted.run(ev)
    for k, v in uninterrupted._cluster_state.state_arrays().items():
        np.testing.assert_array_equal(resumed._cluster_state.state_arrays()[k], v)
    if scrub_mult:
        assert resumed._scrub.cursor == uninterrupted._scrub.cursor


@pytest.mark.parametrize("mode", ["faults", "scrub"])
def test_checkpoint_mode_mismatch_raises(tmp_path, mode):
    m, ev, _, _ = _workload(4, 41, n_files=120, duration=420.0)
    ck = str(tmp_path / "c.npz")
    specs = ["corrupt:dn2@1:0.5"]
    first, _ = _configs(m, specs, window_seconds=60.0)
    ReplicationController(m, first).run(ev, checkpoint_path=ck, max_windows=2)
    if mode == "faults":
        other = ControllerConfig(window_seconds=60.0, kmeans=KMeansConfig(k=K, seed=KMEANS_SEED),
                                 scoring=validated_scoring_config(), device="cpu")
    else:
        other, _ = _configs(m, specs, window_seconds=60.0, scrub=10**9)
    with pytest.raises(ValueError, match=mode):
        ReplicationController(m, other).run(ev, checkpoint_path=ck)


def test_config_guards():
    m = _workload(4, 41, n_files=40, duration=60.0)[0]
    with pytest.raises(ValueError, match="scrub requires"):
        ControllerConfig(kmeans=KMeansConfig(k=K), device="cpu",
                         scrub=faults.ScrubConfig(bytes_per_window=1000))
    with pytest.raises(ValueError, match="manifest"):
        ReplicationController(m, ControllerConfig(
            kmeans=KMeansConfig(k=K), device="cpu",
            fault_schedule=faults.FaultSchedule.from_specs(["crash:dn1@0"]),
            topology=ClusterTopology(("dn1", "dn2"))))


# -- the CLI and the daemon -------------------------------------------------------

def test_cli_chaos_digest_equals_the_reference(tmp_path, monkeypatch):
    """``python -m cdrs_tpu_torch chaos --device cpu`` and ``cdrs chaos
    --backend jax`` over the same 12-node, 4-rack files with a rack kill, a
    partition, a straggler, rot and the scrubber: equal summaries apart from
    the wall-clock fields, and equal schedules written out."""
    run = ReplicationPolicyModel.run

    def run_from_reference_init(self, X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(
                X.cpu().numpy(), self.kmeans_cfg.k, seed=self.kmeans_cfg.seed,
                max_iter=0, tol=0.0)[0])
        return run(self, X, init_centroids=init_centroids, **kw)

    monkeypatch.setattr(ReplicationPolicyModel, "run", run_from_reference_init)
    monkeypatch.chdir(tmp_path)
    nodes = ",".join(f"dn{i}" for i in range(1, 13))
    assert port_cli.main(["gen", "--n", "200", "--seed", "5", "--nodes", nodes,
                          "--out_manifest", "m.csv"]) == 0
    assert port_cli.main(["simulate", "--manifest", "m.csv", "--out", "a.cdrsb",
                          "--duration_seconds", "300", "--seed", "6"]) == 0
    racks = "r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;r2=dn7,dn8,dn9;r3=dn10,dn11,dn12"
    args = ["chaos", "--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds",
            "60", "--k", "4", "--scoring_config", "validated", "--default_rf", "2",
            "--racks", racks, "--kill", "rack:r1@2-3", "--partition", "dn7+dn8@1-2",
            "--degrade", "dn9@1-3:0.25", "--corrupt", "dn1@1:0.2", "--scrub", "50000000",
            "--max_bytes", "400000000"]
    outs = []
    for main, extra, sched in ((port_cli.main, ["--device", "cpu"], "p.json"),
                               (reference_main, ["--backend", "jax"], "r.json")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(args + extra + ["--schedule_out", sched]) == 0
        outs.append(json.loads(buf.getvalue()))
    got, want = outs
    for d in (got, want):
        for key in ("seconds", "windows_per_sec", "plan_seconds_fraction"):
            d.pop(key)
    assert got == want
    assert got["durability"]["repair_moves_total"] > 0 and got["integrity"]["windows"] > 0
    assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
    # No fault: an error exit, as the reference's.
    assert port_cli.main(["chaos", "--manifest", "m.csv", "--access_log", "a.cdrsb",
                          "--device", "cpu"]) == 1


ENGAGE = (0.5, 1.0, 1.5, 2.0, 3.0)
RELEASE = (0.2, 0.4, 0.6, 0.8, 1.0)


def test_daemon_never_coalesces_a_faulted_window(tmp_path):
    """An overfed brownout daemon with a fault schedule: the reference's
    records, and every window with fault events decided alone at its own
    index while fault-free windows still coalesce."""
    m, ev, rm, _ = _workload(6, 31, n_files=120, duration=1800.0)
    src = str(tmp_path / "over.cdrsb")
    ev.write_binary(src, m, block_rows=256)
    specs = ["crash:dn2@3-5", "degrade:dn4@6:0.5", "partition:dn5+dn6@8-9"]
    cfg, ref_cfg = _configs(m, specs, window_seconds=120.0, default_rf=2)
    brown = dict(engage=ENGAGE, release=RELEASE, hold=1)
    ref = RefDaemon(RefController(rm, ref_cfg), RefDaemonConfig(brownout=RefBrownout(**brown)))
    ref.run(src)
    d = StreamDaemon(_controller(m, cfg), DaemonConfig(brownout=BrownoutConfig(**brown)))
    dig = d.run(src)
    _assert_records_match(d.records, ref.records)
    assert dig["brownout"]["windows_coalesced"] > 0
    faulted = {e.window for e in faults.FaultSchedule.from_specs(specs)}
    by_w = {r["window"]: r for r in d.records}
    for w in faulted:
        assert by_w[w]["daemon"]["coalesced"] == 1 and by_w[w]["fault_events"], w
    for r in d.records:
        span = range(r["window"] - r["daemon"]["coalesced"] + 1, r["window"] + 1)
        assert r["daemon"]["coalesced"] == 1 or not faulted & set(span), r["window"]
    assert sum(r["n_events"] for r in d.records) == d.events_ingested
