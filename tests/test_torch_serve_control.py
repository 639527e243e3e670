"""The serving controller (``ControllerConfig.serve``), the ``serve`` CLI and
the daemon's read shedding against ``cdrs_tpu``'s, and the reference's own
controller-level serving cases (``tests/test_serve.py``,
``tests/test_integrity.py``, ``tests/test_overload.py``) on the port.

The controller runs on the CPU in float32 against the reference's
``backend="jax"``, its cold re-clusters starting from the reference's D²
init of the same snapshot (as in ``test_torch_controller.py``).  Every
window record is equal: latency percentiles, SLO burn, hotspot fields,
``recluster_trigger``, ``integrity.detected_read`` and plan hashes.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu import cli as ref_cli  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import BrownoutConfig as RefBrownout  # noqa: E402
from cdrs_tpu.daemon import DaemonConfig as RefDaemonConfig  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.faults import FaultSchedule as RefSchedule  # noqa: E402
from cdrs_tpu.faults import ScrubConfig as RefScrub  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.serve import ServeConfig as RefServe  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig, SimulatorConfig,  # noqa: E402
                                   validated_scoring_config)
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.daemon import BrownoutConfig, DaemonConfig, StreamDaemon  # noqa: E402
from cdrs_tpu_torch.daemon.brownout import RUNGS  # noqa: E402
from cdrs_tpu_torch.faults import FaultSchedule, ScrubConfig  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import serve_digest  # noqa: E402
from cdrs_tpu_torch.serve import ServeConfig  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access, simulate_flash_crowd  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

K = 8
NODES5 = ("dn1", "dn2", "dn3", "dn4", "dn5")
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
#: The serving controller's chaos shape: a partition, a straggler and rot,
#: found by reads and by the scrubber.
CHAOS = ("partition:dn2@3-5", "degrade:dn3@2-6:0.25", "corrupt:dn1@2:0.3")


def _workload(seed, n_files=300, duration=480.0, nodes=NODES5):
    """``tests/test_serve.py``'s serve_workload in both packages."""
    m = generate_population(GeneratorConfig(n_files=n_files, seed=seed + 5, nodes=nodes))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=duration, seed=seed + 6))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=n_files, seed=seed + 5, nodes=nodes))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=duration, seed=seed + 6))
    return m, ev, rm, rev


@pytest.fixture(scope="module")
def serve_workload():
    return _workload(0)


def _controller(manifest, serve=ServeConfig(policy="p2c", seed=3), faults=None, **kw):
    """The port's serving controller, its cold init the reference's."""
    kw.setdefault("scoring", validated_scoring_config())
    kw.setdefault("window_seconds", 60.0)
    ctl = ReplicationController(manifest, ControllerConfig(
        default_rf=2, kmeans=KMeansConfig(k=K, seed=42), serve=serve,
        device="cpu", fault_schedule=None if faults is None else FaultSchedule.from_specs(faults),
        **kw))
    run = ctl._model_full.run

    def run_from_reference_init(X, init_centroids=None, **rkw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(X.cpu().numpy(), K, seed=42,
                                                        max_iter=0, tol=0.0)[0])
        return run(X, init_centroids=init_centroids, **rkw)

    ctl._model_full.run = run_from_reference_init
    return ctl


def _ref_controller(manifest, serve=RefServe(policy="p2c", seed=3), faults=None, **kw):
    kw.setdefault("scoring", jcfg.validated_scoring_config())
    kw.setdefault("window_seconds", 60.0)
    return RefController(manifest, RefConfig(
        default_rf=2, kmeans=jcfg.KMeansConfig(k=K, seed=42), serve=serve,
        backend="jax", fault_schedule=None if faults is None else RefSchedule.from_specs(faults),
        **kw))


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


# -- controller parity -----------------------------------------------------------

@pytest.mark.parametrize("seed,chaos", [(0, False), (1, False), (2, False), (0, True)])
def test_serving_controller_matches_the_reference(seed, chaos):
    m, ev, rm, rev = _workload(seed)
    faults = CHAOS if chaos else None
    kw = dict(scrub=ScrubConfig(bytes_per_window=2_000_000)) if chaos else {}
    rkw = dict(scrub=RefScrub(bytes_per_window=2_000_000)) if chaos else {}
    got = _controller(m, faults=faults, **kw).run(ev)
    want = _ref_controller(rm, faults=faults, **rkw).run(rev)
    _assert_records_match(got.records, want.records)
    np.testing.assert_array_equal(got.rf, want.rf)
    g, w = got.summary(), want.summary()
    assert g["serve"] == w["serve"] and g["final_plan_hash"] == w["final_plan_hash"]
    busy = [r for r in got.records if r["n_events"]]
    assert busy and {"hotspot", "serve"} <= set(busy[0]["seconds"])
    for r in busy:
        assert r["reads_routed"] + r["reads_unavailable"] == r["n_reads"]
        assert np.isfinite(r["latency_p99_ms"]) and r["latency_p50_ms"] <= r["latency_p99_ms"]
        assert 0.0 <= r["serve_locality"] <= 1.0 and r["utilization_max"] >= 0.0
    assert g["serve"]["reads_routed"] == sum(r["reads_routed"] for r in busy)
    if chaos:
        assert g["integrity"]["detected_read"] == w["integrity"]["detected_read"] > 0
        assert any(r.get("reads_unavailable") for r in busy)


def test_serving_kill_resume_is_bit_identical(serve_workload, tmp_path):
    """The hotspot baseline, the move causes and the per-window routing
    seeds ride the checkpoint: kill and resume give the uninterrupted run."""
    m, ev, _, _ = serve_workload
    faults = ("partition:dn2@3-5", "degrade:dn3@2-6:0.25")
    full = _controller(m, faults=faults).run(ev)
    ck = str(tmp_path / "serve.npz")
    a = _controller(m, faults=faults).run(ev, checkpoint_path=ck, max_windows=4)
    b = _controller(m, faults=faults)
    res_b = b.run(ev, checkpoint_path=ck)
    assert _strip(a.records) + _strip(res_b.records) == _strip(full.records)
    assert np.array_equal(res_b.rf, full.rf)
    ewma = _controller(m, faults=faults)
    ewma.run(ev)
    assert b._hotspot.ewma.tobytes() == ewma._hotspot.ewma.tobytes()


def test_serve_checkpoint_flag_mismatch(serve_workload, tmp_path):
    m, ev, _, _ = serve_workload
    ck = str(tmp_path / "plain.npz")
    _controller(m, serve=None).run(ev, checkpoint_path=ck, max_windows=2)
    with pytest.raises(ValueError, match="serve"):
        _controller(m).run(ev, checkpoint_path=ck)


def _port_init_in_reference():
    """The reverse carry (ROADMAP Queue C2's protocol): the reference's
    full re-clusters start from the port's own cold init of the snapshot."""
    import contextlib

    import torch

    import cdrs_tpu.models.replication as ref_models
    import cdrs_tpu_torch.ops.kmeans as port_kmeans

    @contextlib.contextmanager
    def carry():
        run = ref_models.ReplicationPolicyModel.run

        def run_from_port_init(self, X, feature_names=None, init_centroids=None):
            if init_centroids is None:
                x = torch.from_numpy(np.asarray(X, dtype=np.float32))
                init_centroids = port_kmeans.kmeans_full(
                    x, self.kmeans_cfg.k, seed=self.kmeans_cfg.seed, max_iter=0,
                    tol=0.0)[0].numpy()
            return run(self, X, feature_names, init_centroids)

        ref_models.ReplicationPolicyModel.run = run_from_port_init
        try:
            yield
        finally:
            ref_models.ReplicationPolicyModel.run = run

    return carry()


@pytest.mark.parametrize("init", ["reference", "port"])
def test_hotspot_triggers_recluster_drift_does_not(init):
    """The reference's flash-crowd bench scenario at its quick scale (200
    files on five nodes, 900 s in 9 windows, the archival cohort boosted 40x
    in window 6, drift threshold 0.10): from the reference's init the
    drift-only controller sleeps through the burst and the serving one
    re-clusters it with trigger ``hotspot``, its moves tagged so.  The
    burst's drift sits near the threshold: from the port's own init it
    scores 0.1011 and drift names the re-cluster, and the reference
    carrying that init gives the same records (ROADMAP Queue C4)."""
    n_windows, duration = 9, 900.0
    ws = duration / n_windows
    nodes = ("dn1", "dn2", "dn3", "dn4", "dn5")
    manifest = generate_population(GeneratorConfig(n_files=200, seed=29, nodes=nodes))
    events, _ = simulate_flash_crowd(
        manifest, SimulatorConfig(duration_seconds=duration, seed=30),
        cohort=np.asarray([c == "archival" for c in manifest.category]),
        start=6 * ws, duration=ws, boost=40.0)
    rm = ref_generate(jcfg.GeneratorConfig(n_files=200, seed=29, nodes=nodes))
    from cdrs_tpu.sim.access import simulate_flash_crowd as ref_flash_crowd

    rev, _ = ref_flash_crowd(rm, jcfg.SimulatorConfig(duration_seconds=duration, seed=30),
                             cohort=np.asarray([c == "archival" for c in rm.category]),
                             start=6 * ws, duration=ws, boost=40.0)
    runs = {}
    for feedback in (False, True):
        kw = dict(window_seconds=ws, drift_threshold=0.10)
        ctl = _controller(manifest, serve=ServeConfig(
            policy="p2c", seed=29, hotspot_min_reads=15, recluster_on_hotspot=feedback), **kw)
        if init == "port":
            ctl._model_full = ctl._make_model(warm=False)   # the port's own init
        got = ctl.run(events)
        ref_serve = RefServe(policy="p2c", seed=29, hotspot_min_reads=15,
                             recluster_on_hotspot=feedback)
        if init == "port":
            with _port_init_in_reference():
                want = _ref_controller(rm, serve=ref_serve, **kw).run(rev)
        else:
            want = _ref_controller(rm, serve=ref_serve, **kw).run(rev)
        _assert_records_match(got.records, want.records)
        runs[feedback] = got
    plain, fed = runs[False], runs[True]
    burst = fed.records[6]
    assert burst["hotspot_score"] >= 4.0 and burst["hotspot_files"]
    if init == "reference":
        assert plain.records[6]["drift"] < 0.10
        assert [r["window"] for r in plain.records if r["recluster"] and r["window"] >= 6] == []
        assert [r["window"] for r in fed.records if r["recluster_trigger"] == "hotspot"] == [6]
        assert fed.summary()["serve"]["hotspot_reclusters"] == 1
        assert "hotspot" in {c for r in fed.records[6:] for c in r.get("causes") or ()}
    else:
        assert plain.records[6]["drift"] >= 0.10 and burst["recluster_trigger"] == "drift"


# -- integrity through the read path ---------------------------------------------

def test_detect_on_read_feeds_scrub_hints():
    """Read detections quarantine the copy and hint the scrubber; with a
    tiny scrub budget the hint queue is what gets verified
    (``tests/test_integrity.py``'s case, held to the reference too)."""
    import dataclasses

    nodes = ("dn1", "dn2", "dn3", "dn4")
    m, ev, rm, rev = _workload(36, n_files=120, duration=420.0, nodes=nodes)
    sizes = np.asarray(m.size_bytes, dtype=np.int64)
    base = validated_scoring_config()
    rf2 = dataclasses.replace(base, replication_factors={
        c: max(2, r) for c, r in base.replication_factors.items()})
    rbase = jcfg.validated_scoring_config()
    rrf2 = dataclasses.replace(rbase, replication_factors={
        c: max(2, r) for c, r in rbase.replication_factors.items()})
    scrub = int(sizes.max()) * 3
    got = _controller(m, serve=ServeConfig(policy="p2c", seed=0), faults=("corrupt:dn1@1:1.0",),
                      scoring=rf2, scrub=ScrubConfig(bytes_per_window=scrub)).run(ev)
    want = _ref_controller(rm, serve=RefServe(policy="p2c", seed=0),
                           faults=("corrupt:dn1@1:1.0",), scoring=rrf2,
                           scrub=RefScrub(bytes_per_window=scrub)).run(rev)
    _assert_records_match(got.records, want.records)
    integ = got.summary()["integrity"]
    reads_detected = sum(r.get("reads_corrupt_detected") or 0 for r in got.records)
    assert 0 < integ["detected_read"] <= reads_detected
    assert sum((r.get("scrub") or {}).get("hinted", 0) for r in got.records) > 0


# -- the serve CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_cli")
    m, ev, _, _ = _workload(6, n_files=120, duration=240.0, nodes=("dn1", "dn2", "dn3"))
    man, log = str(d / "m.csv"), str(d / "a.log")
    m.write_csv(man)
    ev.write_csv(log, m)
    return d, man, log


@pytest.mark.parametrize("extra", [
    ["--policy", "p2c", "--degrade", "dn2@1-2:0.5"],
    ["--policy", "least_loaded", "--racks", "r0=dn1;r1=dn2,dn3", "--kill", "dn3@1-2"],
    ["--policy", "random", "--window_seconds", "30", "--partition", "dn1+dn2@2-3"],
    ["--corrupt", "dn1@0:1.0"],
    ["--corrupt", "dn1@0:1.0", "--no_verify_reads"],
], ids=["degrade", "racks-kill", "partition", "rot-verified", "rot-unverified"])
def test_serve_cli_prints_the_reference_digest(cli_inputs, capsys, extra):
    d, man, log = cli_inputs
    base = ["serve", "--manifest", man, "--access_log", log, "--window_seconds", "60"]
    metrics = str(d / f"s{len(extra)}{extra[1][:3]}.jsonl")
    assert port_cli.main(base + extra + ["--metrics", metrics]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_cli.main(base + extra) == 0
    want = json.loads(capsys.readouterr().out)
    timing = ("seconds", "routed_reads_per_sec")
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    assert got["reads_routed"] > 0 and got["routed_reads_per_sec"] > 0
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    # The window records ride the instrument's stream with its serve.* events.
    windows = [e for e in events if e["kind"] == "window"]
    assert {"meta", "span", "window"} <= {e["kind"] for e in events}
    counters = {e["name"]: e["value"] for e in events if e["kind"] == "counter"}
    assert counters["serve.reads_routed"] == got["reads_routed"]
    assert serve_digest(windows) == {k: v for k, v in got.items()
                                     if k not in timing + ("policy",)}
    if "--no_verify_reads" in extra:
        assert got["reads_corrupt_served"] > 0 and got["reads_corrupt_detected"] == 0
    elif "--corrupt" in extra:
        assert got["reads_corrupt_served"] == 0 and got["reads_corrupt_detected"] > 0


@pytest.mark.parametrize("extra", [[], ["--kill", "dn3@1-2"]], ids=["static", "faults"])
@pytest.mark.parametrize("mode", ["functional", "materialized_hash"])
def test_serve_cli_hash_placement_prints_the_reference_digest(cli_inputs, capsys, mode,
                                                              extra):
    """``serve --placement`` (ROADMAP A8f): the hash chooser's digest is the
    reference's, with the window's rows resolved on the fly (functional,
    no faults) or materialized."""
    _, man, log = cli_inputs
    base = ["serve", "--manifest", man, "--access_log", log, "--window_seconds", "60",
            "--placement", mode] + extra
    assert port_cli.main(base) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_cli.main(base) == 0
    want = json.loads(capsys.readouterr().out)
    timing = ("seconds", "routed_reads_per_sec")
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    assert got["reads_routed"] > 0


def test_control_and_chaos_cli_take_the_serve_flags(cli_inputs, capsys):
    d, man, log = cli_inputs
    common = ["--manifest", man, "--access_log", log, "--window_seconds", "60",
              "--scoring_config", "validated", "--device", "cpu", "--serve",
              "--serve_policy", "least_loaded", "--serve_seed", "4", "--serve_service_ms",
              "0.8", "--serve_slo_ms", "8", "--serve_slo_availability", "0.99",
              "--no_hotspot_recluster"]
    assert port_cli.main(["control"] + common) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["serve"]["reads_routed"] > 0 and out["serve"]["hotspot_reclusters"] == 0
    assert port_cli.main(["chaos"] + common + ["--corrupt", "dn1@1:1.0",
                                               "--no_verify_reads"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["serve"]["reads_corrupt_served"] > 0
    assert out["integrity"]["detected_read"] == 0


# -- brownout read shedding --------------------------------------------------------

def test_brownout_sheds_reads_as_the_reference_does(tmp_path):
    """An overfed log drives the ladder to ``shed_reads``: the shed windows
    drop a seeded fraction of their reads before routing, the digest adds
    them up, and the records are the reference daemon's."""
    m, ev, rm, _ = _workload(9, n_files=120, duration=1800.0, nodes=("dn1", "dn2", "dn3"))
    src = str(tmp_path / "over.cdrsb")
    ev.write_binary(src, m, block_rows=256)
    engage, release = (0.5, 1.0, 1.5, 2.0, 3.0), (0.2, 0.4, 0.6, 0.8, 1.0)
    d = StreamDaemon(_controller(m), DaemonConfig(
        brownout=BrownoutConfig(engage=engage, release=release, hold=1)))
    dig = d.run(src)
    ref = RefDaemon(_ref_controller(rm), RefDaemonConfig(
        brownout=RefBrownout(engage=engage, release=release, hold=1)))
    want = ref.run(src)
    _assert_records_match(d.records, ref.records)
    shed = [r for r in d.records if r["daemon"]["brownout_level"] >= len(RUNGS)]
    assert shed, "the ladder never reached shed_reads"
    assert all(r["reads_shed"] > 0 for r in shed if r["n_reads"] > 100)
    assert all(r["reads_shed"] < r["n_reads"] for r in shed)
    total = sum(r.get("reads_shed", 0) for r in d.records)
    assert dig["brownout"]["reads_shed"] == want["brownout"]["reads_shed"] == total > 0
