"""The port's streaming daemon against ``cdrs_tpu.daemon.StreamDaemon`` over
``backend="jax"``, float32 on the CPU, and the daemon's own contracts.

The reference's daemon fixture (150 files, 600 s of traffic, 120 s
windows, k = 8, validated scoring) on seeds 0/1/2, fed in memory and
through a ``.cdrsb`` log.  Cold re-clusters of the port start from the
reference's D² init of the same snapshot (the port does not reproduce
threefry), carried as ``tests/test_torch_controller.py`` carries it.
Records (without the wall-clock ``seconds``), plan hashes, published
epochs, digests and the checkpoint's cursor meta are identical; drift
scalars agree within 1e-6.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.daemon import BrownoutConfig as RefBrownout  # noqa: E402
from cdrs_tpu.daemon import DaemonConfig as RefDaemonConfig  # noqa: E402
from cdrs_tpu.daemon import StreamDaemon as RefDaemon  # noqa: E402
from cdrs_tpu.obs.alerts import AlertRule as RefRule  # noqa: E402
from cdrs_tpu.obs.alerts import default_rules as ref_default_rules  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.ops.kmeans_stream import MiniBatchKMeans as RefMiniBatch  # noqa: E402
from cdrs_tpu.ops.kmeans_stream import MiniBatchState as RefMiniBatchState  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.cluster.placement import ClusterTopology, primary_on_topology  # noqa: E402
from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig, SimulatorConfig,  # noqa: E402
                                   validated_scoring_config)
from cdrs_tpu_torch.control.controller import ControllerConfig, ReplicationController  # noqa: E402
from cdrs_tpu_torch.convert import minibatch_state_from_reference  # noqa: E402
from cdrs_tpu_torch.daemon import BrownoutConfig, DaemonConfig, StreamDaemon  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.obs.alerts import AlertRule, default_rules  # noqa: E402
from cdrs_tpu_torch.ops.kmeans_stream import MiniBatchKMeans  # noqa: E402
from cdrs_tpu_torch.placement_fn import EpochMap  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

K = 8
KMEANS_SEED = 42
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT)}


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


def _workload(seed, n_files=150, duration=600.0):
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=31 + seed))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration,
                                                       seed=32 + seed))
    ref_manifest = ref_generate(jcfg.GeneratorConfig(n_files=n_files, seed=31 + seed))
    ref_events = ref_simulate(ref_manifest, jcfg.SimulatorConfig(duration_seconds=duration,
                                                                 seed=32 + seed))
    return manifest, events, ref_manifest, ref_events


@pytest.fixture(scope="module")
def workload():
    return _workload(0)


def _cfg(**kw):
    base = dict(window_seconds=120.0, kmeans=KMeansConfig(k=K, seed=KMEANS_SEED),
                scoring=validated_scoring_config(), device="cpu")
    base.update(kw)
    return ControllerConfig(**base)


def _ref_cfg(**kw):
    base = dict(window_seconds=120.0, kmeans=jcfg.KMeansConfig(k=K, seed=KMEANS_SEED),
                scoring=jcfg.validated_scoring_config(), backend="jax")
    base.update(kw)
    return RefConfig(**base)


def _controller(manifest, **kw):
    """The port's controller with the reference's cold init carried in."""
    ctl = ReplicationController(manifest, _cfg(**kw))
    run = ctl._model_full.run

    def run_from_reference_init(X, init_centroids=None, **rkw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(
                X.cpu().numpy(), K, seed=KMEANS_SEED, max_iter=0, tol=0.0)[0])
        return run(X, init_centroids=init_centroids, **rkw)

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


def _write_log(events, manifest, path, block_rows):
    events.write_binary(str(path), manifest, block_rows=block_rows)
    return str(path)


def _digest_without_latency(d):
    return {k: v for k, v in d.items() if k not in ("decision_p50_seconds",
                                                    "decision_p99_seconds")}


@pytest.mark.parametrize("source", ["feed", "cdrsb"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_daemon_matches_the_reference(tmp_path, seed, source):
    manifest, events, ref_manifest, ref_events = _workload(seed)
    if source == "cdrsb":
        src = _write_log(events, manifest, tmp_path / "ev.cdrsb", 1013)
        ref_src = src
    else:
        src, ref_src = events, ref_events
    ck, ref_ck = str(tmp_path / "ck.npz"), str(tmp_path / "ref_ck.npz")
    ref = RefDaemon(RefController(ref_manifest, _ref_cfg()))
    want = ref.run(ref_src, checkpoint_path=ref_ck, metrics_path=str(tmp_path / "r.jsonl"))
    d = StreamDaemon(_controller(manifest))
    got = d.run(src, checkpoint_path=ck, metrics_path=str(tmp_path / "p.jsonl"))

    _assert_records_match(d.records, ref.records)
    assert _digest_without_latency(got) == _digest_without_latency(want)
    assert got["epochs_published"] == len(d.records) >= 4
    ep, ref_ep = d.publisher.peek(), ref.publisher.peek()
    assert (ep.epoch_id, ep.window, ep.plan_hash, ep.map_epoch_id, ep.n_nodes) == \
        (ref_ep.epoch_id, ref_ep.window, ref_ep.plan_hash, ref_ep.map_epoch_id, ref_ep.n_nodes)
    np.testing.assert_array_equal(ep.rf, ref_ep.rf)
    np.testing.assert_array_equal(ep.category_idx, ref_ep.category_idx)
    np.testing.assert_array_equal(ep.rf, d.controller.current_rf)
    pid = np.random.default_rng(seed).integers(0, len(manifest), size=500).astype(np.int32)
    rv, ref_rv = ep.read_view(pid), ref_ep.read_view(pid)
    np.testing.assert_array_equal(rv.replica_map, ref_rv.replica_map)
    np.testing.assert_array_equal(rv.pid, ref_rv.pid)
    # The cursor meta in the checkpoint is the reference's.
    meta = ReplicationController(manifest, _cfg())
    meta.load_checkpoint(ck)
    ref_meta = RefController(ref_manifest, _ref_cfg())
    ref_meta.load_checkpoint(ref_ck)
    assert meta.last_checkpoint_meta["daemon"] == ref_meta.last_checkpoint_meta["daemon"]
    # The metrics streams hold the same events apart from the clocks.
    def trace_events(path):
        evs = [json.loads(ln) for ln in open(path)]
        for e in evs:
            for key in ("seconds", "total_ns", "segments_ns", "ref_ns", "spans",
                        "exemplar", *DRIFT_KEYS):
                e.pop(key, None)
        return evs
    assert trace_events(tmp_path / "p.jsonl") == trace_events(tmp_path / "r.jsonl")


def test_decision_traces_reconcile_and_the_epoch_serves_the_placement(tmp_path, workload):
    manifest, events, _, _ = workload
    src = _write_log(events, manifest, tmp_path / "ev.cdrsb", 2048)
    d = StreamDaemon(_controller(manifest), DaemonConfig(trace_exemplars=2))
    dig = d.run(src, metrics_path=str(tmp_path / "m.jsonl"))
    evs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    traces = [e for e in evs if e["kind"] == "decision_trace"]
    assert len(traces) == dig["traced_decisions"] == dig["windows_processed"]
    assert all(sum(t["segments_ns"].values()) == t["total_ns"] for t in traces)
    assert [t["trace"] for t in traces] == [f"d{w:06d}" for w in range(len(traces))]
    assert 1 <= sum(t["exemplar"] for t in traces) <= len(traces)
    assert all(t["spans"][0]["dur_ns"] == t["total_ns"] for t in traces if t["exemplar"])
    # Serving from the pinned epoch: every row is the CPU placement, with
    # rf distinct nodes and the primary first.
    ep = d.publisher.pin()
    assert ep.trace_id == traces[-1]["trace"] and ep.epoch_id in d.publisher.first_pins
    pid = np.random.default_rng(7).integers(0, len(manifest), size=3000)
    rv = ep.read_view(pid)
    rows = rv.replica_map[rv.pid]
    topo = ClusterTopology(nodes=tuple(manifest.nodes))
    # A fresh map of the same flat topology: epoch 0 places as every revision.
    want, rf = EpochMap(manifest.nodes, topo).placement(0, pid, ep.rf[pid],
                                                         manifest.primary_node_id[pid])
    np.testing.assert_array_equal(rows, want)
    prim = primary_on_topology(manifest.nodes, manifest.primary_node_id[pid], topo)
    assert (rows[:, 0] == prim).all()
    for row, r in zip(rows, rf):
        assert len(set(row[:r].tolist())) == r


@pytest.mark.parametrize("stop_after", [1, 2, 4])
def test_stop_and_resume_is_bit_identical_with_fewer_events(tmp_path, workload, stop_after):
    manifest, events, _, _ = workload
    src = _write_log(events, manifest, tmp_path / "ev.cdrsb", 2048)
    full = StreamDaemon(_controller(manifest))
    full.run(src)
    ck = str(tmp_path / "d.ckpt")
    d1 = StreamDaemon(_controller(manifest), DaemonConfig(max_windows=stop_after))
    assert d1.run(src, checkpoint_path=ck)["stop_reason"] == "max_windows"
    d2 = StreamDaemon(_controller(manifest))
    dig2 = d2.run(src, checkpoint_path=ck)
    assert _strip(d1.records) + _strip(d2.records) == _strip(full.records)
    assert dig2["epochs_published"] == len(full.records)
    assert d2.publisher.peek().epoch_id == len(full.records)
    assert d2.events_ingested < len(events)
    np.testing.assert_array_equal(d2.controller.current_rf, full.controller.current_rf)
    np.testing.assert_array_equal(d2.controller.current_cat, full.controller.current_cat)


def test_feed_resume_and_a_grown_log_tail(tmp_path, workload):
    """An in-memory feed resumes by event count; a resume over a grown log
    folds the late tail of the last planned window."""
    manifest, events, _, _ = workload
    batches = [EventLog(ts=events.ts[lo:lo + 500], path_id=events.path_id[lo:lo + 500],
                        op=events.op[lo:lo + 500], client_id=events.client_id[lo:lo + 500],
                        clients=events.clients) for lo in range(0, len(events), 500)]
    full = StreamDaemon(_controller(manifest))
    full.run(iter(batches))
    ck = str(tmp_path / "feed.npz")
    d1 = StreamDaemon(_controller(manifest), DaemonConfig(max_windows=2))
    d1.run(iter(batches), checkpoint_path=ck)
    d2 = StreamDaemon(_controller(manifest))
    d2.run(iter(batches), checkpoint_path=ck)
    assert _strip(d1.records) + _strip(d2.records) == _strip(full.records)
    with pytest.raises(ValueError, match="binary-log daemon"):
        src = _write_log(events, manifest, tmp_path / "ev.cdrsb", 2048)
        ck2 = str(tmp_path / "bin.npz")
        StreamDaemon(_controller(manifest), DaemonConfig(max_windows=1)).run(
            src, checkpoint_path=ck2)
        StreamDaemon(_controller(manifest)).run(iter(batches), checkpoint_path=ck2)


def test_csv_source_is_refused(tmp_path, workload):
    manifest, events, _, _ = workload
    p = str(tmp_path / "a.log")
    events.write_csv(p, manifest)
    with pytest.raises(ValueError, match="binary event log"):
        StreamDaemon(_controller(manifest)).run(p)


def test_follow_mode_with_a_writer_and_a_timer_stop(tmp_path):
    manifest, events, _, _ = _workload(10, n_files=100, duration=480.0)
    p = str(tmp_path / "live.cdrsb")
    n = len(events)
    cuts = [0, n // 4, n // 2, 3 * n // 4, n]

    def part(i):
        return EventLog(ts=events.ts[cuts[i]:cuts[i + 1]],
                        path_id=events.path_id[cuts[i]:cuts[i + 1]],
                        op=events.op[cuts[i]:cuts[i + 1]],
                        client_id=events.client_id[cuts[i]:cuts[i + 1]], clients=events.clients)

    part(0).write_binary(p, manifest)
    ck = str(tmp_path / "f.npz")
    # Compile the carried init's jax path before the clock starts, so the
    # timer measures the daemon and not the reference's first trace.
    kmeans_jax_full(np.random.default_rng(0).random((len(manifest), 5), dtype=np.float32),
                    K, seed=KMEANS_SEED, max_iter=0, tol=0.0)
    d = StreamDaemon(_controller(manifest), DaemonConfig(follow=True, poll=0.05))

    def writer():
        for i in range(1, 4):
            time.sleep(0.2)
            part(i).write_binary(p, manifest, append=True)
        time.sleep(0.8)

    t = threading.Thread(target=writer)
    t.start()
    stopper = threading.Timer(2.0, d.request_stop, args=("SIGTERM",))
    stopper.start()
    dig = d.run(p, checkpoint_path=ck)
    t.join(timeout=30)
    stopper.cancel()
    assert not t.is_alive() and dig["stop_reason"] == "SIGTERM"
    ref = StreamDaemon(_controller(manifest))
    ref.run(p)
    k = len(d.records)
    assert k >= 2 and dig["epochs_published"] == k
    assert _strip(d.records) == _strip(ref.records)[:k]
    # The resume finishes the log as the uninterrupted run did.
    rest = StreamDaemon(_controller(manifest))
    rest.run(p, checkpoint_path=ck)
    assert _strip(d.records) + _strip(rest.records) == _strip(ref.records)


def _overfed(tmp_path, seed=0):
    manifest, events, ref_manifest, _ = _workload(seed, n_files=120, duration=1800.0)
    src = _write_log(events, manifest, tmp_path / f"over{seed}.cdrsb", 256)
    return manifest, ref_manifest, src


ENGAGE = (0.5, 1.0, 1.5, 2.0, 3.0)
RELEASE = (0.2, 0.4, 0.6, 0.8, 1.0)


def test_brownout_coalescing_matches_the_reference_and_replays(tmp_path):
    manifest, ref_manifest, src = _overfed(tmp_path)
    ref = RefDaemon(RefController(ref_manifest, _ref_cfg()), RefDaemonConfig(
        brownout=RefBrownout(engage=ENGAGE, release=RELEASE, hold=1)))
    want = ref.run(src)
    runs = []
    for _ in range(2):
        d = StreamDaemon(_controller(manifest), DaemonConfig(
            brownout=BrownoutConfig(engage=ENGAGE, release=RELEASE, hold=1)))
        runs.append((d, d.run(src)))
    (d, got), (d2, got2) = runs
    _assert_records_match(d.records, ref.records)
    assert d.brownout_log == ref.brownout_log and d.brownout_log
    assert _digest_without_latency(got) == _digest_without_latency(want)
    assert got["brownout"]["windows_coalesced"] > 0
    assert any(r["daemon"]["coalesced"] > 1 for r in d.records)
    assert sum(r["n_events"] for r in d.records) == d.events_ingested
    assert got["epochs_published"] == got["windows_processed"] == len(d.records)
    # A second run is byte-identical apart from the wall-clock fields.
    def canon(records):
        out = []
        for r in _strip(records):
            r = dict(r)
            r["daemon"] = {k: v for k, v in r["daemon"].items() if k != "lag_seconds"}
            out.append(json.dumps(r, sort_keys=True))
        return out
    assert canon(d.records) == canon(d2.records) and d.brownout_log == d2.brownout_log


def test_brownout_resume_is_bit_identical(tmp_path):
    manifest, _, src = _overfed(tmp_path, seed=1)

    def daemon(**kw):
        return StreamDaemon(_controller(manifest), DaemonConfig(
            brownout=BrownoutConfig(engage=ENGAGE, release=RELEASE, hold=1), **kw))

    full = daemon()
    full.run(src)
    n = len(full.records)
    for stop in (1, n // 2):
        ck = str(tmp_path / f"b{stop}.npz")
        d1 = daemon(max_windows=stop)
        d1.run(src, checkpoint_path=ck)
        d2 = daemon()
        assert d2.run(src, checkpoint_path=ck)["epochs_published"] == n
        assert _strip(d1.records) + _strip(d2.records) == _strip(full.records), stop


def test_a_page_alert_lands_a_protective_checkpoint(tmp_path, workload):
    """A page rule on a field the records carry: the checkpoint lands when
    it fires, with the cursor already past the window, as the reference."""
    manifest, events, ref_manifest, _ = workload
    src = _write_log(events, manifest, tmp_path / "ev.cdrsb", 1013)
    rule = dict(name="files_lost", field="moves_applied", op=">", value=0, severity="page")
    saves = {}
    for name, d, ck in (
            ("ref", RefDaemon(RefController(ref_manifest, _ref_cfg()),
                              RefDaemonConfig(checkpoint_every=10**6),
                              rules=(RefRule(**rule),) + ref_default_rules()[2:]), "r.npz"),
            ("port", StreamDaemon(_controller(manifest), DaemonConfig(checkpoint_every=10**6),
                                  rules=(AlertRule(**rule),) + default_rules()[2:]), "p.npz")):
        seen = saves[name] = []
        orig = d._save

        def save(path, _d=d, _orig=orig, _seen=seen):
            _seen.append((_d.controller.window_index, dict(_d._cursor)))
            _orig(path)

        d._save = save
        saves[name + "_digest"] = d.run(src, checkpoint_path=str(tmp_path / ck))
        saves[name + "_alerts"] = d.alert_log
    assert saves["port"] == saves["ref"] and len(saves["port"]) >= 2
    assert saves["port_alerts"] == saves["ref_alerts"]
    assert saves["port_digest"]["alert_checkpoints"] == \
        saves["ref_digest"]["alert_checkpoints"] >= 1
    assert "files_lost" in saves["port_digest"]["alerts_fired"]


def test_minibatch_tracker_matches_the_reference_from_a_carried_state(tmp_path, workload):
    manifest, events, ref_manifest, ref_events = workload
    c0 = np.random.default_rng(4).random((K, 5)).astype(np.float32)
    ref = RefDaemon(RefController(ref_manifest, _ref_cfg()),
                    RefDaemonConfig(recluster="minibatch", minibatch_rows=64))
    ref._mbk = RefMiniBatch(k=K, seed=KMEANS_SEED)
    ref._mbk.state = RefMiniBatchState(jnp.asarray(c0), jnp.zeros(K, jnp.int32), 0)
    d = StreamDaemon(_controller(manifest),
                     DaemonConfig(recluster="minibatch", minibatch_rows=64))
    d._mbk = MiniBatchKMeans(k=K, seed=KMEANS_SEED, device="cpu")
    d._mbk.state = minibatch_state_from_reference(c0, np.zeros(K, np.int32), 0, "cpu")
    steps = {"ref": [], "port": []}
    for name, dm, centroids in (("ref", ref, lambda m: np.asarray(m.centroids)),
                                ("port", d, lambda m: m.centroids.numpy())):
        orig = dm._minibatch_step

        def step(_dm=dm, _orig=orig, _out=steps[name], _c=centroids):
            _orig()
            _out.append((dict(_dm.minibatch), _c(_dm._mbk)))

        dm._minibatch_step = step
    want = ref.run(ref_events)
    got = d.run(events)
    assert len(steps["port"]) == len(steps["ref"]) == len(d.records) == 5
    for (g, gc), (w, wc) in zip(steps["port"], steps["ref"]):
        assert g["n_batches"] == w["n_batches"]
        assert abs(g["inertia"] - w["inertia"]) <= 1e-5 * abs(w["inertia"])
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
    assert got["minibatch"]["n_batches"] == want["minibatch"]["n_batches"] == 5
    _assert_records_match(d.records, ref.records)


def test_minibatch_tracker_starts_from_its_own_init(workload):
    manifest, events, _, _ = workload
    d = StreamDaemon(_controller(manifest), DaemonConfig(recluster="minibatch"))
    dig = d.run(events)
    assert dig["minibatch"]["n_batches"] == len(d.records)
    assert np.isfinite(dig["minibatch"]["inertia"]) and dig["minibatch"]["inertia"] > 0
    assert d._mbk.centroids.shape == (K, 5)
    with pytest.raises(ValueError, match="unknown recluster mode"):
        DaemonConfig(recluster="sometimes")
    with pytest.raises(ValueError, match="poll"):
        DaemonConfig(poll=0)
    with pytest.raises(ValueError, match="trace_exemplars"):
        DaemonConfig(trace_exemplars=-1)


def _windows(path):
    out = {}
    if os.path.exists(path):
        for line in open(path, encoding="utf-8"):
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if e.get("kind") == "window":
                out[e["window"]] = e["plan_hash"]
    return out


def test_sigkill_and_resume_give_the_uninterrupted_plans(tmp_path):
    """SIGKILL of the port's CLI daemon, following the log, after a seeded
    number of decisions; a resume from its checkpoint finishes with the
    uninterrupted run's plan hashes (cold re-clusters draw the port's own
    init here, in both runs)."""
    manifest, events, _, _ = _workload(3, n_files=200, duration=900.0)
    manifest.write_csv(str(tmp_path / "m.csv"))
    _write_log(events, manifest, tmp_path / "a.cdrsb", 997)
    opts = ["--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds", "60",
            "--k", "4", "--seed", "3", "--scoring_config", "validated", "--max_files", "40",
            "--device", "cpu"]

    def port(*args, **kw):
        return subprocess.Popen([sys.executable, "-m", "cdrs_tpu_torch", "daemon", *opts,
                                 *args], cwd=tmp_path, env=ENV, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, **kw)

    ref = port("--metrics", "ref.jsonl")
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err
    want = _windows(tmp_path / "ref.jsonl")
    n = len(want)
    assert n >= 10 and json.loads(out)["plan_hash"] == want[n - 1]
    kill_at = int(np.random.default_rng(20).integers(2, n - 2))
    victim = port("--follow", "--poll", "0.05", "--checkpoint", "ck.npz",
                  "--metrics", "kill.jsonl")
    try:
        deadline = time.monotonic() + 240
        while len(_windows(tmp_path / "kill.jsonl")) < kill_at:
            assert victim.poll() is None, victim.communicate()[1]
            assert time.monotonic() < deadline
            time.sleep(0.005)
        victim.send_signal(signal.SIGKILL)
    finally:
        victim.wait(timeout=60)
        victim.stdout.close()
        victim.stderr.close()
    assert victim.returncode == -signal.SIGKILL
    killed = _windows(tmp_path / "kill.jsonl")
    assert kill_at <= len(killed) < n
    res = port("--checkpoint", "ck.npz", "--metrics", "resume.jsonl")
    out, err = res.communicate(timeout=300)
    assert res.returncode == 0, err
    resumed = _windows(tmp_path / "resume.jsonl")
    for w in set(killed) & set(resumed):
        assert killed[w] == resumed[w], w   # a re-decided window decides alike
    assert {**killed, **resumed} == want
    assert json.loads(out)["epochs_published"] == n


def test_daemon_without_a_device_raises_on_a_cuda_less_host(tmp_path, workload):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    manifest, events, _, _ = workload
    manifest.write_csv(str(tmp_path / "m.csv"))
    _write_log(events, manifest, tmp_path / "a.cdrsb", 4096)
    proc = subprocess.run([sys.executable, "-m", "cdrs_tpu_torch", "daemon", "--manifest",
                           "m.csv", "--access_log", "a.cdrsb"], cwd=tmp_path, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
