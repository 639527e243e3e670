"""The port's replication controller against
``cdrs_tpu.control.ReplicationController(backend="jax")``, and its own
contracts.

The reference's fixture shape (200 files, 600 s of traffic, 120 s windows,
k = 8, validated scoring) on seeds 0/1/2, and a hot/archival shift with a
low drift threshold.  The port runs on the CPU in float32, as the reference
does on its jax backend.  Its cold inits carry the reference's D² init
across (the port does not reproduce threefry): the full model's ``run`` is
patched to start from ``kmeans_jax_full(X, k, seed, max_iter=0)`` of the
same snapshot.  Every window's record fields are identical, plan hashes
included, the drift scalars agree within 1e-6, and the final per-file rf
and categories are identical.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.ops.kmeans_jax import kmeans_jax_full  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.access import simulate_access_with_shift  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.config import (CATEGORIES, GeneratorConfig, KMeansConfig,  # noqa: E402
                                   SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import (ControllerConfig,  # noqa: E402
                                               ReplicationController)
from cdrs_tpu_torch.features.streaming import stream_init, stream_update  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

K = 8
KMEANS_SEED = 42
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")


def _workload(seed, n_files=200):
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=21 + seed))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=600.0, seed=22 + seed))
    return manifest, events


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


def _carry_reference_init(monkeypatch, ctl):
    """Cold (full) re-clusters of ``ctl`` start from the reference's D² init
    of the same snapshot."""
    full = ctl._model_full
    run = full.run

    def run_from_reference_init(X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = np.asarray(kmeans_jax_full(
                X.cpu().numpy(), K, seed=KMEANS_SEED, max_iter=0, tol=0.0)[0])
        return run(X, init_centroids=init_centroids, **kw)

    monkeypatch.setattr(full, "run", run_from_reference_init)


def _assert_records_match(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
        for key in w:
            if key == "seconds":
                assert set(g[key]) == set(w[key])
            elif key in DRIFT_KEYS and w[key] is not None:
                assert abs(g[key] - w[key]) <= 1e-6, (w["window"], key, g[key], w[key])
            else:
                assert g[key] == w[key], (w["window"], key, g[key], w[key])


def _hashes(res):
    return [r["plan_hash"] for r in res.records]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_reference(seed, monkeypatch):
    manifest, events = _workload(seed)
    ref_manifest = ref_generate(jcfg.GeneratorConfig(n_files=200, seed=21 + seed))
    ref_events = ref_simulate(ref_manifest,
                              jcfg.SimulatorConfig(duration_seconds=600.0, seed=22 + seed))
    want = RefController(ref_manifest, _ref_cfg()).run(ref_events)
    ctl = ReplicationController(manifest, _cfg())
    _carry_reference_init(monkeypatch, ctl)
    got = ctl.run(events)

    _assert_records_match(got.records, want.records)
    assert [r["recluster_mode"] for r in got.records][0] == "full"
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.category_idx, want.category_idx)
    g, w = got.summary(), want.summary()
    assert set(g) == set(w)
    for key in ("windows", "events", "reclusters", "full_reclusters", "moves_applied",
                "bytes_migrated", "final_plan_hash"):
        assert g[key] == w[key], key


def test_controller_matches_reference_on_a_shifted_workload(monkeypatch):
    """A hot/archival flip halfway through 1,200 s, drift threshold 0.02:
    warm re-clusters from float32 accepted centroids, identical plans."""
    ref_manifest = ref_generate(jcfg.GeneratorConfig(n_files=300, seed=7))
    ref_events, flipped = simulate_access_with_shift(
        ref_manifest, jcfg.SimulatorConfig(duration_seconds=1200.0, seed=8), shift_at=600.0,
        category_flip={"hot": "archival", "archival": "hot"})
    assert flipped.sum() > 10
    manifest = generate_population(GeneratorConfig(n_files=300, seed=7))
    events = EventLog(ts=ref_events.ts, path_id=ref_events.path_id, op=ref_events.op,
                      client_id=ref_events.client_id, clients=list(ref_events.clients))
    kw = dict(drift_threshold=0.02, max_files_per_window=60)
    want = RefController(ref_manifest, _ref_cfg(**kw)).run(ref_events)
    ctl = ReplicationController(manifest, _cfg(**kw))
    _carry_reference_init(monkeypatch, ctl)
    got = ctl.run(events)

    _assert_records_match(got.records, want.records)
    assert sum(r["recluster_mode"] == "warm" for r in got.records) >= 1
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.category_idx, want.category_idx)


# -- the port alone ---------------------------------------------------------

def test_two_runs_are_identical(workload):
    manifest, events = workload
    a = ReplicationController(manifest, _cfg(drift_threshold=0.02)).run(events)
    b = ReplicationController(manifest, _cfg(drift_threshold=0.02)).run(events)
    assert _hashes(a) == _hashes(b)
    assert [{k: v for k, v in r.items() if k != "seconds"} for r in a.records] == \
        [{k: v for k, v in r.items() if k != "seconds"} for r in b.records]


def test_kill_resume_is_bit_identical(tmp_path, workload):
    manifest, events = workload
    kw = dict(drift_threshold=0.02, max_files_per_window=40, hysteresis_windows=1)
    full = ReplicationController(manifest, _cfg(**kw)).run(events)
    assert len(full.records) >= 4
    ck = str(tmp_path / "ctl.npz")
    a = ReplicationController(manifest, _cfg(**kw)).run(events, checkpoint_path=ck,
                                                        max_windows=2)
    b = ReplicationController(manifest, _cfg(**kw)).run(events, checkpoint_path=ck)
    assert [r["window"] for r in b.records] == list(range(2, len(full.records)))
    assert _hashes(a) + _hashes(b) == _hashes(full)
    np.testing.assert_array_equal(b.rf, full.rf)
    np.testing.assert_array_equal(b.category_idx, full.category_idx)
    assert b.summary()["checkpoint"]["saves"] == len(b.records)


def test_max_windows_zero_is_a_noop(tmp_path, workload):
    manifest, events = workload
    ck = str(tmp_path / "noop.npz")
    ctl = ReplicationController(manifest, _cfg())
    res = ctl.run(events, checkpoint_path=ck, max_windows=0)
    assert res.records == [] and ctl._events_total == 0 and ctl.window_index == 0
    assert not os.path.exists(ck)


def test_stale_checkpoint_raises_and_a_corrupt_one_falls_back(tmp_path, workload):
    manifest, events = workload
    ck = str(tmp_path / "ctl.npz")
    ReplicationController(manifest, _cfg()).run(events, checkpoint_path=ck, max_windows=2)
    with pytest.raises(ValueError, match="stale checkpoint"):
        ReplicationController(manifest, _cfg(kmeans=KMeansConfig(k=12, seed=42))).run(
            events, checkpoint_path=ck)
    with pytest.raises(ValueError, match="stale checkpoint"):
        ReplicationController(manifest, _cfg(window_seconds=60.0)).run(
            events, checkpoint_path=ck)
    # A torn snapshot resumes from the retained .prev (one window older).
    with open(ck, "r+b") as f:
        f.truncate(100)
    ctl = ReplicationController(manifest, _cfg())
    with pytest.warns(RuntimeWarning, match="falling back"):
        ctl._load_checkpoint_with_fallback(ck)
    assert ctl.window_index == 1


def test_resume_over_a_grown_log_folds_the_tail(tmp_path, workload):
    manifest, events = workload
    t0 = float(np.floor(events.ts[0]))
    cut = int(np.searchsorted(events.ts, t0 + 540.0))
    first = EventLog(ts=events.ts[:cut], path_id=events.path_id[:cut], op=events.op[:cut],
                     client_id=events.client_id[:cut], clients=events.clients)
    ck = str(tmp_path / "grow.npz")
    ReplicationController(manifest, _cfg()).run(first, checkpoint_path=ck)
    resumed = ReplicationController(manifest, _cfg())
    assert resumed.run(events, checkpoint_path=ck).records == []
    assert resumed._events_total == len(events)
    pure = stream_update(stream_init(len(manifest), "cpu"), events, manifest)
    for name in ("access_freq", "writes", "local_acc", "conc_max"):
        assert torch.equal(getattr(resumed._state, name), getattr(pure, name)), name
    third = ReplicationController(manifest, _cfg())
    third.run(events, checkpoint_path=ck)
    assert third._events_total == len(events)
    assert torch.equal(third._state.access_freq, pure.access_freq)


def test_metrics_jsonl_sink(tmp_path, workload):
    manifest, events = workload
    mp = str(tmp_path / "metrics.jsonl")
    res = ReplicationController(manifest, _cfg()).run(events, metrics_path=mp)
    with open(mp) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == len(res.records)
    assert all(ln["kind"] == "window" for ln in lines)
    assert [ln["plan_hash"] for ln in lines] == _hashes(res)
    assert set(lines[0]["seconds"]) >= {"fold", "drift", "recluster", "schedule",
                                        "evaluate", "plan", "total"}


def test_plan_entries(workload, tmp_path):
    manifest, events = workload
    res = ReplicationController(manifest, _cfg()).run(events)
    entries = res.plan_entries()
    assert len(entries) == len(manifest)
    planned = [e for e in entries if e.category != "Unplanned"]
    assert planned and all(e.category in CATEGORIES for e in planned)
    rf_table = validated_scoring_config().replication_factors
    assert all(e.rf == rf_table[e.category] for e in planned)


@pytest.mark.parametrize("checkpoint_every", [None, 1, 2])
def test_overlap_windows_match_the_serial_order(tmp_path, workload, checkpoint_every):
    manifest, events = workload
    kw = dict(drift_threshold=0.02, max_files_per_window=50)
    serial = ReplicationController(manifest, _cfg(**kw)).run(events)
    run_kw = {}
    if checkpoint_every:
        run_kw = dict(checkpoint_path=str(tmp_path / "o.npz"),
                      checkpoint_every=checkpoint_every)
    overlap = ReplicationController(manifest, _cfg(overlap_windows=True, **kw)).run(
        events, **run_kw)
    strip = [{k: v for k, v in r.items() if k != "seconds"} for r in serial.records]
    assert [{k: v for k, v in r.items() if k != "seconds"}
            for r in overlap.records] == strip
    np.testing.assert_array_equal(overlap.rf, serial.rf)


def test_budgets_are_respected(workload):
    manifest, events = workload
    res = ReplicationController(manifest, _cfg(max_files_per_window=23, hysteresis_windows=0,
                                               drift_threshold=10.0)).run(events)
    applied = np.cumsum([r["moves_applied"] for r in res.records])
    assert applied[-1] == min(len(manifest), 23 * len(res.records))
    cap = int(np.max(manifest.size_bytes)) * 3 + 1
    res = ReplicationController(manifest, _cfg(max_bytes_per_window=cap,
                                               hysteresis_windows=0)).run(events)
    assert all(r["bytes_migrated"] <= cap for r in res.records)
    assert sum(r["moves_applied"] for r in res.records) > 0


@pytest.mark.parametrize("option,value,match", [
    ("mesh_shape", {"data": 4}, "A9"), ("mesh_shape", {"data": 2}, "A9"),
    ("decay", 0.0, "decay"), ("decay", 1.5, "decay"),
    ("window_seconds", 0.0, "window_seconds"),
])
def test_unported_options_raise(option, value, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**{option: value})


@pytest.mark.parametrize("option", ["materialized_hash", "elastic", "functional"])
def test_placement_and_elastic_options_are_accepted_and_run(option, workload):
    """The hash placement modes and elasticity (ROADMAP A8f) build and run,
    each record stamped with its placement mode."""
    from cdrs_tpu_torch.control.elastic import ElasticPolicy
    from cdrs_tpu_torch.serve import ServeConfig

    manifest, events = workload
    kw = {"placement_mode": option}
    if option == "elastic":
        kw = {"placement_mode": "functional", "serve": ServeConfig(),
              "elastic": ElasticPolicy(pool=("sb1",))}
    res = ReplicationController(manifest, _cfg(**kw)).run(events, max_windows=2)
    assert len(res.records) == 2
    assert all(r["placement"]["mode"] == kw["placement_mode"] for r in res.records)
    if option == "elastic":
        assert all("elastic" in r and "durability" in r for r in res.records)


@pytest.mark.parametrize("option", ["fault_schedule", "topology", "scrub", "decay"])
def test_fault_path_and_decay_options_are_accepted(option):
    from cdrs_tpu_torch.cluster.placement import ClusterTopology
    from cdrs_tpu_torch.faults import FaultSchedule, ScrubConfig

    kw = {"decay": dict(decay=0.7),
          "fault_schedule": dict(fault_schedule=FaultSchedule.from_specs(["crash:dn1@1"])),
          "topology": dict(fault_schedule=FaultSchedule.from_specs(["crash:dn1@1"]),
                           topology=ClusterTopology.from_rack_spec(("dn1", "dn2"), "dn1;dn2")),
          "scrub": dict(fault_schedule=FaultSchedule.from_specs(["crash:dn1@1"]),
                        scrub=ScrubConfig(bytes_per_window=1000))}[option]
    cfg = _cfg(**kw)
    assert getattr(cfg, option) == kw[option]


def test_failing_recluster_propagates(tmp_path, workload, monkeypatch):
    """No degraded mode: a failure of the model's run leaves ``run`` and
    nothing is re-clustered elsewhere."""
    manifest, events = workload
    ctl = ReplicationController(manifest, _cfg(drift_threshold=0.0))
    calls = []

    def broken(X, init_centroids=None, **kw):
        calls.append(X.device)
        if len(calls) == 2:
            raise RuntimeError("kernel launch failed")
        return ReplicationController._make_model(ctl, warm=False).run(
            X, init_centroids=init_centroids)

    monkeypatch.setattr(ctl._model_full, "run", broken)
    monkeypatch.setattr(ctl._model_warm, "run", broken)
    mp = str(tmp_path / "m.jsonl")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ctl.run(events, metrics_path=mp)
    assert len(calls) == 2 and ctl.window_index == 1
    with open(mp) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == 1 and not any("degraded_kernel" in ln for ln in lines)


def test_controller_without_device_raises_on_a_cuda_less_host(workload):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicationController(workload[0], _cfg(device=None))


def test_summary_pacing(workload):
    manifest, events = workload
    summary = ReplicationController(manifest, _cfg()).run(events).summary()
    assert summary["windows"] == 5 and summary["reclusters"] >= 1
    assert summary["windows_per_sec"] > 0 and math.isfinite(summary["plan_seconds_fraction"])
