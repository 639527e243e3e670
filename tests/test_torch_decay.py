"""Counter decay below 1 in the port's controller against
``cdrs_tpu.control.ReplicationController(backend="numpy")``, the only
reference backend that decays.

Each window folds into a fresh exact state; the four counters merge into
float64 accumulators (multiply, then add) and ``conc_max`` by a decayed
max, so the accumulators are the reference's ``_dec`` bit for bit.  The
reference clusters the float64 table, the port its float32 cast; both
start their full re-clusters from the reference's own k-means++ init,
recorded from its run and carried across.  Plan hashes and every other
record field are equal, the drift scalars within 1e-5.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
import cdrs_tpu.models.replication as ref_models  # noqa: E402
from cdrs_tpu.cli import main as reference_main  # noqa: E402
from cdrs_tpu.control import ControllerConfig as RefConfig  # noqa: E402
from cdrs_tpu.control import ReplicationController as RefController  # noqa: E402
from cdrs_tpu.features.streaming_np import finalize_counters as ref_finalize  # noqa: E402
from cdrs_tpu.ops.kmeans_np import kmeans_plusplus_init  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch import cli as port_cli  # noqa: E402
from cdrs_tpu_torch.config import (GeneratorConfig, KMeansConfig,  # noqa: E402
                                   SimulatorConfig, validated_scoring_config)
from cdrs_tpu_torch.control.controller import (ControllerConfig,  # noqa: E402
                                               ReplicationController, finalize_counters)
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.models.replication import ReplicationPolicyModel  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

K = 8
KMEANS_SEED = 42
DECAY = 0.7
DRIFT_KEYS = ("drift", "centroid_shift", "population_delta")
DEC_KEYS = ("access_freq", "writes", "local_acc", "conc_max")


def _workload(seed, n_files=200, gap=None):
    """Port and reference workloads; ``gap=(lo, hi)`` drops the events of
    those seconds (after the log's start), leaving empty windows."""
    m = generate_population(GeneratorConfig(n_files=n_files, seed=21 + seed))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=600.0, seed=22 + seed))
    rm = ref_generate(jcfg.GeneratorConfig(n_files=n_files, seed=21 + seed))
    rev = ref_simulate(rm, jcfg.SimulatorConfig(duration_seconds=600.0, seed=22 + seed))
    if gap is not None:
        t0 = float(np.floor(ev.ts[0]))
        keep = (ev.ts < t0 + gap[0]) | (ev.ts >= t0 + gap[1])
        ev = EventLog(ts=ev.ts[keep], path_id=ev.path_id[keep], op=ev.op[keep],
                      client_id=ev.client_id[keep], clients=ev.clients)
        rev = type(rev)(ts=rev.ts[keep], path_id=rev.path_id[keep], op=rev.op[keep],
                        client_id=rev.client_id[keep], clients=rev.clients)
    return m, ev, rm, rev


def _cfgs(**kw):
    base = dict(window_seconds=120.0, decay=DECAY, drift_threshold=0.02)
    base.update(kw)
    return (ControllerConfig(kmeans=KMeansConfig(k=K, seed=KMEANS_SEED),
                             scoring=validated_scoring_config(), device="cpu", **base),
            RefConfig(kmeans=jcfg.KMeansConfig(k=K, seed=KMEANS_SEED),
                      scoring=jcfg.validated_scoring_config(), backend="numpy", **base))


def _recording(ctl, inits):
    """Full re-clusters of the reference ``ctl`` start from k-means++ of the
    snapshot, appended to ``inits``."""
    run = ctl._model_full.run

    def run_recorded(X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = kmeans_plusplus_init(np.asarray(X), K, random_state=KMEANS_SEED)
            inits.append(init_centroids)
        return run(X, init_centroids=init_centroids, **kw)

    ctl._model_full.run = run_recorded
    return ctl


def _carrying(ctl, inits):
    """Full re-clusters of the port's ``ctl`` take the recorded inits in turn."""
    run = ctl._model_full.run
    it = iter(inits)

    def run_carried(X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = next(it).astype(np.float32)
        return run(X, init_centroids=init_centroids, **kw)

    ctl._model_full.run = run_carried
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
                assert abs(g[key] - w[key]) <= 1e-5, (w["window"], key, g[key], w[key])
            else:
                assert g[key] == w[key], (w["window"], key, g[key], w[key])


def _assert_accumulators_equal(ctl, ref):
    got = ctl.decayed_counters()
    for k in DEC_KEYS:
        assert got[k].dtype == np.float64 and np.array_equal(got[k], ref._dec[k]), k
    assert ctl._dec_obs_end == ref._dec_obs_end


def _run_pair(wl, **kw):
    m, ev, rm, rev = wl
    cfg, ref_cfg = _cfgs(**kw)
    inits = []
    ref = _recording(RefController(rm, ref_cfg), inits)
    want = ref.run(rev)
    ctl = _carrying(ReplicationController(m, cfg), inits)
    got = ctl.run(ev)
    _assert_records_match(got.records, want.records)
    _assert_accumulators_equal(ctl, ref)
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.category_idx, want.category_idx)
    return ctl, ref, got, want, inits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decay_matches_the_numpy_reference(seed):
    wl = _workload(seed)
    ctl, ref, got, want, _ = _run_pair(wl)
    assert sum(r["recluster"] for r in got.records) >= 2
    # The float64 table the port finalizes is the reference's.
    m, rm = wl[0], wl[2]
    raw, norm = finalize_counters(*(ctl.decayed_counters()[k] for k in DEC_KEYS), m,
                                  ctl._dec_obs_end)
    table = ref_finalize(*(ref._dec[k] for k in DEC_KEYS), rm, ref._dec_obs_end)
    assert np.array_equal(raw, np.asarray(table.raw)) and np.array_equal(norm,
                                                                        np.asarray(table.norm))
    # Decay re-weights toward recent traffic: the accumulators are below the
    # exact cumulative counts.
    exact = ReplicationController(m, _cfgs(decay=1.0)[0])
    exact._fold_window(wl[1])
    assert ctl.decayed_counters()["access_freq"].sum() < float(exact._state.access_freq.sum())


def test_an_empty_window_only_decays():
    wl = _workload(0, gap=(240.0, 480.0))
    ctl, _, got, _, _ = _run_pair(wl)
    empty = [r for r in got.records if r["n_events"] == 0]
    assert empty, [r["n_events"] for r in got.records]


def test_a_late_tail_does_not_decay_again():
    """A window's late tail (``new_window=False``) merges undecayed: the
    additive counters equal one fold of the whole window."""
    m, _, _, _ = _workload(0)
    ev = simulate_access(m, SimulatorConfig(duration_seconds=120.0, seed=5))
    half = len(ev) // 2
    parts = [EventLog(ts=ev.ts[a:b], path_id=ev.path_id[a:b], op=ev.op[a:b],
                      client_id=ev.client_id[a:b], clients=ev.clients)
             for a, b in ((0, half), (half, len(ev)))]
    tail, whole, twice = (ReplicationController(m, _cfgs()[0]) for _ in range(3))
    for ctl in (tail, whole, twice):
        ctl._fold_window(ev)        # an earlier window, so that decay bites
    tail._fold_window(parts[0])
    tail._fold_window(parts[1], new_window=False)
    whole._fold_window(ev)
    twice._fold_window(parts[0])
    twice._fold_window(parts[1])
    a, b, c = (x.decayed_counters() for x in (tail, whole, twice))
    for k in ("access_freq", "writes", "local_acc"):
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["access_freq"], c["access_freq"])


def test_kill_and_resume_is_bit_identical(tmp_path):
    m, ev, _, _ = _workload(1)
    cfg, _ = _cfgs(max_files_per_window=40)
    ctl = ReplicationController(m, cfg)
    full = ctl.run(ev)
    ck = str(tmp_path / "decay.npz")
    a = ReplicationController(m, cfg).run(ev, checkpoint_path=ck, max_windows=2)
    resumed = ReplicationController(m, cfg)
    b = resumed.run(ev, checkpoint_path=ck)
    assert _strip(a.records) + _strip(b.records) == _strip(full.records)
    assert sum(r["backlog_files"] > 0 for r in full.records) >= 2
    for k in DEC_KEYS:
        assert np.array_equal(resumed.decayed_counters()[k], ctl.decayed_counters()[k]), k
    assert resumed._dec_obs_end == ctl._dec_obs_end
    # A decayed checkpoint does not load into a decay-1 controller.
    with pytest.raises(ValueError, match="decay"):
        ReplicationController(m, _cfgs(decay=1.0)[0]).run(ev, checkpoint_path=ck)


def test_cli_control_decay(tmp_path, monkeypatch):
    """``control --decay 0.7 --device cpu`` and ``cdrs control --decay 0.7
    --backend numpy`` over the same files, full re-clusters from the
    reference's recorded inits: equal summaries apart from the clocks."""
    inits = []
    ref_run = ref_models.ReplicationPolicyModel.run

    def recorded(self, X, feature_names=None, init_centroids=None):
        if init_centroids is None:
            init_centroids = kmeans_plusplus_init(np.asarray(X), self.kmeans_cfg.k,
                                                  random_state=self.kmeans_cfg.seed)
            inits.append(init_centroids)
        return ref_run(self, X, feature_names=feature_names, init_centroids=init_centroids)

    port_run = ReplicationPolicyModel.run
    carried = iter(inits)

    def carrying(self, X, init_centroids=None, **kw):
        if init_centroids is None:
            init_centroids = next(carried).astype(np.float32)
        return port_run(self, X, init_centroids=init_centroids, **kw)

    monkeypatch.setattr(ref_models.ReplicationPolicyModel, "run", recorded)
    monkeypatch.setattr(ReplicationPolicyModel, "run", carrying)
    monkeypatch.chdir(tmp_path)
    assert port_cli.main(["gen", "--n", "300", "--seed", "5", "--out_manifest", "m.csv"]) == 0
    assert port_cli.main(["simulate", "--manifest", "m.csv", "--out", "a.cdrsb",
                          "--duration_seconds", "600", "--seed", "6"]) == 0
    args = ["control", "--manifest", "m.csv", "--access_log", "a.cdrsb", "--window_seconds",
            "120", "--k", "4", "--scoring_config", "validated", "--drift_threshold", "0.02",
            "--decay", str(DECAY)]
    outs = []
    for main, extra in ((reference_main, ["--backend", "numpy"]),
                        (port_cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(json.loads(buf.getvalue()))
    want, got = outs
    assert inits
    for d in (got, want):
        for key in ("seconds", "windows_per_sec", "plan_seconds_fraction"):
            d.pop(key)
    assert got == want and got["reclusters"] >= 1
