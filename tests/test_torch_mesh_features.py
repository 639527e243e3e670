"""The port's sharded features against one device and against the reference's
sharded kernels on its 8 virtual CPU devices: the batch pass
(``compute_features_torch(mesh_shape=)`` against
``compute_features_jax(mesh_shape=)``) and the stream fold
(``stream_update``/``fold_stream(mesh_shape=)`` against the reference's
``stream_update(mesh_shape=)``).  The counters are integers, so every
table is bit-identical to one device, a hot second that spans shards
included; an unsorted log is refused on a mesh, as in the reference.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.features import streaming as jstream  # noqa: E402
from cdrs_tpu.features.jax_backend import compute_features_jax  # noqa: E402
from cdrs_tpu.io.events import EventLog as JEventLog  # noqa: E402
from cdrs_tpu.io.events import Manifest as JManifest  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.features import streaming as S  # noqa: E402
from cdrs_tpu_torch.features.batch import compute_features_torch  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog, Manifest  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

COUNTERS = ("access_freq", "writes", "local_acc", "conc_max", "last_sec", "last_count")


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


@pytest.fixture(scope="module")
def workload():
    manifest = generate_population(GeneratorConfig(n_files=150, seed=9))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=120.0, seed=10))
    ref_m = jgenerate(jcfg.GeneratorConfig(n_files=150, seed=9))
    ref_e = jsimulate(ref_m, jcfg.SimulatorConfig(duration_seconds=120.0, seed=10))
    return manifest, events, ref_m, ref_e


def _tables_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("raw", "norm", "writes",
                                                                   "reads"))


def _slice(events, lo, hi, cls=EventLog):
    return cls(ts=events.ts[lo:hi], path_id=events.path_id[lo:hi], op=events.op[lo:hi],
               client_id=events.client_id[lo:hi], clients=events.clients)


@pytest.mark.parametrize("ndata", [2, 3, 8])
def test_batch_features_on_a_mesh(workload, ndata):
    manifest, events, ref_m, ref_e = workload
    one = compute_features_torch(manifest, events, device="cpu", dtype="float64")
    got = compute_features_torch(manifest, events, device="cpu", dtype="float64",
                                 mesh_shape={"data": ndata})
    assert _tables_equal(got, one)
    want = compute_features_jax(ref_m, ref_e, mesh_shape={"data": ndata})
    for j in (0, 3, 4):   # access_freq, locality, concurrency: integer-derived
        np.testing.assert_array_equal(got.raw.numpy()[:, j], want.raw[:, j])
    np.testing.assert_allclose(got.raw.numpy(), want.raw, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.norm.numpy(), want.norm, rtol=1e-12, atol=1e-15)
    # float32, and the model axis ignored by the event shards
    f32 = compute_features_torch(manifest, events, device="cpu",
                                 mesh_shape={"data": ndata, "model": 2})
    assert _tables_equal(f32, compute_features_torch(manifest, events, device="cpu"))


def _hot_second_log():
    """The reference's hot-second case (tests/test_features_jax.py): 40
    events, 33 of them one file's in one second, more than four of eight
    shards of five events."""
    n = 4
    man = dict(paths=[f"/f{i}" for i in range(n)], creation_ts=np.full(n, 1.0e9),
               primary_node_id=np.zeros(n, dtype=np.int32),
               size_bytes=np.ones(n, dtype=np.int64), category=["moderate"] * n,
               nodes=["dn1"])
    base = 1.7e9
    ts = np.concatenate([base + np.linspace(0.0, 0.9, 3),
                         base + 1.0 + np.linspace(0.0, 0.99, 33),
                         base + 2.0 + np.linspace(0.0, 0.9, 4)])
    pid = np.concatenate([np.full(3, 1), np.full(33, 0), np.full(4, 2)]).astype(np.int32)
    cols = dict(ts=ts, path_id=pid, op=np.zeros(40, np.int8),
                client_id=np.zeros(40, np.int32), clients=["dn1"])
    return Manifest(**man), EventLog(**cols), JManifest(**man), JEventLog(**cols)


@pytest.mark.parametrize("ndata", [3, 8])
def test_hot_second_across_shards_counts_once(ndata):
    pm, pe, rm, re = _hot_second_log()
    got = compute_features_torch(pm, pe, device="cpu", dtype="float64",
                                 mesh_shape={"data": ndata})
    assert got.raw[0, 4].item() == 33.0
    assert _tables_equal(got, compute_features_torch(pm, pe, device="cpu", dtype="float64"))
    want = compute_features_jax(rm, re, mesh_shape={"data": ndata})
    np.testing.assert_array_equal(got.raw.numpy()[:, 4], want.raw[:, 4])
    # The same log folded in batches over a mesh: the carry and the edges.
    state = S.stream_init(len(pm), "cpu")
    for lo in range(0, 40, 17):
        state = S.stream_update(state, _slice(pe, lo, lo + 17), pm,
                                mesh_shape={"data": ndata})
    assert state.conc_max[0].item() == 33


def test_unsorted_logs_are_refused_on_a_mesh(workload):
    manifest, events, _, _ = workload
    perm = np.random.default_rng(0).permutation(len(events))
    shuffled = EventLog(ts=events.ts[perm], path_id=events.path_id[perm],
                        op=events.op[perm], client_id=events.client_id[perm],
                        clients=events.clients)
    with pytest.raises(ValueError, match="time-sorted"):
        compute_features_torch(manifest, shuffled, device="cpu", mesh_shape={"data": 4})
    with pytest.raises(ValueError, match="time-sorted"):
        S.stream_update(S.stream_init(len(manifest), "cpu"), shuffled, manifest,
                        mesh_shape={"data": 2})
    # One device takes it.
    compute_features_torch(manifest, shuffled, device="cpu")


@pytest.mark.parametrize("ndata", [2, 8])
@pytest.mark.parametrize("n_batches", [1, 5])
def test_stream_fold_on_a_mesh(workload, ndata, n_batches):
    """Every counter, the carry included, equals the one-device fold and the
    reference's sharded fold on the same cuts, and so do the padded rows
    the reference's snapshots record."""
    manifest, events, ref_m, ref_e = workload
    cuts = np.linspace(0, len(events), n_batches + 1).astype(int)
    cuts[1:-1] += 7
    one = S.stream_init(len(manifest), "cpu")
    got = S.stream_init(len(manifest), "cpu")
    ref = jstream.stream_init(len(ref_m))
    mesh = {"data": ndata}
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        one = S.stream_update(one, _slice(events, lo, hi), manifest)
        got = S.stream_update(got, _slice(events, lo, hi), manifest, mesh_shape=mesh)
        ref = jstream.stream_update(ref, _slice(ref_e, lo, hi, JEventLog), ref_m,
                                    mesh_shape=mesh)
    for name in COUNTERS:
        assert torch.equal(getattr(got, name), getattr(one, name)), name
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (got.n_events, got.pad_events, got.observation_end) == \
        (ref.n_events, ref.pad_events, ref.observation_end)
    assert _tables_equal(S.stream_finalize(got, manifest),
                         compute_features_torch(manifest, events, device="cpu"))


def test_fold_stream_resumes_across_meshes(tmp_path, workload, monkeypatch):
    """The reference's cross-mesh resume (tests/test_checkpoint.py): a fold
    that crashes on a data = 8 mesh resumes on data = 2 bit for bit (the
    state holds integer counters and no mesh)."""
    manifest, events, _, _ = workload
    log = str(tmp_path / "a.cdrsb")
    events.write_binary(log, manifest, block_rows=400)
    golden = S.fold_stream(log, manifest, device="cpu", batch_size=400)
    real, calls = S._fold_prepped, {"n": 0}

    def crash_after_three(state, pb):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("card lost")
        return real(state, pb)

    ckpt = str(tmp_path / "s.npz")
    monkeypatch.setattr(S, "_fold_prepped", crash_after_three)
    with pytest.raises(RuntimeError, match="card lost"):
        S.fold_stream(log, manifest, device="cpu", batch_size=400, mesh_shape={"data": 8},
                      checkpoint_path=ckpt, checkpoint_every=1)
    monkeypatch.setattr(S, "_fold_prepped", real)
    assert os.path.exists(ckpt)
    stats = {}
    resumed = S.fold_stream(log, manifest, device="cpu", batch_size=400,
                            mesh_shape={"data": 2}, checkpoint_path=ckpt, stats=stats)
    assert stats["resumed_from_offset"] > 0
    for name in COUNTERS:
        assert torch.equal(getattr(resumed, name), getattr(golden, name)), name
    assert _tables_equal(S.stream_finalize(resumed, manifest),
                         S.stream_finalize(golden, manifest))
