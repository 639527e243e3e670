"""The port's streaming feature fold (``features/streaming.py``) against its
own batch pass and against ``cdrs_tpu.features.streaming``.

* Any batch split folds to a table bit-equal to the port's batch features
  on the same device (one copy of the formulas serves both).
* The int32 counters equal the reference fold's exactly.
* The finalized table is within ``test_torch_features.py``'s tolerances of
  the reference's ``stream_finalize``: exact on the integer-derived
  columns and 1e-12 relative elsewhere at float64; one float32 rounding
  (1e-6 relative, 1e-7 absolute near 0) at float32.
* Checkpoints resume bit-identically, and snapshots load in either package.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import cdrs_tpu.config as jcfg  # noqa: E402
from cdrs_tpu.features import streaming as jstream  # noqa: E402
from cdrs_tpu.io.events import EventLog as JEventLog  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as jsimulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as jgenerate  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.features import streaming as S  # noqa: E402
from cdrs_tpu_torch.features.batch import compute_features_torch  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402
from cdrs_tpu_torch.utils.checkpoint import CheckpointError, load_state, save_state  # noqa: E402

COUNTERS = ("access_freq", "writes", "local_acc", "conc_max", "last_sec", "last_count")
EXACT_RAW = (0, 3, 4)        # access_freq, locality, concurrency


@pytest.fixture(autouse=True)
def _deterministic():
    from cdrs_tpu_torch.device import deterministic

    with deterministic():
        yield


@pytest.fixture(scope="module")
def workload():
    manifest = generate_population(GeneratorConfig(n_files=100, seed=3))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=90.0, seed=3))
    ref_m = jgenerate(jcfg.GeneratorConfig(n_files=100, seed=3))
    ref_e = jsimulate(ref_m, jcfg.SimulatorConfig(duration_seconds=90.0, seed=3))
    return manifest, events, ref_m, ref_e


def _slice(events, lo, hi, cls=EventLog):
    return cls(ts=events.ts[lo:hi], path_id=events.path_id[lo:hi], op=events.op[lo:hi],
               client_id=events.client_id[lo:hi], clients=events.clients)


def _cuts(e, n_batches):
    """The reference test's uneven cuts, shifted off natural boundaries."""
    cuts = np.linspace(0, e, n_batches + 1).astype(int)
    cuts[1:-1] += 13
    return np.clip(cuts, 0, e)


def _fold(manifest, events, n_batches):
    state = S.stream_init(len(manifest), "cpu")
    cuts = _cuts(len(events), n_batches)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        state = S.stream_update(state, _slice(events, int(lo), int(hi)), manifest)
    return state


def _assert_tables_equal(a, b):
    for name in ("raw", "norm", "writes", "reads"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_batches", [1, 3, 7])
def test_fold_is_bit_equal_to_the_batch_features(workload, n_batches, dtype):
    manifest, events, _, _ = workload
    state = _fold(manifest, events, n_batches)
    assert state.n_events == len(events) and state.access_freq.dtype == torch.int32
    got = S.stream_finalize(state, manifest, dtype=dtype)
    want = compute_features_torch(manifest, events, device="cpu", dtype=dtype)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("n_batches", [1, 3, 7])
def test_counters_equal_the_reference_fold(workload, n_batches):
    manifest, events, ref_m, ref_e = workload
    state = _fold(manifest, events, n_batches)
    ref = jstream.stream_init(len(ref_m))
    cuts = _cuts(len(ref_e), n_batches)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        ref = jstream.stream_update(ref, _slice(ref_e, int(lo), int(hi), JEventLog), ref_m)
    for name in COUNTERS:
        want = np.asarray(getattr(ref, name))
        got = getattr(state, name).numpy()
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (state.sec_base, state.observation_end, state.n_events, state.pad_events) == \
        (ref.sec_base, ref.observation_end, ref.n_events, ref.pad_events)


@pytest.mark.parametrize("n_batches", [1, 4])
def test_finalized_table_matches_the_reference(workload, n_batches):
    manifest, events, ref_m, ref_e = workload
    state = _fold(manifest, events, n_batches)
    ref = jstream.stream_init(len(ref_m))
    cuts = _cuts(len(ref_e), n_batches)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        ref = jstream.stream_update(ref, _slice(ref_e, int(lo), int(hi), JEventLog), ref_m)
    want = jstream.stream_finalize(ref, ref_m)

    got64 = S.stream_finalize(state, manifest, dtype="float64")
    raw = got64.raw.numpy()
    for j in EXACT_RAW:
        np.testing.assert_array_equal(raw[:, j], want.raw[:, j])
    np.testing.assert_array_equal(got64.writes.numpy(), want.writes)
    np.testing.assert_allclose(raw, want.raw, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got64.norm.numpy(), want.norm, rtol=1e-12, atol=1e-15)

    got32 = S.stream_finalize(state, manifest)
    assert got32.norm.dtype == torch.float32
    np.testing.assert_allclose(got32.raw.double().numpy(), want.raw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got32.norm.double().numpy(), want.norm, rtol=1e-6, atol=1e-7)


def _one_file_log(ts):
    ts = np.asarray(ts, np.float64)
    return EventLog(ts=ts, path_id=np.zeros(len(ts), np.int32), op=np.zeros(len(ts), np.int8),
                    client_id=np.zeros(len(ts), np.int32), clients=["dn1"])


@pytest.mark.parametrize("cuts", [(2,), (1, 3, 5), (5,)])
def test_a_second_split_across_batches_counts_once(workload, cuts):
    """The reference's boundary-merge case: six events of file 0 in one
    second, cut by batch boundaries, count as one run of six."""
    manifest = workload[0]
    log = _one_file_log(1_700_000_000.0 + np.arange(1, 7) / 10)
    state = S.stream_init(len(manifest), "cpu")
    bounds = (0, *cuts, 6)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        state = S.stream_update(state, _slice(log, lo, hi), manifest)
    got = S.stream_finalize(state, manifest)
    assert got.raw[0, 4].item() == 6.0
    assert state.last_count[0].item() == 6 and state.last_sec[0].item() == 0


def test_carry_ends_when_the_next_batch_starts_a_new_second(workload):
    manifest = workload[0]
    t0 = 1_700_000_000.0
    state = S.stream_init(len(manifest), "cpu")
    state = S.stream_update(state, _one_file_log([t0 + 0.1, t0 + 0.2, t0 + 0.3]), manifest)
    state = S.stream_update(state, _one_file_log([t0 + 1.1, t0 + 1.2]), manifest)
    assert state.conc_max[0].item() == 3
    assert (state.last_sec[0].item(), state.last_count[0].item()) == (1, 2)


def test_both_wires_fold_to_the_same_state(workload):
    """A sorted batch packs to 5 B/event; a shuffled one (negative second
    deltas) or one with a > 255 s silence takes the 9 B/event columns.
    Within one batch order does not matter, so all fold alike."""
    manifest, events, _, _ = workload
    pb = S._prep_batch(events, manifest, sec_base=None, pad_target=0)
    assert pb.wire == "packed" and pb.sec.dtype == np.uint8 and pb.flags is None
    perm = np.random.default_rng(0).permutation(len(events))
    shuffled = EventLog(ts=events.ts[perm], path_id=events.path_id[perm],
                        op=events.op[perm], client_id=events.client_id[perm],
                        clients=events.clients)
    assert S._prep_batch(shuffled, manifest, sec_base=None, pad_target=0).wire == "cols"
    packed = S.stream_update(S.stream_init(len(manifest), "cpu"), events, manifest)
    cols = S.stream_update(S.stream_init(len(manifest), "cpu"), shuffled, manifest)
    for name in COUNTERS[:4]:
        assert torch.equal(getattr(packed, name), getattr(cols, name)), name

    gap = _one_file_log([1.7e9, 1.7e9 + 1.0, 1.7e9 + 1000.0])
    assert S._prep_batch(gap, manifest, sec_base=None, pad_target=0).wire == "cols"


def test_short_batches_pad_to_the_largest_and_padding_is_masked(workload):
    manifest, events, _, _ = workload
    state = S.stream_init(len(manifest), "cpu")
    e = len(events)
    for lo in range(0, e, 1000):
        state = S.stream_update(state, _slice(events, lo, min(lo + 1000, e)), manifest)
    assert state.pad_events == 1000 and e % 1000
    _assert_tables_equal(S.stream_finalize(state, manifest),
                         compute_features_torch(manifest, events, device="cpu"))


def test_fold_stream_matches_the_batch_features(tmp_path, workload):
    manifest, events, _, _ = workload
    log = str(tmp_path / "a.cdrsb")
    events.write_binary(log, manifest, block_rows=1500)
    stats = {}
    state = S.fold_stream(log, manifest, device="cpu", batch_size=997, stats=stats)
    _assert_tables_equal(S.stream_finalize(state, manifest),
                         compute_features_torch(manifest, events, device="cpu"))
    assert stats["batches"] == sum(-(-min(1500, len(events) - lo) // 997)
                                   for lo in range(0, len(events), 1500))
    assert stats["fold_seconds"] > 0 and stats["parse_seconds"] > 0


def test_fold_stream_csv_log_and_iterable_source(tmp_path, workload):
    manifest, events, _, _ = workload
    log = str(tmp_path / "a.log")
    events.write_csv(log, manifest)
    from_csv = S.fold_stream(log, manifest, device="cpu", batch_size=700)
    # On-disk timestamps are truncated to the millisecond.
    disk = EventLog.read_csv(log, manifest)
    _assert_tables_equal(S.stream_finalize(from_csv, manifest),
                         compute_features_torch(manifest, disk, device="cpu"))
    cuts = _cuts(len(events), 3)
    parts = [_slice(events, int(lo), int(hi)) for lo, hi in zip(cuts[:-1], cuts[1:])]
    from_iter = S.fold_stream(parts, manifest, device="cpu")
    _assert_tables_equal(S.stream_finalize(from_iter, manifest),
                         compute_features_torch(manifest, events, device="cpu"))


def test_producer_exceptions_surface_in_the_caller(workload):
    manifest, events, _, _ = workload

    def bad_batches():
        yield events
        raise RuntimeError("boom in the parser thread")

    with pytest.raises(RuntimeError, match="boom in the parser"):
        S.fold_stream(bad_batches(), manifest, device="cpu")


def test_fold_stream_without_cuda_raises_unless_given_the_cpu(workload):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    manifest, events, _, _ = workload
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.fold_stream([events], manifest)


def test_checkpoint_resume_is_bit_identical(tmp_path, workload, monkeypatch):
    manifest, events, _, _ = workload
    log = str(tmp_path / "a.cdrsb")
    events.write_binary(log, manifest, block_rows=500)
    ckpt = str(tmp_path / "fold.npz")
    golden = S.fold_stream(log, manifest, device="cpu", batch_size=500)

    real = S._fold_prepped
    calls = {"n": 0}

    def crash_after_four(state, pb):
        calls["n"] += 1
        if calls["n"] > 4:
            raise RuntimeError("simulated crash")
        return real(state, pb)

    monkeypatch.setattr(S, "_fold_prepped", crash_after_four)
    with pytest.raises(RuntimeError, match="simulated crash"):
        S.fold_stream(log, manifest, device="cpu", batch_size=500,
                      checkpoint_path=ckpt, checkpoint_every=2)
    monkeypatch.setattr(S, "_fold_prepped", real)
    assert os.path.exists(ckpt)

    other = generate_population(GeneratorConfig(n_files=50, seed=4))
    with pytest.raises(ValueError, match="stale"):
        S.fold_stream(log, other, device="cpu", batch_size=500, checkpoint_path=ckpt)

    stats = {}
    resumed = S.fold_stream(log, manifest, device="cpu", batch_size=500,
                            checkpoint_path=ckpt, checkpoint_every=2, stats=stats)
    assert stats["resumed_from_offset"] > 0 and not os.path.exists(ckpt)
    for name in COUNTERS:
        assert torch.equal(getattr(resumed, name), getattr(golden, name)), name
    assert (resumed.n_events, resumed.observation_end, resumed.sec_base) == \
        (golden.n_events, golden.observation_end, golden.sec_base)


def test_checkpoint_refuses_a_shrunken_log(tmp_path, workload):
    manifest, events, _, _ = workload
    log = str(tmp_path / "a.cdrsb")
    events.write_binary(log, manifest)
    state = S.stream_update(S.stream_init(len(manifest), "cpu"), events, manifest)
    ckpt = str(tmp_path / "fold.npz")
    S.save_stream_state(ckpt, state, log_offset=10, log_bytes=os.path.getsize(log) + 1)
    with pytest.raises(ValueError, match="swapped or truncated"):
        S.fold_stream(log, manifest, device="cpu", checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="log-path source"):
        S.fold_stream([events], manifest, device="cpu", checkpoint_path=ckpt)


def test_snapshots_load_in_either_package(tmp_path, workload):
    manifest, events, ref_m, ref_e = workload
    half = len(events) // 2
    port = S.stream_update(S.stream_init(len(manifest), "cpu"), _slice(events, 0, half),
                           manifest)
    ref = jstream.stream_update(jstream.stream_init(len(ref_m)),
                                _slice(ref_e, 0, half, JEventLog), ref_m)

    S.save_stream_state(str(tmp_path / "port.npz"), port, log_offset=123, log_bytes=456)
    loaded_ref, off, nbytes = jstream.load_stream_state(str(tmp_path / "port.npz"))
    assert (off, nbytes) == (123, 456)
    jstream.save_stream_state(str(tmp_path / "ref.npz"), ref, log_offset=7)
    loaded_port, off, nbytes = S.load_stream_state(str(tmp_path / "ref.npz"), "cpu")
    assert (off, nbytes) == (7, None)
    for name in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded_ref, name)),
                                      getattr(port, name).numpy(), err_msg=name)
        assert torch.equal(getattr(loaded_port, name), getattr(port, name)), name
    for got in (loaded_ref, loaded_port):
        assert (got.sec_base, got.observation_end, got.n_events, got.pad_events) == \
            (port.sec_base, port.observation_end, port.n_events, port.pad_events)
    # Both continue the fold alike from the other's snapshot.
    rest = S.stream_update(loaded_port, _slice(events, half, len(events)), manifest)
    _assert_tables_equal(S.stream_finalize(rest, manifest),
                         compute_features_torch(manifest, events, device="cpu"))


def test_save_state_is_atomic_keeps_prev_and_names_corrupt_files(tmp_path):
    path = str(tmp_path / "s.npz")
    out = save_state(path, {"a": np.arange(3)}, {"x": 1})
    assert out["bytes"] == os.path.getsize(path)
    save_state(path, {"a": np.arange(4)}, {"x": 2})
    arrays, meta = load_state(path)
    assert meta == {"x": 2} and arrays["a"].tolist() == [0, 1, 2, 3]
    assert load_state(path + ".prev")[1] == {"x": 1}
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    with open(path, "r+b") as f:
        f.truncate(20)
    with pytest.raises(CheckpointError, match="corrupt or truncated.*\\.prev"):
        load_state(path)
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "absent.npz"))
