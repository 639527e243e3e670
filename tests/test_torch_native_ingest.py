"""Native CSV ingestion and writing on the port (``io/events.py`` over
``runtime/native.py``) against the reference's, and a CSV ``fold_stream``
that resumes from a byte offset after a kill.

Held exactly (no tolerance): every batch's columns, client vocabulary and
``next_offset`` against the reference's ``read_csv_batches(native=True,
with_offsets=True)``; the handover to Python's parser on quoted, malformed
and blank-then-oversized rows (the reference's ``tests/test_native.py``
cases); the native writer's bytes against the Python writer's and the
reference's; the resumed fold's counters and finalized table against an
uninterrupted fold.  A failed build of the host library raises.
"""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

from cdrs_tpu.io.events import EventLog as JEventLog  # noqa: E402
from cdrs_tpu.io.events import Manifest as JManifest  # noqa: E402
from cdrs_tpu.runtime import native as ref_native  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog, Manifest  # noqa: E402
from cdrs_tpu_torch.ops import _build  # noqa: E402
from cdrs_tpu_torch.runtime import native  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

COLUMNS = ("ts", "path_id", "op", "client_id")


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference builds its library with ``make -C native`` at first
    use; another test worker may be running that make, so a failed load is
    retried while it finishes (the reference caches a failure)."""
    for _ in range(60):
        if ref_native.load() is not None:
            return
        ref_native._load_attempted = False
        time.sleep(1.0)
    pytest.fail("the reference's native library did not build (make -C native)")


def _assert_same(got, want):
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.clients == want.clients


def _ref_manifest(m):
    return JManifest(paths=list(m.paths), creation_ts=m.creation_ts,
                     primary_node_id=m.primary_node_id, size_bytes=m.size_bytes,
                     category=list(m.category), nodes=list(m.nodes))


def _workload(tmp_path, n_files=40, duration=120.0, seed=5):
    m = generate_population(GeneratorConfig(n_files=n_files, seed=seed))
    ev = simulate_access(m, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    log = str(tmp_path / "access.log")
    ev.write_csv(log, m)
    return m, ev, log


@pytest.mark.parametrize("batch_size", [None, 97, 1000])
def test_batches_and_offsets_equal_the_references(tmp_path, batch_size):
    m, _, log = _workload(tmp_path)
    rm = _ref_manifest(m)
    got = list(EventLog.read_csv_batches(log, m, batch_size=batch_size, with_offsets=True))
    want = list(JEventLog.read_csv_batches(log, rm, batch_size=batch_size, native=True,
                                           with_offsets=True))
    assert len(got) == len(want) > 0
    for (g, go), (w, wo) in zip(got, want):
        _assert_same(g, w)
        assert go == wo
    if batch_size is not None:
        # The native chunker read every row: every batch has an offset.
        assert all(off is not None for _, off in got)
        assert got[-1][1] == len(open(log, "rb").read())
    py = EventLog.read_csv(log, m, native=False)
    _assert_same(EventLog.read_csv(log, m), py)


def test_resume_from_a_middle_offset(tmp_path):
    m, _, log = _workload(tmp_path, n_files=30, duration=90.0)
    batches = list(EventLog.read_csv_batches(log, m, batch_size=50, with_offsets=True))
    whole = EventLog.concat([b for b, _ in batches])
    mid = len(batches) // 2
    off = batches[mid - 1][1]
    rest = list(EventLog.read_csv_batches(log, m, batch_size=50, start_offset=off,
                                          with_offsets=True))
    want = list(JEventLog.read_csv_batches(log, _ref_manifest(m), batch_size=50,
                                           start_offset=off, with_offsets=True))
    assert [o for _, o in rest] == [o for _, o in want] == [o for _, o in batches[mid:]]
    tail = EventLog.concat([b for b, _ in rest])
    rows = sum(len(b) for b, _ in batches[:mid])
    for name in COLUMNS[:3]:
        assert np.array_equal(getattr(tail, name), getattr(whole, name)[rows:])
    # Client ids are those of the vocabulary grown from the offset on.
    assert [tail.clients[i] for i in tail.client_id] == \
        [whole.clients[i] for i in whole.client_id[rows:]]


def _quoted_mid_stream(tmp_path):
    m, _, log = _workload(tmp_path, n_files=8, duration=30.0)
    lines = open(log).read().splitlines()
    mid = len(lines) // 2
    parts = lines[mid].split(",")
    parts[3] = f'"{parts[3]}"'
    lines[mid] = ",".join(parts)
    open(log, "w").write("\n".join(lines) + "\n")
    return m, log


def _foreign_stamp_tail(tmp_path):
    """An offset without a colon, which Python reads and the native grammar
    does not, after a row with an unknown path and client."""
    m, _, log = _workload(tmp_path, n_files=8, duration=30.0)
    with open(log, "a") as f:
        f.write("2026-01-01T00:00:00.000+05:30,/not/in/manifest,READ,dn7,77\n")
        f.write(f"2026-01-01T00:00:01.250+0530,{m.paths[1]},WRITE,dn1,78\n")
    return m, log


def _oversized_after_blanks(tmp_path):
    big = "/synth/" + "x" * 1500 + ".bin"   # past a 4-row chunk's blob budget
    m = Manifest(paths=[big, "/synth/a.bin"], creation_ts=np.zeros(2),
                 primary_node_id=np.zeros(2, dtype=np.int32),
                 size_bytes=np.ones(2, dtype=np.int64), category=["hot", "hot"], nodes=["dn1"])
    log = str(tmp_path / "access.log")
    with open(log, "w") as f:
        f.write("\n\n")
        f.write(f"2026-01-01T00:00:00.000Z,{big},READ,dn1,1000\n")
        f.write("2026-01-01T00:00:01.000Z,/synth/a.bin,WRITE,dn2,1001\n")
    return m, log


def _quoted_path(tmp_path):
    m = Manifest(paths=["/a,b.bin"], creation_ts=np.array([0.0]),
                 primary_node_id=np.array([0], dtype=np.int32),
                 size_bytes=np.array([1], dtype=np.int64), category=["hot"], nodes=["dn1"])
    log = str(tmp_path / "access.log")
    open(log, "w").write('2026-01-01T00:00:00.000Z,"/a,b.bin",READ,dn1,1000\n')
    return m, log


@pytest.mark.parametrize("case", [_quoted_mid_stream, _foreign_stamp_tail,
                                  _oversized_after_blanks, _quoted_path])
@pytest.mark.parametrize("batch_size", [4, None])
def test_handover_equals_the_references(tmp_path, case, batch_size):
    m, log = case(tmp_path)
    got = list(EventLog.read_csv_batches(log, m, batch_size=batch_size, with_offsets=True))
    want = list(JEventLog.read_csv_batches(log, _ref_manifest(m), batch_size=batch_size,
                                           with_offsets=True))
    assert len(got) == len(want) > 0
    for (g, go), (w, wo) in zip(got, want):
        _assert_same(g, w)
        assert go == wo
    # Python's parser took over: its batches report no offset.
    assert got[-1][1] is None
    _assert_same(EventLog.read_csv(log, m), EventLog.read_csv(log, m, native=False))


def test_rows_the_native_grammar_refuses(tmp_path):
    _, log = _quoted_path(tmp_path)
    assert native.parse_log_chunk_native(log, 0, 100) is None
    _, log = _foreign_stamp_tail(tmp_path)
    assert native.parse_log_chunk_native(log, 0, 10**5) is None
    # A row of three fields: the native parser hands it over, and Python's
    # parser fails on it as the reference's does.
    m, _, log = _workload(tmp_path, n_files=6, duration=20.0)
    with open(log, "a") as f:
        f.write("2026-01-01T00:00:00.000Z,/f,READ\n")
    assert native.parse_log_chunk_native(log, 0, 10**5) is None
    with pytest.raises(IndexError):
        EventLog.read_csv(log, m)
    with pytest.raises(IndexError):
        JEventLog.read_csv(log, _ref_manifest(m))


def test_writer_bytes_equal_the_python_writers_and_the_references(tmp_path):
    m, ev, log = _workload(tmp_path, n_files=20, duration=60.0)
    extra = np.array([1.7e9 + 0.0005, 1.7e9 + 0.9995, 1.7e9 + 0.123999, 1.7e9 + 0.5,
                      -3.25])
    ev = EventLog(ts=np.concatenate([ev.ts, extra]),
                  path_id=np.concatenate([ev.path_id, np.array([0, -1, 0, 0, 1], np.int32)]),
                  op=np.concatenate([ev.op, np.array([0, 0, 1, 0, 1], np.int8)]),
                  client_id=np.concatenate([ev.client_id, np.zeros(5, np.int32)]),
                  clients=ev.clients)
    p_nat, p_py, p_ref = (str(tmp_path / f) for f in ("nat.log", "py.log", "ref.log"))
    ev.write_csv(p_nat, m)
    ev._write_csv_python(p_py, m)
    JEventLog(ts=ev.ts, path_id=ev.path_id, op=ev.op, client_id=ev.client_id,
              clients=ev.clients).write_csv(p_ref, _ref_manifest(m))
    nat = open(p_nat, "rb").read()
    assert nat == open(p_py, "rb").read() == open(p_ref, "rb").read()
    assert nat.count(b"\n") == len(ev) - 1   # the invalid row is skipped


def test_writer_quotes_through_python(tmp_path):
    m, _ = _quoted_path(tmp_path)
    ev = EventLog(ts=np.array([1.7e9]), path_id=np.array([0], dtype=np.int32),
                  op=np.array([0], dtype=np.int8), client_id=np.array([0], dtype=np.int32),
                  clients=["dn1"])
    p = str(tmp_path / "quoted.log")
    ev.write_csv(p, m)
    assert '"/a,b.bin"' in open(p).read()
    got = EventLog.read_csv(p, m)
    assert len(got) == 1 and got.path_id[0] == 0


class _Killed(RuntimeError):
    pass


@pytest.mark.parametrize("mesh_shape", [None, {"data": 2}])
def test_csv_fold_stream_resumes_bit_identically(tmp_path, monkeypatch, mesh_shape):
    import torch

    import cdrs_tpu_torch.features.streaming as streaming

    m, _, log = _workload(tmp_path, n_files=60, duration=200.0, seed=9)
    full = streaming.fold_stream(log, m, device="cpu", batch_size=300, mesh_shape=mesh_shape)
    ck = str(tmp_path / "fold.npz")
    save, saved = streaming.save_stream_state, []

    def dying(path, state, log_offset=None, log_bytes=None):
        save(path, state, log_offset=log_offset, log_bytes=log_bytes)
        saved.append(log_offset)
        if len(saved) == 2:
            raise _Killed()

    monkeypatch.setattr(streaming, "save_stream_state", dying)
    with pytest.raises(_Killed):
        streaming.fold_stream(log, m, device="cpu", batch_size=300, checkpoint_path=ck,
                              checkpoint_every=2, mesh_shape=mesh_shape)
    monkeypatch.setattr(streaming, "save_stream_state", save)
    stats = {}
    resumed = streaming.fold_stream(log, m, device="cpu", batch_size=300, checkpoint_path=ck,
                                    checkpoint_every=2, stats=stats, mesh_shape=mesh_shape)
    assert 0 < stats["resumed_from_offset"] == saved[-1] < len(open(log, "rb").read())
    for name in ("access_freq", "writes", "local_acc", "conc_max"):
        assert torch.equal(getattr(resumed, name), getattr(full, name)), name
    a = streaming.stream_finalize(resumed, m)
    b = streaming.stream_finalize(full, m)
    assert torch.equal(a.raw, b.raw) and torch.equal(a.norm, b.norm)
    # native=False reads through Python's csv: no offsets, so no snapshot.
    ck2 = str(tmp_path / "py.npz")
    monkeypatch.setattr(streaming, "save_stream_state", dying)
    saved.clear()
    py = streaming.fold_stream(log, m, device="cpu", batch_size=300, checkpoint_path=ck2,
                               checkpoint_every=1, native=False, mesh_shape=mesh_shape)
    assert saved == []
    assert torch.equal(streaming.stream_finalize(py, m).raw, b.raw)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent Python path: a compiler that fails, or none, raises."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'cdrs_native.cpp: error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "cxx_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_fns", {})
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.load()
    m, _ = _quoted_path(tmp_path)
    log = str(tmp_path / "plain.log")
    open(log, "w").write("2026-01-01T00:00:00.000Z,/x.bin,READ,dn1,1000\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        EventLog.read_csv(log, m)
    assert len(EventLog.read_csv(log, m, native=False)) == 1
    monkeypatch.setattr(_build, "cxx_path", lambda: str(tmp_path / "absent-g++"))
    with pytest.raises(RuntimeError, match="failed to start"):
        native.load()
    assert not list((tmp_path / "build").glob("*.so"))
