"""The port's log readers and writers (``io/events.py``) against
``cdrs_tpu.io.events``.

A ``.cdrsb`` written by either package reads back identically in the
other (timestamps exact: the format keeps float64), offsets reported at
block ends resume mid-file, appends check the vocabulary, and damaged
files fail with one error naming them.  The manifest and the CSV log read
alike in both packages (the reference through its Python parser).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cdrs_tpu.io.events import EventLog as JEventLog  # noqa: E402
from cdrs_tpu.io.events import Manifest as JManifest  # noqa: E402

from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog, Manifest, is_binary_log  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402


@pytest.fixture(scope="module")
def workload():
    manifest = generate_population(GeneratorConfig(n_files=120, seed=11))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=120.0, seed=12))
    return manifest, events


def _ref_manifest(m):
    return JManifest(paths=m.paths, creation_ts=m.creation_ts,
                     primary_node_id=m.primary_node_id, size_bytes=m.size_bytes,
                     category=m.category, nodes=m.nodes)


def _as(cls, ev, lo=0, hi=None):
    hi = len(ev) if hi is None else hi
    return cls(ts=ev.ts[lo:hi], path_id=ev.path_id[lo:hi], op=ev.op[lo:hi],
               client_id=ev.client_id[lo:hi], clients=list(ev.clients))


def _assert_logs_equal(a, b):
    for name in ("ts", "path_id", "op", "client_id"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert list(a.clients) == list(b.clients)


@pytest.mark.parametrize("block_rows", [None, 7])
def test_cdrsb_reads_back_equal_in_the_other_package(tmp_path, workload, block_rows):
    manifest, events = workload
    ref_m = _ref_manifest(manifest)
    port_p, ref_p = str(tmp_path / "port.cdrsb"), str(tmp_path / "ref.cdrsb")
    assert events.write_binary(port_p, manifest, block_rows=block_rows) == len(events)
    _as(JEventLog, events).write_binary(ref_p, ref_m, block_rows=block_rows)
    assert open(port_p, "rb").read() == open(ref_p, "rb").read()
    assert is_binary_log(port_p)
    _assert_logs_equal(JEventLog.read_csv(port_p, ref_m), events)
    _assert_logs_equal(EventLog.read_csv(ref_p, manifest), events)


def test_batches_and_offsets_match_the_reference(tmp_path, workload):
    manifest, events = workload
    p = str(tmp_path / "b.cdrsb")
    n = len(events)
    _as(EventLog, events, 0, n // 3).write_binary(p, manifest)
    _as(EventLog, events, n // 3).write_binary(p, manifest, append=True)
    got = list(EventLog.read_csv_batches(p, manifest, batch_size=100, with_offsets=True))
    want = list(JEventLog.read_csv_batches(p, _ref_manifest(manifest), batch_size=100,
                                           with_offsets=True))
    assert [off for _, off in got] == [off for _, off in want]
    assert sum(len(b) for b, _ in got) == n and all(len(b) <= 100 for b, _ in got)
    for (a, _), (b, _) in zip(got, want):
        _assert_logs_equal(a, b)


def test_offsets_resume_mid_file(tmp_path, workload):
    manifest, events = workload
    p = str(tmp_path / "r.cdrsb")
    events.write_binary(p, manifest, block_rows=50)
    got = list(EventLog.read_csv_batches(p, manifest, batch_size=30, with_offsets=True))
    rows = 0
    resumed_any = 0
    for b, off in got:
        rows += len(b)
        if off is None or rows == len(events):
            continue
        rest = list(EventLog.read_csv_batches(p, manifest, batch_size=None,
                                              start_offset=off))
        assert len(rest) == 1
        _assert_logs_equal(rest[0], _as(EventLog, events, rows))
        resumed_any += 1
    assert resumed_any >= 3
    with pytest.raises(ValueError, match="start_offset"):
        list(EventLog.read_csv_batches(p, manifest, start_offset=3))


def test_append_with_another_vocabulary_raises(tmp_path, workload):
    manifest, events = workload
    p = str(tmp_path / "a.cdrsb")
    events.write_binary(p, manifest)
    other = _as(EventLog, events)
    other.clients = list(events.clients) + ["intruder"]
    with pytest.raises(ValueError, match="vocabulary"):
        other.write_binary(p, manifest, append=True)
    # Nor may the reference append a foreign vocabulary to a port-written file.
    ref_other = _as(JEventLog, other)
    with pytest.raises(ValueError, match="vocabulary"):
        ref_other.write_binary(p, _ref_manifest(manifest), append=True)
    with open(str(tmp_path / "plain.txt"), "wb") as f:
        f.write(b"not a log at all")
    with pytest.raises(ValueError, match="not a binary event log"):
        events.write_binary(str(tmp_path / "plain.txt"), manifest, append=True)
    with pytest.raises(ValueError, match="block_rows"):
        events.write_binary(str(tmp_path / "x.cdrsb"), manifest, block_rows=0)


def test_empty_logs_and_empty_blocks(tmp_path, workload):
    manifest, events = workload
    empty = EventLog(ts=np.zeros(0), path_id=np.zeros(0, np.int32), op=np.zeros(0, np.int8),
                     client_id=np.zeros(0, np.int32), clients=list(events.clients))
    p = str(tmp_path / "e.cdrsb")
    empty.write_binary(p, manifest)
    assert len(EventLog.read_csv(p, manifest)) == 0
    p2 = str(tmp_path / "e2.cdrsb")
    events.write_binary(p2, manifest)
    empty.write_binary(p2, manifest, append=True)   # an empty block: skipped on read
    _assert_logs_equal(EventLog.read_csv(p2, manifest), events)


def test_truncated_and_damaged_files_fail_clearly(tmp_path, workload):
    manifest, events = workload
    p = str(tmp_path / "t.cdrsb")
    events.write_binary(p, manifest)
    data = open(p, "rb").read()
    for cut, msg in ((len(data) - 3, "truncated/corrupt block"),
                     (len(data) - len(events) * 17 - 3, "truncated/corrupt block"),
                     (20, "truncated/corrupt header"),
                     (60, "truncated/corrupt header")):
        with open(p, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(ValueError, match=msg) as info:
            EventLog.read_csv(p, manifest)
        assert repr(p) in str(info.value)
    # Ids outside the embedded tables raise before any remap.
    with open(p, "wb") as f:
        f.write(data)
    _, _, first = EventLog._read_binary_header(p)
    pid_col = first + 8 + 8 * len(events)
    with open(p, "r+b") as f:
        f.seek(pid_col)
        f.write(np.int32(-3).tobytes())
    with pytest.raises(ValueError, match="path id"):
        EventLog.read_csv(p, manifest)
    with pytest.raises(FileNotFoundError, match="missing event log"):
        EventLog.read_csv(str(tmp_path / "absent.cdrsb"), manifest)


def test_a_foreign_manifest_left_joins(tmp_path, workload):
    """Paths missing from the reader's manifest become -1 and unknown
    clients extend its vocabulary, as in the reference."""
    manifest, events = workload
    p = str(tmp_path / "f.cdrsb")
    events.write_binary(p, manifest)
    keep = list(range(0, len(manifest), 2))
    sub = Manifest(paths=[manifest.paths[i] for i in keep],
                   creation_ts=manifest.creation_ts[keep],
                   primary_node_id=manifest.primary_node_id[keep],
                   size_bytes=manifest.size_bytes[keep],
                   category=[manifest.category[i] for i in keep], nodes=["dn2", "dn1"])
    got = EventLog.read_csv(p, sub)
    want = JEventLog.read_csv(p, _ref_manifest(sub))
    _assert_logs_equal(got, want)
    assert (got.path_id == -1).any() and got.clients[:2] == ["dn2", "dn1"]


def test_manifest_and_csv_log_read_like_the_reference(tmp_path, workload):
    manifest, events = workload
    mpath, lpath = str(tmp_path / "m.csv"), str(tmp_path / "a.log")
    manifest.write_csv(mpath)
    events.write_csv(lpath, manifest)
    port_m, ref_m = Manifest.read_csv(mpath), JManifest.read_csv(mpath)
    assert port_m.paths == ref_m.paths and port_m.nodes == ref_m.nodes
    assert port_m.category == ref_m.category
    for name in ("creation_ts", "primary_node_id", "size_bytes"):
        np.testing.assert_array_equal(getattr(port_m, name), getattr(ref_m, name))
    np.testing.assert_array_equal(port_m.creation_ts, manifest.creation_ts)

    # The native parser reports the reference's offset on every batch; the
    # Python parser (native=False) none, on both sides.
    for native in (True, False):
        got = list(EventLog.read_csv_batches(lpath, port_m, batch_size=250, native=native,
                                             with_offsets=True))
        want = list(JEventLog.read_csv_batches(lpath, ref_m, batch_size=250,
                                               native=native, with_offsets=True))
        assert len(got) == len(want)
        assert [off for _, off in got] == [off for _, off in want]
        assert all((off is None) == (native is False) for _, off in got)
        for (a, _), (b, _) in zip(got, want):
            _assert_logs_equal(a, b)
    _assert_logs_equal(EventLog.read_csv(lpath, port_m),
                       JEventLog.read_csv(lpath, ref_m, native=False))
    # A start offset at a line boundary resumes the CSV scan there.
    whole = EventLog.read_csv(lpath, port_m)
    second_line = open(lpath, "rb").read().index(b"\n") + 1
    rest = next(EventLog.read_csv_batches(lpath, port_m, batch_size=None,
                                          start_offset=second_line))
    for name in ("ts", "path_id", "op"):
        np.testing.assert_array_equal(getattr(rest, name), getattr(whole, name)[1:])


@pytest.mark.parametrize("text,msg", [
    ("", "no header row"),
    ("path,size_bytes\n/a,1\n", "missing columns"),
    ("path,creation_ts,primary_node\n/a,not-a-time,dn1\n", "row 2 unreadable"),
])
def test_manifest_errors_name_the_file(tmp_path, text, msg):
    p = tmp_path / "m.csv"
    p.write_text(text)
    with pytest.raises(ValueError, match=msg):
        Manifest.read_csv(str(p))
    with pytest.raises(FileNotFoundError, match="missing manifest"):
        Manifest.read_csv(str(tmp_path / "absent.csv"))


def test_concat_joins_batches(workload):
    _, events = workload
    parts = [_as(EventLog, events, 0, 10), _as(EventLog, events, 10)]
    _assert_logs_equal(EventLog.concat(parts), events)
    assert EventLog.concat(parts[:1]) is parts[0]
    with pytest.raises(ValueError, match="at least one"):
        EventLog.concat([])
