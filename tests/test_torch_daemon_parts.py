"""The daemon's host modules in the port against ``cdrs_tpu`` on the CPU,
exact: the JSONL sink's rotation and readers, the alert engine, the
decision-trace helpers, the hash placement and its epochs, the read view,
the ``.cdrsb`` tailer, the epoch publisher, the brownout ladder and the
crash supervisor.  Each takes the same inputs in both packages."""

import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdrs_tpu.cluster.placement import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.config import GeneratorConfig as RefGenConfig  # noqa: E402
from cdrs_tpu.config import SimulatorConfig as RefSimConfig  # noqa: E402
from cdrs_tpu.daemon import brownout as ref_brownout  # noqa: E402
from cdrs_tpu.daemon import tailer as ref_tailer  # noqa: E402
from cdrs_tpu.obs import alerts as ref_alerts  # noqa: E402
from cdrs_tpu.obs import sink as ref_sink  # noqa: E402
from cdrs_tpu.obs import trace as ref_trace  # noqa: E402
from cdrs_tpu.placement_fn import compute as ref_compute  # noqa: E402
from cdrs_tpu.placement_fn.epoch import EpochMap as RefEpochMap  # noqa: E402
from cdrs_tpu.serve.view import read_view as ref_read_view  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.cluster.placement import ClusterTopology  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.daemon import (RUNGS, BrownoutConfig, BrownoutLadder,  # noqa: E402
                                   EpochPublisher, PlacementEpoch, supervise,
                                   tail_binary_log)
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.obs import alerts, sink, trace  # noqa: E402
from cdrs_tpu_torch.placement_fn import compute  # noqa: E402
from cdrs_tpu_torch.placement_fn.epoch import EpochMap  # noqa: E402
from cdrs_tpu_torch.serve import read_view  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402


@pytest.fixture(scope="module")
def workload():
    manifest = generate_population(GeneratorConfig(n_files=150, seed=31))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=600.0, seed=32))
    ref_manifest = ref_generate(RefGenConfig(n_files=150, seed=31))
    ref_events = ref_simulate(ref_manifest, RefSimConfig(duration_seconds=600.0, seed=32))
    return manifest, events, ref_manifest, ref_events


def _slice_log(events, lo, hi):
    return EventLog(ts=events.ts[lo:hi], path_id=events.path_id[lo:hi], op=events.op[lo:hi],
                    client_id=events.client_id[lo:hi], clients=events.clients)


# -- obs/sink ----------------------------------------------------------------

def _events_stream(n=60):
    rng = np.random.default_rng(3)
    return [{"kind": "window", "window": i, "plan_hash": f"{i:016x}",
             "n_events": int(rng.integers(0, 10_000)), "name": "é" * int(rng.integers(0, 4)),
             "arr": np.arange(int(rng.integers(1, 5))), "v": np.float32(i / 7)}
            for i in range(n)]


@pytest.mark.parametrize("max_bytes", [None, 1, 700, 4096])
def test_sink_rotation_files_and_readers_match_the_reference(tmp_path, max_bytes):
    files = {}
    for name, mod in (("port", sink), ("ref", ref_sink)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "m.jsonl")
        with mod.JsonlSink(path, max_bytes=max_bytes) as s:
            for ev in _events_stream():
                s.emit(ev)
        rotated = mod.rotated_paths(path)
        files[name] = ([p.split("/")[-1] for p in rotated],
                       [open(p, "rb").read() for p in rotated + [path]],
                       mod.read_events(path), list(mod.iter_events(path)))
    assert files["port"] == files["ref"]
    names, blobs, read, iterated = files["port"]
    assert read == iterated and [e["window"] for e in read] == list(range(60))
    if max_bytes == 700:
        assert len(names) >= 2 and all(len(b) <= 700 for b in blobs)


def test_sink_rejects_a_bad_cap_and_readers_skip_a_torn_line(tmp_path):
    with pytest.raises(ValueError, match="max_bytes must be > 0"):
        sink.JsonlSink(str(tmp_path / "x.jsonl"), max_bytes=0)
    path = tmp_path / "t.jsonl"
    path.write_text('{"a": 1}\n{"a": 2}\n{"a": 3, "b"')
    assert sink.read_events(str(path)) == ref_sink.read_events(str(path)) == [{"a": 1},
                                                                             {"a": 2}]


def test_iter_events_follow_drains_a_rotation(tmp_path):
    path = str(tmp_path / "f.jsonl")
    s = sink.JsonlSink(path, max_bytes=200)
    got, done = [], threading.Event()

    def writer():
        for i in range(40):
            s.emit({"i": i, "pad": "x" * 30})
            time.sleep(0.005)
        time.sleep(0.2)
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    for ev in sink.iter_events(path, follow=True, poll=0.01, stop=done.is_set):
        got.append(ev["i"])
    t.join(timeout=10)
    s.close()
    assert not t.is_alive()
    assert got == sorted(set(got)) and got[-1] == 39 and len(sink.rotated_paths(path)) > 2


# -- obs/alerts --------------------------------------------------------------

def _record_stream():
    rng = np.random.default_rng(11)
    recs = []
    for w in range(40):
        r = {"window": w, "deferred_budget": int(rng.integers(0, 3)),
             "seconds": {"plan": float(rng.choice([0.1, 2.5])),
                         "total": float(rng.choice([1.0, 12.0]))}}
        if w % 3:
            r["daemon"] = {"lag_windows": float(rng.choice([0.0, 2.5]))}
        if w % 4 == 0:
            r["slo_burn"] = float(rng.choice([0.5, 3.0]))
        if w in (7, 8):
            r["durability"] = {"lost": 1, "at_risk": 2}
        recs.append(r)
    return recs


@pytest.mark.parametrize("rules", ["default", "json"])
def test_alert_engine_transitions_match_the_reference(rules):
    if rules == "default":
        eng, ref = alerts.AlertEngine(), ref_alerts.AlertEngine()
    else:
        text = json.dumps([r.to_dict() for r in ref_alerts.default_rules()])
        eng = alerts.AlertEngine(alerts.rules_from_json(text))
        ref = ref_alerts.AlertEngine(ref_alerts.rules_from_json(text))
        assert [r.to_dict() for r in eng.rules] == [r.to_dict() for r in ref.rules]
    got, want = [], []
    for r in _record_stream():
        got += eng.observe({"kind": "window", **r})
        want += ref.observe({"kind": "window", **r})
        assert eng.observe({"kind": "alert"}) == []
    assert got == want and got
    assert eng.results() == ref.results()
    assert alerts.SEVERE_ALERTS == ref_alerts.SEVERE_ALERTS
    fired = {t["alert"] for t in got if t["state"] == "firing"}
    assert {"files_lost", "daemon_lagging", "decision_latency"} <= fired


@pytest.mark.parametrize("bad,match", [
    ({"name": "x", "kind": "nope"}, "unknown kind"),
    ({"name": "x"}, "need a field"),
    ({"name": "x", "field": "a", "op": "~"}, "unknown op"),
    ({"name": "x", "field": "a", "for_windows": 0}, "for_windows"),
    ({"name": "x", "kind": "burn_rate", "short_windows": 3, "long_windows": 2}, "short_windows"),
    ({"name": "x", "field": "a", "severity": "sms"}, "severity"),
    ({"name": "x", "field": "a", "colour": 1}, "unknown keys"),
])
def test_alert_rule_validation_matches_the_reference(bad, match):
    for mod in (alerts, ref_alerts):
        with pytest.raises(ValueError, match=match):
            mod.rules_from_json([bad])


# -- obs/trace ---------------------------------------------------------------

@pytest.mark.parametrize("with_rec", [False, True])
def test_span_tree_and_trace_ids_match_the_reference(with_rec):
    decision = {"total_ns": 10_000, "segments_ns": {"tail": 100, "decide": 9_000,
                                                    "observe": 300, "publish": 600}}
    rec = {"seconds": {"fold": 0.2, "drift": 0.1, "recluster": 0.5, "plan": 0.3,
                       "evaluate": 0.4, "total": 1.5}} if with_rec else None
    assert trace.build_span_tree(decision, rec) == ref_trace.build_span_tree(decision, rec)
    assert trace.build_span_tree({"spans": [{"x": 1}]}) == [{"x": 1}]
    assert [trace.decision_trace_id(w) for w in (0, 7, 123456)] == \
        [ref_trace.decision_trace_id(w) for w in (0, 7, 123456)]
    assert trace.SEGMENT_ORDER == ref_trace.SEGMENT_ORDER
    assert trace.STAGE_ORDER == ref_trace.STAGE_ORDER
    ctx, ref_ctx = trace.mint_batch(4096, 3, 77), ref_trace.mint_batch(4096, 3, 77)
    assert (ctx.offset, ctx.skip, ctx.ingest_ns) == (ref_ctx.offset, ref_ctx.skip,
                                                     ref_ctx.ingest_ns)


# -- placement_fn ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_nodes", [3, 12])
def test_hash_placement_and_epochs_bit_equal(seed, n_nodes):
    rng = np.random.default_rng(100 + seed)
    nodes = [f"dn{i + 1}" for i in range(n_nodes)]
    m = 5000
    fids = rng.integers(0, 2**31, size=m)
    rf = rng.integers(1, 6, size=m).astype(np.int32)
    vocab = nodes + ["edge"]   # a primary outside the topology spreads by crc32
    prim_ids = rng.integers(0, len(vocab), size=m).astype(np.int32)
    topo, ref_topo = ClusterTopology(nodes=tuple(nodes)), RefTopology(nodes=tuple(nodes))
    np.testing.assert_array_equal(compute.node_salts(nodes, seed),
                                  ref_compute.node_salts(nodes, seed))
    np.testing.assert_array_equal(compute.file_keys(fids, seed),
                                  ref_compute.file_keys(fids, seed))
    prim = rng.integers(0, n_nodes, size=m).astype(np.int32)
    for kw in ({}, {"chunk": 777, "out_width": 7}):
        got = compute.compute_placement(fids, rf, prim, topo, seed, **kw)
        want = ref_compute.compute_placement(fids, rf, prim, ref_topo, seed, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    emap, ref_emap = EpochMap(vocab, topo, seed), RefEpochMap(vocab, ref_topo, seed)
    assert emap.advance(topo).epoch_id == ref_emap.advance(ref_topo).epoch_id == 1
    assert emap.current.epoch_id == 1 and emap.topology(0) is topo
    got, grf = emap.placement(1, fids, rf, prim_ids)
    want, wrf = ref_emap.placement(1, fids, rf, prim_ids)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(grf, wrf)
    # Each row: rf distinct nodes, replica 0 the primary, -1 past rf.
    for row, r in zip(got[:200], grf[:200]):
        assert len(set(row[:r].tolist())) == r and (row[r:] == -1).all()


def test_placement_refuses_a_domain_topology_and_too_many_nodes():
    # A rack topology is ported: the multi-domain fill is the reference's.
    nodes, domains = ("a", "b", "c", "d"), ("r0", "r0", "r1", "r1")
    fids, rf = np.arange(64), np.full(64, 3)
    prim = np.random.default_rng(0).integers(0, 4, 64).astype(np.int32)
    got = compute.compute_placement(fids, rf, prim, ClusterTopology(nodes=nodes, domains=domains))
    want = ref_compute.compute_placement(fids, rf, prim, RefTopology(nodes=nodes, domains=domains))
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0][:, :2] >= 0).all()
    with pytest.raises(ValueError, match="up to 63 nodes"):
        compute.node_salts([f"n{i}" for i in range(64)])
    empty = compute.compute_placement(np.zeros(0, np.int64), np.zeros(0, np.int32),
                                      np.zeros(0, np.int32), ClusterTopology())
    assert empty[0].shape == (0, 1)


# -- serve/view --------------------------------------------------------------

def test_read_view_matches_the_reference():
    topo = ClusterTopology(nodes=("dn1", "dn2", "dn3", "dn4"))
    emap = EpochMap(topo.nodes, topo)
    rf = np.random.default_rng(0).integers(1, 4, size=300).astype(np.int32)
    prim = np.random.default_rng(1).integers(0, 4, size=300).astype(np.int32)

    def resolver(u):
        return emap.placement(0, u, rf[u], prim[u])[0]

    pid = np.random.default_rng(2).integers(0, 300, size=2000).astype(np.int32)
    got = read_view(pid, resolver=resolver, n_nodes=4)
    want = ref_read_view(pid, resolver=resolver, n_nodes=4)
    for f in ("replica_map", "slot_ok", "node_throughput", "pid", "file_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.slot_corrupt is None
    np.testing.assert_array_equal(got.replica_map[got.pid], resolver(pid))


# -- daemon/tailer -----------------------------------------------------------

def _blocks(batches):
    return [(b.offset, b.next_offset, b.events.ts.tolist(), b.events.path_id.tolist(),
             b.events.op.tolist(), b.events.client_id.tolist(), list(b.events.clients))
            for b in batches]


@pytest.mark.parametrize("block_rows", [999, 4096])
def test_tailer_blocks_offsets_and_resume_match_the_reference(tmp_path, workload, block_rows):
    manifest, events, ref_manifest, _ = workload
    p = str(tmp_path / "t.cdrsb")
    events.write_binary(p, manifest, block_rows=block_rows)
    box = {}
    got = list(tail_binary_log(p, manifest, ingest_box=box))
    want = list(ref_tailer.tail_binary_log(p, ref_manifest))
    assert _blocks(got) == _blocks(want) and box["ns"] > 0
    back = EventLog.concat([b.events for b in got])
    np.testing.assert_array_equal(back.ts, events.ts)
    mid = got[len(got) // 2].offset
    assert _blocks(tail_binary_log(p, manifest, start_offset=mid)) == \
        _blocks(ref_tailer.tail_binary_log(p, ref_manifest, start_offset=mid))


def _error(fn):
    try:
        list(fn())
    except (ValueError, FileNotFoundError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["missing", "torn_block", "torn_header", "magic_prefix",
                                  "bad_magic", "bad_offset"])
def test_tailer_errors_match_the_reference(tmp_path, workload, case):
    manifest, events, ref_manifest, _ = workload
    p = str(tmp_path / "e.cdrsb")
    events.write_binary(p, manifest, block_rows=997)
    blob = open(p, "rb").read()
    kw = {}
    if case == "missing":
        p = str(tmp_path / "nope.cdrsb")
    elif case == "torn_block":
        open(p, "wb").write(blob[:-37])
    elif case == "torn_header":
        open(p, "wb").write(blob[:40])
    elif case == "magic_prefix":
        open(p, "wb").write(blob[:5])
    elif case == "bad_magic":
        open(p, "wb").write(b"NOTALOG!" + blob[8:])
    else:
        kw = {"start_offset": 10}
    got = _error(lambda: tail_binary_log(p, manifest, **kw))
    assert got is not None and got == _error(
        lambda: ref_tailer.tail_binary_log(p, ref_manifest, **kw))


def test_tailer_follow_waits_out_a_missing_file_torn_tails_and_a_rotation(tmp_path, workload):
    manifest, events, _, _ = workload
    p = str(tmp_path / "live.cdrsb")
    n = len(events)
    cuts = [0, n // 4, n // 2, 3 * n // 4, n]
    seen, done = [], threading.Event()

    def writer():
        time.sleep(0.1)   # the tailer starts before the file exists
        _slice_log(events, cuts[0], cuts[1]).write_binary(p + ".tmp", manifest)
        blob = open(p + ".tmp", "rb").read()
        with open(p, "wb") as f:   # a torn header, then the rest
            f.write(blob[:30])
            f.flush()
            time.sleep(0.1)
            f.write(blob[30:])
        for i in (1, 2):
            time.sleep(0.1)
            _slice_log(events, cuts[i], cuts[i + 1]).write_binary(p, manifest, append=True)
        time.sleep(0.2)
        # Rotation: the live file moves to .1 with one more block, a fresh
        # log starts with the last part.
        _slice_log(events, cuts[3], cuts[3] + 10).write_binary(p, manifest, append=True)
        import os
        os.replace(p, p + ".1")
        _slice_log(events, cuts[3] + 10, cuts[4]).write_binary(p, manifest)

    t = threading.Thread(target=writer)
    t.start()
    for b in tail_binary_log(p, manifest, follow=True, poll=0.02, stop=done.is_set):
        seen.append(b.events)
        if sum(len(e) for e in seen) >= n:
            done.set()
    t.join(timeout=20)
    assert not t.is_alive()
    np.testing.assert_array_equal(EventLog.concat(seen).ts, events.ts)


# -- daemon/epochs -----------------------------------------------------------

def _epoch(i, n=16):
    return PlacementEpoch(epoch_id=i, window=i - 1, plan_hash=f"h{i}",
                          rf=np.full(n, i, dtype=np.int32),
                          category_idx=np.full(n, i % 4, dtype=np.int32), n_nodes=3)


def test_publisher_monotonic_frozen_and_pins():
    pub = EpochPublisher()
    assert pub.pin() is None and pub.peek() is None
    pub.publish(_epoch(1))
    pub.record_pins = True
    pub.publish(_epoch(2))
    with pytest.raises(ValueError, match="epoch ids must grow"):
        pub.publish(_epoch(2))
    assert pub.peek().epoch_id == 2 and not pub.first_pins
    ep = pub.pin()
    assert ep.epoch_id == 2 and pub.published_total == 2 and list(pub.first_pins) == [2]
    with pytest.raises(ValueError):
        ep.rf[0] = 99
    with pytest.raises(ValueError, match="no resolver"):
        ep.read_view(np.array([0]))


def test_pinning_never_mixes_epochs_under_publication():
    pub = EpochPublisher()
    pub.publish(_epoch(1))
    stop, torn = threading.Event(), []

    def reader():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            ep = pub.pin()
            vals = {int(ep.epoch_id)}
            for _ in range(8):
                vals.update(int(v) for v in ep.rf[rng.integers(0, len(ep.rf), size=4)])
            if len(vals) != 1:
                torn.append(vals)
                return

    readers = [threading.Thread(target=reader) for _ in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for r in readers:
            r.start()
        for i in range(2, 250):
            pub.publish(_epoch(i))
    finally:
        stop.set()
        for r in readers:
            r.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(r.is_alive() for r in readers)
    assert not torn and pub.pin().epoch_id == 249


# -- daemon/brownout ---------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"hold": 1}, {"burn_engage": 2.0}])
def test_brownout_ladder_matches_the_reference(kw):
    lad = BrownoutLadder(BrownoutConfig(**kw))
    ref = ref_brownout.BrownoutLadder(ref_brownout.BrownoutConfig(**kw))
    assert RUNGS == ref_brownout.RUNGS
    rng = np.random.default_rng(5)
    got, want = [], []
    for w in range(200):
        lag = float(rng.choice([0.0, 0.5, 1.2, 2.5, 3.5, 5.0, 9.0]))
        burn = float(rng.choice([0.0, 2.5]))
        got += lad.step(w, lag, slo_burn=burn)
        want += ref.step(w, lag, slo_burn=burn)
        assert (lad.level, lad.calm, lad.modes()) == (ref.level, ref.calm, ref.modes())
    assert got == want and {t["state"] for t in got} == {"engage", "release"}
    fresh = BrownoutLadder(BrownoutConfig(**kw))
    fresh.load_state_dict(lad.state_dict())
    assert fresh.state_dict() == lad.state_dict() == ref.state_dict()
    fresh.load_state_dict({"level": 99, "calm": -3})
    assert (fresh.level, fresh.calm) == (len(RUNGS), 0)


@pytest.mark.parametrize("kw,match", [
    ({"engage": (1.0, 2.0)}, "cover all 5 rungs"),
    ({"engage": (2.0, 1.0, 3.0, 4.0, 5.0)}, "non-decreasing"),
    ({"release": (2.0, 1.5, 2.0, 3.0, 4.0)}, "strictly below"),
    ({"hold": 0}, "hold"),
    ({"shed_fraction": 1.5}, "shed_fraction"),
    ({"coalesce_max": 1}, "coalesce_max"),
])
def test_brownout_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        BrownoutConfig(**kw)


# -- daemon/supervise --------------------------------------------------------

def test_supervisor_restarts_then_succeeds(tmp_path):
    counter = tmp_path / "n.txt"
    prog = ("import pathlib, sys; p = pathlib.Path(r'%s'); "
            "n = int(p.read_text() or 0) if p.exists() else 0; "
            "p.write_text(str(n + 1)); sys.exit(0 if n >= 2 else 7)" % counter)
    lines = []
    rc = supervise([sys.executable, "-c", prog], max_restarts=5, backoff_base=0.01,
                   backoff_cap=0.05, log=lines.append)
    assert rc == 0 and counter.read_text() == "3"
    assert sum("restarting in" in ln for ln in lines) == 2


def test_supervisor_gives_up_on_a_crash_loop_and_validates():
    lines = []
    rc = supervise([sys.executable, "-c", "import sys; sys.exit(3)"], max_restarts=3,
                   backoff_base=0.01, backoff_cap=0.02, log=lines.append)
    assert rc == 3 and any("giving up" in ln for ln in lines)
    with pytest.raises(ValueError, match="max_restarts"):
        supervise(["true"], max_restarts=0)
    with pytest.raises(ValueError, match="backoff"):
        supervise(["true"], backoff_base=2.0, backoff_cap=1.0)
