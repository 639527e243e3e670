"""The controller's host modules in the port against ``cdrs_tpu``.

Windows, the plan diff and the migration scheduler, the flat replica
placement, the placement evaluation, the plan CSV and the pacing digest are
host numpy copies: on the same seeded inputs they must give identical
results to the JAX package's (exact equality throughout).
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from cdrs_tpu.cluster.evaluate import evaluate_placement as ref_evaluate  # noqa: E402
from cdrs_tpu.cluster.placement import ClusterTopology as RefTopology  # noqa: E402
from cdrs_tpu.cluster.placement import place_replicas as ref_place  # noqa: E402
from cdrs_tpu.cluster.plan import PlanEntry as RefPlanEntry  # noqa: E402
from cdrs_tpu.cluster.plan import write_plan_csv as ref_write_plan  # noqa: E402
from cdrs_tpu.config import GeneratorConfig as RefGen  # noqa: E402
from cdrs_tpu.config import SimulatorConfig as RefSim  # noqa: E402
from cdrs_tpu.control.migrate import MigrationScheduler as RefScheduler  # noqa: E402
from cdrs_tpu.control.migrate import plan_diff as ref_plan_diff  # noqa: E402
from cdrs_tpu.control.windows import iter_windows as ref_iter_windows  # noqa: E402
from cdrs_tpu.obs.aggregate import pacing_digest as ref_pacing  # noqa: E402
from cdrs_tpu.sim.access import simulate_access as ref_simulate  # noqa: E402
from cdrs_tpu.sim.generator import generate_population as ref_generate  # noqa: E402

from cdrs_tpu_torch.cluster.evaluate import evaluate_placement  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas  # noqa: E402
from cdrs_tpu_torch.cluster.plan import PlanEntry, write_plan_csv  # noqa: E402
from cdrs_tpu_torch.config import GeneratorConfig, SimulatorConfig  # noqa: E402
from cdrs_tpu_torch.control.migrate import MigrationScheduler, MoveSet, PlanMove, plan_diff  # noqa: E402
from cdrs_tpu_torch.control.windows import iter_windows  # noqa: E402
from cdrs_tpu_torch.io.events import EventLog  # noqa: E402
from cdrs_tpu_torch.obs.aggregate import pacing_digest  # noqa: E402
from cdrs_tpu_torch.obs.sink import JsonlSink  # noqa: E402
from cdrs_tpu_torch.sim.access import simulate_access  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

N_FILES = 300


@pytest.fixture(scope="module")
def workloads():
    """(port manifest, port events, reference manifest, reference events),
    the same seeded workload made by each package."""
    manifest = generate_population(GeneratorConfig(n_files=N_FILES, seed=21))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=600.0, seed=22))
    ref_manifest = ref_generate(RefGen(n_files=N_FILES, seed=21))
    ref_events = ref_simulate(ref_manifest, RefSim(duration_seconds=600.0, seed=22))
    np.testing.assert_array_equal(events.ts, ref_events.ts)
    return manifest, events, ref_manifest, ref_events


def _assert_same_windows(got, want):
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for col in ("ts", "path_id", "op", "client_id"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
        assert list(a.clients) == list(b.clients)


# -- windows ----------------------------------------------------------------

@pytest.mark.parametrize("source", ["eventlog", "csv", "cdrsb"])
@pytest.mark.parametrize("batch_size", [777, 5000, 1_000_000])
def test_iter_windows_matches_reference(workloads, tmp_path, source, batch_size):
    manifest, events, ref_manifest, ref_events = workloads
    if source == "eventlog":
        src, ref_src = events, ref_events
    else:
        path = str(tmp_path / ("a.log" if source == "csv" else "a.cdrsb"))
        if source == "csv":
            events.write_csv(path, manifest)
        else:
            events.write_binary(path, manifest)
        src = ref_src = path
    box, ref_box = {}, {}
    got = list(iter_windows(src, manifest, 60.0, batch_size=batch_size, t0_out=box))
    want = list(ref_iter_windows(ref_src, ref_manifest, 60.0, batch_size=batch_size,
                                 t0_out=ref_box))
    _assert_same_windows(got, want)
    assert box == ref_box and len(got) >= 10


def test_iter_windows_batch_split_and_gaps_match_reference(workloads):
    manifest, events, ref_manifest, ref_events = workloads
    ts = events.ts.copy()
    ts[len(ts) // 2:] += 600.0      # a five-window silence
    cols = dict(path_id=events.path_id, op=events.op, client_id=events.client_id)
    parts = [EventLog(ts=ts[i:i + 777], **{k: v[i:i + 777] for k, v in cols.items()},
                      clients=events.clients) for i in range(0, len(ts), 777)]
    got = list(iter_windows(parts, manifest, 120.0))
    whole = list(iter_windows(EventLog(ts=ts, clients=events.clients, **cols), manifest,
                              120.0))
    want = list(ref_iter_windows(type(ref_events)(ts=ts, clients=ref_events.clients, **cols),
                                 ref_manifest, 120.0))
    _assert_same_windows(got, want)
    _assert_same_windows(whole, want)
    assert any(len(win) == 0 for _, win in got)
    with pytest.raises(ValueError, match="time-sorted"):
        list(iter_windows(EventLog(ts=ts[::-1].copy(), clients=events.clients, **cols),
                          manifest, 60.0))


# -- plan diff and scheduler ------------------------------------------------

def _random_plans(rng, n):
    rf_old = rng.integers(1, 5, n)
    cat_old = rng.integers(-1, 4, n)
    rf_new = np.where(rng.random(n) < 0.6, rng.integers(1, 5, n), rf_old)
    cat_new = np.where(rng.random(n) < 0.6, rng.integers(0, 4, n), cat_old)
    sizes = rng.integers(1, 10_000, n)
    prio = np.round(rng.normal(size=n), 1)      # ties on purpose
    return rf_old, rf_new, cat_old, cat_new, sizes, prio


def _cols(ms):
    return {c: getattr(ms, c) for c in MoveSet.__slots__}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_diff_matches_reference(seed):
    args = _random_plans(np.random.default_rng(seed), 500)
    got = plan_diff(*args[:5], priority=args[5])
    want = ref_plan_diff(*args[:5], priority=args[5])
    for c, v in _cols(got).items():
        np.testing.assert_array_equal(v, getattr(want, c), err_msg=c)
    assert got.total_bytes == want.total_bytes > 0


@pytest.mark.parametrize("max_bytes,max_files,hysteresis", [
    (None, None, 0), (50_000, None, 1), (None, 37, 2), (30_000, 25, 1), (0, None, 0)])
def test_scheduler_matches_reference_with_state_round_trip(max_bytes, max_files,
                                                           hysteresis):
    """Several windows of submit/schedule, with a checkpoint round trip of
    the port's scheduler halfway; every admitted set, deferral count and
    backlog equals the reference's."""
    rng = np.random.default_rng(7)
    n = 400
    kw = dict(max_bytes_per_window=max_bytes, max_files_per_window=max_files,
              hysteresis_windows=hysteresis)
    port, ref = MigrationScheduler(n, **kw), RefScheduler(n, **kw)
    for w in range(8):
        if w % 3 == 0:
            args = _random_plans(rng, n)
            port.submit(plan_diff(*args[:5], priority=args[5]))
            ref.submit(ref_plan_diff(*args[:5], priority=args[5]))
        if w == 4:
            saved = {k: v.copy() for k, v in port.state_arrays().items()}
            port = MigrationScheduler(n, **kw)
            port.load_state_arrays(saved)
        got, want = port.schedule(w), ref.schedule(w)
        for c, v in _cols(got).items():
            np.testing.assert_array_equal(v, getattr(want, c), err_msg=f"w{w} {c}")
        assert port.last_deferred_hysteresis == ref.last_deferred_hysteresis
        assert port.last_deferred_budget == ref.last_deferred_budget
        assert port.backlog_bytes == ref.backlog_bytes
        for key, v in port.state_arrays().items():
            np.testing.assert_array_equal(v, ref.state_arrays()[key], err_msg=key)


def test_scheduler_plan_moves_and_bad_state():
    moves = [PlanMove(i, 1, 3, 2, 0, bytes_moved=100, priority=float(10 - i))
             for i in range(10)]
    s = MigrationScheduler(10, max_bytes_per_window=250, hysteresis_windows=2)
    s.submit(moves)
    assert [m.file_index for m in s.schedule(0)] == [0, 1]
    assert 5 in s.backlog and list(s.backlog)[0] == moves[2]
    bad = s.state_arrays()
    bad["sched_file_index"] = bad["sched_file_index"] + 100
    with pytest.raises(ValueError, match="outside"):
        MigrationScheduler(10).load_state_arrays(bad)
    with pytest.raises(ValueError, match="missing"):
        MigrationScheduler(10).load_state_arrays({})


# -- placement and evaluation -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nodes", [("dn1", "dn2", "dn3"), ("dn1", "dn2", "dn3", "dn4", "x9")])
def test_place_replicas_bit_equal_to_reference(workloads, seed, nodes):
    manifest, _, ref_manifest, _ = workloads
    rf = np.random.default_rng(seed).integers(1, len(nodes) + 2, N_FILES).astype(np.int32)
    with pytest.warns(UserWarning, match="capped"):
        from cdrs_tpu_torch.cluster.placement import reset_rf_cap_warning

        reset_rf_cap_warning()
        got = place_replicas(manifest, rf, ClusterTopology(nodes=nodes), seed=seed)
    want = ref_place(ref_manifest, rf, RefTopology(nodes=nodes), seed=seed)
    np.testing.assert_array_equal(got.replica_map, want.replica_map)
    np.testing.assert_array_equal(got.rf, want.rf)
    np.testing.assert_array_equal(got.storage_per_node, want.storage_per_node)


def test_placement_refuses_what_is_not_ported(workloads):
    manifest = workloads[0]
    rf = np.ones(N_FILES, dtype=np.int32)
    # The hash chooser is ported (ROADMAP A8f): the reference's placement.
    got = place_replicas(manifest, rf, method="hash")
    want = ref_place(workloads[2], rf, method="hash")
    np.testing.assert_array_equal(got.replica_map, want.replica_map)
    with pytest.raises(ValueError, match="unknown placement method"):
        place_replicas(manifest, rf, method="crush")
    # A rack topology is ported: the domain-aware fill places as the reference does.
    nodes = tuple(manifest.nodes)
    domains = tuple(f"r{i // 2}" for i in range(len(nodes)))
    rf3 = np.random.default_rng(0).integers(1, 4, N_FILES).astype(np.int32)
    got = place_replicas(manifest, rf3, ClusterTopology(nodes=nodes, domains=domains))
    want = ref_place(workloads[2], rf3, RefTopology(nodes=nodes, domains=domains))
    np.testing.assert_array_equal(got.replica_map, want.replica_map)
    with pytest.raises(ValueError, match="duplicate"):
        ClusterTopology(nodes=("dn1", "dn1"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_placement_matches_reference(workloads, seed):
    manifest, events, ref_manifest, ref_events = workloads
    rf = np.random.default_rng(seed + 10).integers(1, 4, N_FILES).astype(np.int32)
    nodes = tuple(manifest.nodes)
    got = evaluate_placement(manifest, events,
                             place_replicas(manifest, rf, ClusterTopology(nodes=nodes)),
                             seed=seed)
    want = ref_evaluate(ref_manifest, ref_events,
                        ref_place(ref_manifest, rf, RefTopology(nodes=nodes)), seed=seed)
    for name in ("read_locality", "load_balance", "total_storage", "n_reads", "n_writes",
                 "reads_per_node", "writes_per_node", "storage_per_node"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert 0.0 < got.read_locality < 1.0 and got.load_balance >= 1.0


# -- plan CSV, pacing digest, sink ------------------------------------------

def test_write_plan_csv_bytes_match_reference(tmp_path):
    rows = [("/a/b,c", "Hot", 3), ("/x", "Unplanned", 1), ('/q"uote', "Archival", 4)]
    write_plan_csv(str(tmp_path / "port.csv"), [PlanEntry(*r) for r in rows])
    ref_write_plan(str(tmp_path / "ref.csv"), [RefPlanEntry(*r) for r in rows])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


@pytest.mark.parametrize("records", [
    [],
    [{"seconds": {"total": 0.0}}],
    [{"seconds": {"total": 0.5, "plan": 0.1}}, {"seconds": {"total": 0.25}},
     {"seconds": {"total": 1.5, "plan": 0.3}}, {"window": 3}],
    [{"seconds": {"total": 2.0}}, {"seconds": {"total": 1.0}}],
])
def test_pacing_digest_matches_reference(records):
    assert pacing_digest(records) == ref_pacing(records)


def test_jsonl_sink_appends(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    with JsonlSink(str(path)) as sink:
        sink.emit({"window": 0, "a": np.int64(3), "b": np.arange(2)})
    with JsonlSink(str(path)) as sink:
        for w in range(1, 4):
            sink.emit({"window": w})
    sink.emit({"window": 9})            # after close: dropped
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["window"] for ln in lines] == [0, 1, 2, 3]
    assert lines[0]["a"] == 3 and lines[0]["b"] == [0, 1]
