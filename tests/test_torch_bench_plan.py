"""The port's ``benchmarks/plan_bench`` and ``compat/reference_planners``
against the reference's on the CPU.

The planner scenarios are host numpy: the migration arrays must be the
reference's bit for bit, and at 20,000 files both sides of the port (the
SoA planners and the copied object planners) must give equal decision
fingerprints, equal to the reference's.  The copied planners must equal
the port's SoA planners on hypothesis-drawn cases, as
``tests/test_plan_vectorized.py`` holds the reference's.  The end-to-end
controller runs (serial and overlapped) start from the reference's cold
init (decay 1: the reference on ``backend="jax"``); their records must be
the reference's exactly but for the wall clock."""

import copy
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import cdrs_tpu.benchmarks.plan_bench as ref  # noqa: E402
import cdrs_tpu.compat.reference_planners as ref_planners  # noqa: E402
from test_torch_scenario_parity import carried_init  # noqa: E402
from torch_bench_parity import (assert_matches, one_torch_thread,  # noqa: E402
                                reference_on_jax, round_trips)

from cdrs_tpu_torch.benchmarks import plan_bench  # noqa: E402
from cdrs_tpu_torch.benchmarks.common import bench_record  # noqa: E402
from cdrs_tpu_torch.cluster.placement import ClusterTopology, place_replicas  # noqa: E402
from cdrs_tpu_torch.compat.reference_planners import (  # noqa: E402
    ReferenceMigrationScheduler, ReferenceRepairScheduler, reference_plan_diff)
from cdrs_tpu_torch.config import GeneratorConfig  # noqa: E402
from cdrs_tpu_torch.control.migrate import MigrationScheduler, plan_diff  # noqa: E402
from cdrs_tpu_torch.faults import ClusterState, FaultEvent, RepairScheduler  # noqa: E402
from cdrs_tpu_torch.sim.generator import generate_population  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

#: The drift scalars of a record, compared within 1e-5.
DRIFT = ("drift", "centroid_shift", "population_delta")
#: The end-to-end block's wall-clock fields, never compared.
E2E_WALL = {"windows_per_sec_serial", "windows_per_sec_overlap",
            "summary_windows_per_sec_serial", "summary_windows_per_sec_overlap",
            "plan_seconds_fraction"}


@pytest.mark.parametrize("n", [1_000, 20_000])
def test_migration_arrays_are_the_references(n):
    got, want = plan_bench._migration_arrays(n, 8), ref._migration_arrays(n, 8)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key


def test_migration_fingerprints_match_both_sides_and_the_reference():
    arrays = plan_bench._migration_arrays(20_000, 8)
    fps = {side: plan_bench._time_migration(side, arrays)[1] for side in ("soa", "object")}
    want = ref._time_migration("soa", ref._migration_arrays(20_000, 8))[1]
    assert fps["soa"] == fps["object"] == want
    assert len(want) == 3 and all(fp[0] > 0 for fp in want)


def test_repair_fingerprints_match_both_sides_and_the_reference():
    base, rf = plan_bench._repair_states(20_000, 9)
    ref_base, ref_rf = ref._repair_states(20_000, 9)
    np.testing.assert_array_equal(base.replica_map, ref_base.replica_map)
    np.testing.assert_array_equal(rf, ref_rf)
    fps = {side: plan_bench._time_repair(side, copy.deepcopy(base), rf)[1]
           for side in ("soa", "object")}
    want = ref._time_repair("soa", copy.deepcopy(ref_base), ref_rf)[1]
    assert fps["soa"] == fps["object"] == want
    assert want[0] > 0 and want[-1] > 0   # repairs admitted, a backlog left


def test_paired_rounds_keep_the_references_keys():
    got = plan_bench._paired_rounds("5k", 5_000, 8, 1)
    want = ref._paired_rounds("5k", 5_000, 8, 1)
    assert set(got) == set(want) and got["decisions_identical"]
    for key in ("scale", "n_files", "rounds", "moves_changed", "repair_backlog"):
        assert got[key] == want[key], key


# -- the copied planners against the port's SoA planners ----------------------

def _moves(moves):
    return [(m.file_index, m.rf_old, m.rf_new, m.cat_old, m.cat_new, m.bytes_moved,
             m.priority) for m in moves]


def _plan(rng, n):
    return (rng.integers(1, 5, size=n).astype(np.int64),
            rng.integers(0, 4, size=n).astype(np.int64), np.round(rng.normal(size=n), 1))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), with_move_bytes=st.booleans())
def test_copied_plan_diff_is_the_soa_plan_diff(seed, with_move_bytes):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 300))
    rf_old, cat_old, _ = _plan(rng, n)
    rf_new, cat_new, prio = _plan(rng, n)
    sizes = rng.integers(1, 1 << 20, size=n).astype(np.int64)
    move_bytes = rng.integers(0, 1 << 18, size=n).astype(np.int64) if with_move_bytes else None
    args = (rf_old, rf_new, cat_old, cat_new, sizes)
    want = _moves(plan_diff(*args, priority=prio, move_bytes=move_bytes))
    assert _moves(reference_plan_diff(*args, priority=prio, move_bytes=move_bytes)) == want
    assert _moves(ref_planners.reference_plan_diff(*args, priority=prio,
                                                   move_bytes=move_bytes)) == want


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       max_bytes=st.sampled_from([None, 0, 5_000_000, 50_000_000]),
       max_files=st.sampled_from([None, 1, 3, 17]), hysteresis=st.integers(0, 2))
def test_copied_migration_scheduler_is_the_soa_scheduler(seed, max_bytes, max_files,
                                                        hysteresis):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 300))
    sizes = rng.integers(0, 1 << 20, size=n).astype(np.int64)
    kw = dict(max_bytes_per_window=max_bytes, max_files_per_window=max_files,
              hysteresis_windows=hysteresis)
    soa, obj = MigrationScheduler(n, **kw), ReferenceMigrationScheduler(n, **kw)
    applied_rf, applied_cat, _ = _plan(rng, n)
    for w in range(6):
        if w == 0 or rng.random() < 0.5:
            rf_new, cat_new, prio = _plan(rng, n)
            moves = plan_diff(applied_rf, rf_new, applied_cat, cat_new, sizes, priority=prio)
            soa.submit(moves)
            obj.submit(list(moves))
        bres = int(rng.integers(0, 1 << 22)) if rng.random() < 0.4 else 0
        fres = int(rng.integers(0, 5)) if rng.random() < 0.4 else 0
        got = soa.schedule(w, bytes_reserved=bres, files_reserved=fres)
        want = obj.schedule(w, bytes_reserved=bres, files_reserved=fres)
        assert _moves(got) == _moves(want), w
        assert (soa.last_deferred_hysteresis, soa.last_deferred_budget) == \
            (obj.last_deferred_hysteresis, obj.last_deferred_budget)
        assert soa.backlog_bytes == obj.backlog_bytes
        np.testing.assert_array_equal(soa.last_moved, obj.last_moved)
        for m in got:
            applied_rf[m.file_index], applied_cat[m.file_index] = m.rf_new, m.cat_new


_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5", "dn6")
_RACKS = {"dn1": "r0", "dn2": "r0", "dn3": "r1", "dn4": "r1", "dn5": "r2", "dn6": "r2"}
_KINDS = ("crash", "recover", "partition", "heal", "flaky", "unflaky", "degrade", "restore")


def _fault(rng, w):
    kind = str(rng.choice(_KINDS))
    if kind in ("partition", "heal"):
        nodes = rng.choice(_NODES, size=int(rng.integers(1, 3)), replace=False)
        return FaultEvent(w, kind, "+".join(sorted(nodes)))
    node = str(rng.choice(_NODES))
    if kind == "flaky":
        return FaultEvent(w, kind, node, fail_prob=float(rng.choice([0.3, 0.6, 0.9])))
    if kind == "degrade":
        return FaultEvent(w, kind, node, factor=float(rng.choice([0.25, 0.5])))
    return FaultEvent(w, kind, node)


def _report(rep):
    return (rep.applied, rep.bytes_used, rep.bytes_copied, rep.files_touched, rep.failed,
            rep.rebalanced, rep.deferred_budget, rep.deferred_backoff, rep.deferred_no_source,
            rep.deferred_no_target, rep.deferred_partition)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       max_bytes=st.sampled_from([None, 200_000, 20_000_000]),
       max_files=st.sampled_from([None, 1, 6, 1000]))
def test_copied_repair_scheduler_is_the_soa_scheduler(seed, max_bytes, max_files):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 120))
    manifest = generate_population(GeneratorConfig(n_files=n, seed=int(rng.integers(1 << 16)),
                                                   nodes=_NODES))
    rf = rng.integers(1, 4, size=n).astype(np.int32)
    placement = place_replicas(manifest, rf, ClusterTopology.from_racks(_NODES, _RACKS), seed=0)
    st_soa = ClusterState(placement, manifest.size_bytes)
    st_obj = copy.deepcopy(st_soa)
    rf = rf.astype(np.int64)
    cat = rng.integers(0, 4, size=n).astype(np.int64)
    soa, obj = RepairScheduler(seed=seed % 7), ReferenceRepairScheduler(seed=seed % 7)
    for w in range(8):
        for _ in range(int(rng.integers(0, 3))):
            ev = _fault(rng, w)
            st_soa.apply_event(ev)
            st_obj.apply_event(ev)
        soa.sync(st_soa, rf)
        obj.sync(st_obj, rf)
        got = soa.schedule(w, st_soa, rf, cat, max_bytes=max_bytes, max_files=max_files)
        want = obj.schedule(w, st_obj, rf, cat, max_bytes=max_bytes, max_files=max_files)
        assert _report(got) == _report(want), w
        assert {int(f): (t.attempts, t.next_window, t.stalled, t.stall_until)
                for f, t in soa.backlog.items()} == \
            {f: (t.attempts, t.next_window, t.stalled, t.stall_until)
             for f, t in obj.backlog.items()}
        np.testing.assert_array_equal(st_soa.replica_map, st_obj.replica_map)
        np.testing.assert_array_equal(st_soa.node_bytes, st_obj.node_bytes)


# -- the end-to-end controllers ----------------------------------------------

def test_e2e_windows_match_the_references_records(monkeypatch, tmp_path):
    """Serial and overlapped controllers at 3,000 files, 5 windows: records
    exact (ints, strings and floats alike) but ``seconds`` and the drift
    scalars, which agree within 1e-5 (the port forms drift on the host in
    float64, the reference's jax backend in float32); rf and categories
    exact."""
    runs = {"port": [], "ref": []}

    def recording(mod, side):
        cls = mod.ReplicationController

        class Recorded(cls):
            def run(self, *a, **kw):
                res = super().run(*a, **kw)
                runs[side].append(res)
                return res

        monkeypatch.setattr(mod, "ReplicationController", Recorded)

    recording(plan_bench, "port")
    recording(ref, "ref")
    with reference_on_jax(ref):
        want = ref._e2e_windows(3_000, 5, 8)
    with carried_init():
        got = plan_bench._e2e_windows(3_000, 5, 8, device="cpu")
    assert_matches(got, want, skip=E2E_WALL)
    assert got["overlap_bit_identical"] and got["windows"] == 5
    assert len(runs["port"]) == len(runs["ref"]) == 2
    for g, w in zip(runs["port"], runs["ref"]):
        assert_matches(g.records, w.records, rel=0.0, skip={"seconds", *DRIFT})
        assert_matches([[r.get(f) for f in DRIFT] for r in g.records],
                       [[r.get(f) for f in DRIFT] for r in w.records], rel=1e-5)
        assert np.array_equal(g.rf, w.rf) and np.array_equal(g.category_idx, w.category_idx)
    round_trips(got, tmp_path)


def test_quick_runs_never_append_the_history(tmp_path, monkeypatch):
    """--quick never writes the ledger (a smoke-scale row would dedup away
    the later real measurement); a full run appends to the port's."""
    monkeypatch.chdir(tmp_path)
    stub = {"scales": [{"scale": "1k", "planner_speedup": 1.0}],
            "end_to_end": {"windows_per_sec_overlap": 1.0}, "criteria": {},
            "bench_records": [bench_record("plan_planner_speedup_1k", 1.0, "x", "cpu")]}
    monkeypatch.setattr(plan_bench, "run_plan_bench", lambda *a, **k: copy.deepcopy(stub))
    assert plan_bench.main(["--quick", "--device", "cpu", "--out", str(tmp_path / "o.json")]) == 0
    assert not (tmp_path / "data").exists()
    assert plan_bench.main(["--device", "cpu", "--out", str(tmp_path / "o2.json")]) == 0
    (row,) = [json.loads(line) for line in
              (tmp_path / "data" / "bench_history_torch.jsonl").read_text().splitlines()]
    assert row["metric"] == "plan_planner_speedup_1k" and row["platform"] == "torch-cpu"
    assert not (tmp_path / "data" / "bench_history.jsonl").exists()


def test_plan_bench_main_quick_writes_the_ports_artifact(tmp_path, capsys):
    out = tmp_path / "p.json"
    assert plan_bench.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"scales", "scenario", "end_to_end", "criteria", "bench_records", "round",
                        "run_meta", "cold_init"}
    assert doc["run_meta"] and "cpu" in doc["cold_init"]
    assert doc["criteria"]["decisions_identical"] and doc["criteria"]["overlap_bit_identical"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["history_appended"] == 0 and line["top_scale_speedup"] > 1.0
