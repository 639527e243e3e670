"""Planner wall-clock: the SoA control plane against the legacy object path;
the counterpart of ``cdrs_tpu/benchmarks/plan_bench.py``.

The per-window control plane is structure-of-arrays (``control/migrate.py``,
``faults/repair.py``) with DECISION-IDENTICAL semantics to the
object-at-a-time implementations it replaced (kept verbatim in
``compat/reference_planners`` as the baseline).  This bench pins the other
half of the claim: at 10M files the planners are >= 10x faster, and the
equivalence is re-asserted on the bench scenarios.

Two planner scenarios per scale (1M and 10M files), host numpy:

* **migration** — a large category flip (25% of files change category/rf)
  lands as one plan diff, then three budgeted admission windows each
  followed by a ``state_arrays`` checkpoint dump;
* **repair** — a whole-rack kill (3 of 12 nodes) under a tight byte
  budget: backlog sync from the cluster's gaps, one budgeted repair pass,
  checkpoint dump.  The legacy path walks every damaged file per window;
  the SoA path classifies the non-admitted tail in one vectorized pass.

Timing uses **interleaved paired rounds** (object and SoA sides alternate
within each round, order flipping per round); the reported ratio is
**best-of-rounds object / best-of-rounds SoA**.  An **end-to-end** section
runs a real controller on ``device`` (CUDA unless ``--device cpu``; its
re-clusters launch the Lloyd kernel) with a rack kill and category drift,
serial against ``overlap_windows=True``, and records windows a second and
record bit-identity.

    python -m cdrs_tpu_torch.benchmarks.plan_bench [--quick] [--device cpu]

writes ``data/plan_bench_torch.json`` and, outside ``--quick``, appends its
bench_record to the port's history (``regress.append_history``,
deduplicated; ``--history ''`` disables).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
import zlib

import numpy as np

from ..cluster.placement import ClusterTopology, place_replicas
from ..compat.reference_planners import (ReferenceMigrationScheduler, ReferenceRepairScheduler,
                                         reference_plan_diff)
from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..control.migrate import MigrationScheduler, plan_diff
from ..device import resolve_device
from ..faults import ClusterState, FaultEvent, FaultSchedule, RepairScheduler
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from .common import bench_record, strip_seconds, write_artifact

__all__ = ["run_plan_bench"]

DEFAULT_OUT = "data/plan_bench_torch.json"

_NODES = tuple(f"dn{i}" for i in range(1, 13))
_RACKS = {f"dn{i}": f"r{(i - 1) // 3}" for i in range(1, 13)}
_KILLED_RACK = ("dn4", "dn5", "dn6")
_FLIP_FRAC = 0.25
_ADMIT_WINDOWS = 3


# -- migration scenario ------------------------------------------------------

def _migration_arrays(n: int, seed: int) -> dict:
    """The category-flip scenario as plain arrays (shared by both sides)."""
    rng = np.random.default_rng(seed)
    rf_old = rng.integers(1, 5, n).astype(np.int64)
    cat_old = rng.integers(0, 4, n).astype(np.int64)
    rf_new, cat_new = rf_old.copy(), cat_old.copy()
    flip = rng.random(n) < _FLIP_FRAC
    m = int(flip.sum())
    rf_new[flip] = rng.integers(1, 5, m)
    cat_new[flip] = rng.integers(0, 4, m)
    sizes = rng.integers(1, 1 << 20, n).astype(np.int64)
    prio = np.round(rng.normal(size=n), 1)
    return {"n": n, "rf_old": rf_old, "cat_old": cat_old, "rf_new": rf_new,
            "cat_new": cat_new, "sizes": sizes, "prio": prio,
            "budget": int(sizes.sum() * 0.001), "changed": m}


def _admit_fp(applied) -> tuple:
    """Order-sensitive decision fingerprint of one window's admitted moves:
    count plus CRCs over the (file_index, bytes_moved) sequences.  Works on
    a MoveSet (SoA side) or a PlanMove list (object side); computed outside
    the timed region."""
    if hasattr(applied, "file_index"):
        idx = applied.file_index.astype(np.int64)
        byt = applied.bytes_moved.astype(np.int64)
    else:
        idx = np.asarray([mv.file_index for mv in applied], dtype=np.int64)
        byt = np.asarray([mv.bytes_moved for mv in applied], dtype=np.int64)
    return (idx.size, zlib.crc32(idx.tobytes()), zlib.crc32(byt.tobytes()))


def _time_migration(side: str, a: dict) -> tuple[float, list]:
    """One timed migration-planning pass: diff + submit + 3 budgeted
    windows, each followed by a checkpoint dump.  Returns (seconds,
    per-window decision fingerprint)."""
    t0 = time.perf_counter()
    if side == "soa":
        sched = MigrationScheduler(a["n"], max_bytes_per_window=a["budget"],
                                   hysteresis_windows=1)
        sched.submit(plan_diff(a["rf_old"], a["rf_new"], a["cat_old"], a["cat_new"],
                               a["sizes"], priority=a["prio"]))
    else:
        sched = ReferenceMigrationScheduler(a["n"], max_bytes_per_window=a["budget"],
                                            hysteresis_windows=1)
        sched.submit(reference_plan_diff(a["rf_old"], a["rf_new"], a["cat_old"],
                                         a["cat_new"], a["sizes"], priority=a["prio"]))
    admitted = []
    deferred = []
    for w in range(_ADMIT_WINDOWS):
        applied = sched.schedule(w)
        admitted.append(applied)
        deferred.append(sched.last_deferred_budget)
        if side == "soa":
            sched.state_arrays()
        else:
            # The legacy checkpoint: re-sort the dict backlog into the
            # historical column dump.
            moves = sorted(sched.backlog.values(), key=lambda mv: mv.file_index)
            {  # noqa: B018 - built for its cost, like the old path
                "sched_file_index": np.asarray([mv.file_index for mv in moves], dtype=np.int64),
                "sched_bytes_moved": np.asarray([mv.bytes_moved for mv in moves],
                                                dtype=np.int64),
                "sched_priority": np.asarray([mv.priority for mv in moves], dtype=np.float64),
            }
    dt = time.perf_counter() - t0
    fp = [(*_admit_fp(ap), df) for ap, df in zip(admitted, deferred)]
    return dt, fp


# -- repair scenario ---------------------------------------------------------

def _repair_states(n: int, seed: int) -> tuple[ClusterState, np.ndarray]:
    manifest = generate_population(GeneratorConfig(n_files=n, seed=seed, nodes=_NODES))
    topo = ClusterTopology.from_racks(_NODES, _RACKS)
    rng = np.random.default_rng(seed)
    rf = rng.integers(2, 4, n).astype(np.int32)
    placement = place_replicas(manifest, rf, topo, seed=0)
    state = ClusterState(placement, manifest.size_bytes)
    for nd in _KILLED_RACK:
        state.apply_event(FaultEvent(0, "crash", nd))
    return state, rf.astype(np.int64)


def _time_repair(side: str, state: ClusterState, rf: np.ndarray) -> tuple[float, tuple]:
    """One timed repair-planning pass on a PRIVATE copy of the killed
    cluster: backlog sync, one budgeted window, checkpoint dump."""
    cat = np.zeros(rf.shape[0], dtype=np.int64)
    budget = int(state.sizes.sum() * 0.0001)
    sched = RepairScheduler(seed=0) if side == "soa" else ReferenceRepairScheduler(seed=0)
    t0 = time.perf_counter()
    sched.sync(state, rf)
    rep = sched.schedule(1, state, rf, cat, max_bytes=budget, max_files=200)
    if side == "soa":
        sched.state_arrays()
    else:
        tasks = sorted(sched.backlog.values(), key=lambda t: t.file_index)
        {  # noqa: B018 - built for its cost, like the old path
            "repair_file_index": np.asarray([t.file_index for t in tasks], dtype=np.int64),
            "repair_attempts": np.asarray([t.attempts for t in tasks], dtype=np.int64),
        }
    dt = time.perf_counter() - t0
    ap = np.asarray(rep.applied, dtype=np.int64).reshape(-1, 3)
    fp = (len(rep.applied), zlib.crc32(ap.tobytes()), rep.bytes_used, rep.bytes_copied,
          rep.files_touched, rep.deferred_budget, rep.deferred_no_target, len(sched.backlog))
    return dt, fp


def _paired_rounds(scale_label: str, n: int, seed: int, rounds: int) -> dict:
    """Interleaved paired rounds at one scale; best-of-rounds per side."""
    mig = _migration_arrays(n, seed)
    repair_base, rf = _repair_states(n, seed + 1)
    t_mig = {"object": [], "soa": []}
    t_rep = {"object": [], "soa": []}
    fps: dict[str, list] = {}
    for r in range(rounds):
        order = ("object", "soa") if r % 2 == 0 else ("soa", "object")
        for side in order:
            dt, fp = _time_migration(side, mig)
            t_mig[side].append(dt)
            fps.setdefault("mig_" + side, fp)
            state = copy.deepcopy(repair_base)
            dt, fp = _time_repair(side, state, rf)
            t_rep[side].append(dt)
            fps.setdefault("rep_" + side, fp)
    identical = fps["mig_object"] == fps["mig_soa"] and fps["rep_object"] == fps["rep_soa"]
    best = {k: min(v) for k, v in
            (("mig_object", t_mig["object"]), ("mig_soa", t_mig["soa"]),
             ("rep_object", t_rep["object"]), ("rep_soa", t_rep["soa"]))}
    obj = best["mig_object"] + best["rep_object"]
    soa = best["mig_soa"] + best["rep_soa"]
    return {
        "scale": scale_label, "n_files": n, "rounds": rounds,
        "moves_changed": mig["changed"],
        "repair_backlog": fps["rep_soa"][-1],
        "migration_seconds_object": round(best["mig_object"], 4),
        "migration_seconds_soa": round(best["mig_soa"], 4),
        "migration_speedup": round(best["mig_object"] / best["mig_soa"], 2),
        "repair_seconds_object": round(best["rep_object"], 4),
        "repair_seconds_soa": round(best["rep_soa"], 4),
        "repair_speedup": round(best["rep_object"] / best["rep_soa"], 2),
        "planner_seconds_object": round(obj, 4),
        "planner_seconds_soa": round(soa, 4),
        "planner_speedup": round(obj / soa, 2),
        "decisions_identical": bool(identical),
        "rounds_object_seconds": [round(x + y, 4) for x, y in
                                  zip(t_mig["object"], t_rep["object"])],
        "rounds_soa_seconds": [round(x + y, 4) for x, y in zip(t_mig["soa"], t_rep["soa"])],
    }


# -- end-to-end windows/sec --------------------------------------------------

def _e2e_windows(n_files: int, n_windows: int, seed: int, device=None) -> dict:
    """A real controller run on ``device`` (category drift + rack kill,
    budgeted churn), serial against overlap: windows a second end to end
    and record bit-identity."""
    dev = resolve_device(device)
    duration = 60.0 * n_windows
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    kill = FaultSchedule.from_specs([f"crash:{nd}@3" for nd in _KILLED_RACK])

    def run(overlap: bool):
        cfg = ControllerConfig(
            window_seconds=60.0, default_rf=2,
            max_bytes_per_window=int(sizes.sum() * 0.05),
            hysteresis_windows=1, drift_threshold=0.02,
            kmeans=KMeansConfig(k=16, seed=42),
            scoring=validated_scoring_config(),
            fault_schedule=FaultSchedule(kill.events),
            topology=ClusterTopology.from_racks(_NODES, _RACKS),
            overlap_windows=overlap, device=dev)
        ctl = ReplicationController(manifest, cfg)
        t0 = time.perf_counter()
        res = ctl.run(events)
        return res, time.perf_counter() - t0

    res_serial, t_serial = run(False)
    res_overlap, t_overlap = run(True)
    s_serial = res_serial.summary()
    s_overlap = res_overlap.summary()
    return {
        "n_files": n_files, "windows": len(res_serial.records),
        "windows_per_sec_serial": round(len(res_serial.records) / t_serial, 3),
        "windows_per_sec_overlap": round(len(res_overlap.records) / t_overlap, 3),
        "summary_windows_per_sec_serial": s_serial.get("windows_per_sec"),
        "summary_windows_per_sec_overlap": s_overlap.get("windows_per_sec"),
        "plan_seconds_fraction": s_serial.get("plan_seconds_fraction"),
        "overlap_bit_identical": (
            strip_seconds(res_serial.records) == strip_seconds(res_overlap.records)
            and bool(np.array_equal(res_serial.rf, res_overlap.rf))
            and bool(np.array_equal(res_serial.category_idx, res_overlap.category_idx))),
    }


def run_plan_bench(scales: list[int], rounds: int = 3, seed: int = 8, e2e_files: int = 20_000,
                   e2e_windows: int = 8, device=None) -> dict:
    dev = resolve_device(device)
    out: dict = {"scales": [], "scenario": {
        "flip_fraction": _FLIP_FRAC, "admit_windows": _ADMIT_WINDOWS,
        "nodes": list(_NODES), "killed_rack": list(_KILLED_RACK),
        "migration_budget_frac": 0.001, "repair_budget_frac": 0.0001,
        "methodology": "interleaved paired rounds, best-of-rounds ratio"}}
    for n in scales:
        label = f"{n // 1_000_000}M" if n >= 1_000_000 else f"{n // 1000}k"
        row = _paired_rounds(label, n, seed, rounds)
        out["scales"].append(row)
        print(json.dumps({k: row[k] for k in ("scale", "planner_speedup", "migration_speedup",
                                              "repair_speedup", "decisions_identical")}))
    out["end_to_end"] = _e2e_windows(e2e_files, e2e_windows, seed, dev)
    top = out["scales"][-1]
    out["criteria"] = {
        "planner_10x_at_top_scale": top["planner_speedup"] >= 10.0,
        "decisions_identical": all(s["decisions_identical"] for s in out["scales"]),
        "overlap_bit_identical": out["end_to_end"]["overlap_bit_identical"],
    }
    out["bench_records"] = [
        bench_record("plan_planner_speedup_" + top["scale"].lower(), top["planner_speedup"],
                     "x", dev),
    ]
    return out


def main(argv=None) -> int:
    from .regress import (add_history_argument, append_history, extract_records,
                          resolve_history_path)

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.plan_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=8, dest="round_no",
                   help="PR-round stamp for the regress history")
    add_history_argument(p)
    p.add_argument("--rounds", type=int, default=3,
                   help="interleaved paired timing rounds per scale")
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--quick", action="store_true",
                   help="small sizes for smoke runs (CI): one 100k scale, 2 rounds, tiny "
                        "end-to-end")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        out = run_plan_bench([100_000], rounds=2, seed=args.seed, e2e_files=3_000,
                             e2e_windows=5, device=dev)
    else:
        out = run_plan_bench([1_000_000, 10_000_000], rounds=args.rounds, seed=args.seed,
                             device=dev)
    out["round"] = args.round_no

    write_artifact(args.out, out, dev)
    history = resolve_history_path(args)
    appended = 0
    if history:
        appended = append_history(history, extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"], "history_appended": appended,
                      "top_scale_speedup": out["scales"][-1]["planner_speedup"],
                      "windows_per_sec_overlap": out["end_to_end"]["windows_per_sec_overlap"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
