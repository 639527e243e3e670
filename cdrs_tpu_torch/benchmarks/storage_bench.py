"""Cost-vs-durability frontier: erasure-coded Archival vs rf=4; the
counterpart of ``cdrs_tpu/benchmarks/storage_bench.py``.

At matched durability, how many bytes cheaper is EC Archival than
replicate(4)?  Scenario (the whole-rack-kill schedule, the rack bench's
workload seed): 12 nodes in 4 racks of 3, a stationary workload settles
into its category plan, then one whole rack crashes for good at a fixed
window.  Three configurations run the IDENTICAL schedule:

* ``baseline``    — no storage config at all;
* ``replicate``   — the explicit all-``replicate`` StorageConfig, which must
  reproduce the baseline's records, placements and durability counts BIT
  FOR BIT;
* ``ec_archival`` — Archival -> ``ec(6,3)`` on the cold tier (HDFS EC's
  RS(6,3) default), everything else replicate-hot.

A rack holds 3 nodes and a stripe spans 9 distinct nodes, so a rack kill
destroys at most m = 3 shards of any stripe: EC survives like rack-aware
rf=4 does while storing Archival at 1.5x raw bytes instead of 4x
(``archival_bytes_ratio`` >= 2).  What EC pays instead is reconstruction
traffic (``repair_amplification``), charged against the same churn budget.
A controller killed mid-outage resumes bit-identically with the EC state in
its checkpoint.  The controllers fold and re-cluster on ``device`` (CUDA
unless ``--device cpu``).

    python -m cdrs_tpu_torch.benchmarks.storage_bench [--quick] [--device cpu]

writes ``data/storage_bench_torch.json`` and (unless ``--no_overhead``) the
telemetry re-check ``data/storage_overhead_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..cluster.placement import ClusterTopology
from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig
from ..control.controller import ControllerConfig, ReplicationController
from ..device import resolve_device
from ..faults import FaultSchedule
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from ..storage import StorageConfig
from .common import (bench_record, min_rf2_scoring, strip_seconds, telemetry_rounds,
                     write_artifact)

__all__ = ["run_storage_bench", "storage_overhead"]

DEFAULT_OUT = "data/storage_bench_torch.json"
DEFAULT_OVERHEAD_OUT = "data/storage_overhead_torch.json"

_NODES = tuple(f"dn{i}" for i in range(1, 13))
_RACK_SPEC = "r0=dn1,dn2,dn3;r1=dn4,dn5,dn6;r2=dn7,dn8,dn9;r3=dn10,dn11,dn12"
_KILLED_RACK = ("dn4", "dn5", "dn6")
#: The storage-only record keys, dropped for the baseline-vs-replicate key.
_STORAGE_KEYS = ("seconds", "storage", "storage_conversions_retried")


def run_storage_bench(
    n_files: int = 400,
    seed: int = 13,
    duration: float = 1800.0,
    n_windows: int = 15,
    kill_window: int = 5,
    k: int = 12,
    max_bytes_frac: float = 0.25,
    resume_check: bool = True,
    device=None,
) -> dict:
    """Run the frontier scenario; returns the artifact dict."""
    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    scoring = min_rf2_scoring()
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    max_bytes = int(max_bytes_frac * float(sizes.sum()))
    kill = FaultSchedule.from_specs([f"crash:{n}@{kill_window}" for n in _KILLED_RACK])

    def mk(storage) -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            max_bytes_per_window=max_bytes, hysteresis_windows=1,
            kmeans=KMeansConfig(k=k, seed=42), scoring=scoring,
            fault_schedule=FaultSchedule(kill.events),
            topology=ClusterTopology.from_rack_spec(_NODES, _RACK_SPEC),
            storage=storage, device=dev)
        return ReplicationController(manifest, cfg)

    sides: dict[str, dict] = {}
    results = {}
    for name, storage in (("baseline", None),
                          ("replicate", StorageConfig.from_scoring(scoring)),
                          ("ec_archival", StorageConfig.ec_archival(scoring))):
        t0 = time.perf_counter()
        res = mk(storage).run(events)
        run_seconds = time.perf_counter() - t0
        results[name] = res
        timeline = []
        recover_at = None
        for r in res.records:
            d = r["durability"]
            degraded = d["lost"] + d["at_risk"] + d["under_replicated"]
            row = {
                "window": r["window"], "nodes_up": d["nodes_up"],
                "lost": d["lost"], "at_risk": d["at_risk"],
                "under_replicated": d["under_replicated"],
                "repair_moves": r["repair_moves"],
                "repair_bytes": r["repair_bytes"],
                "repair_bytes_copied": r.get("repair_bytes_copied", 0),
                "repair_backlog": r["repair_backlog"],
                "bytes_migrated": r["bytes_migrated"],
            }
            if r.get("storage"):
                row["bytes_stored"] = r["storage"]["bytes_stored"]
                row["archival_bytes"] = r["storage"]["per_category_bytes"].get("Archival", 0)
            timeline.append(row)
            if r["window"] >= kill_window and degraded == 0 and recover_at is None:
                recover_at = r["window"]
        rep_bytes = int(sum(t["repair_bytes"] for t in timeline))
        rep_copied = int(sum(t["repair_bytes_copied"] for t in timeline))
        side = {
            "timeline": timeline,
            "files_lost_max": max(t["lost"] for t in timeline),
            "windows_to_full_re_replication":
                None if recover_at is None else recover_at - kill_window,
            "repair_bytes_total": rep_bytes,
            "repair_bytes_copied_total": rep_copied,
            "repair_amplification":
                None if not rep_copied else round(rep_bytes / rep_copied, 3),
            "budget_respected": all(
                t["repair_bytes"] + t["bytes_migrated"] <= max_bytes for t in timeline),
            "run_seconds": round(run_seconds, 3),
        }
        if res.records and res.records[-1].get("storage"):
            side["storage_final"] = res.records[-1]["storage"]
        sides[name] = side

    # -- the degeneracy criterion -----------------------------------------
    identical = (
        strip_seconds(results["baseline"].records, _STORAGE_KEYS)
        == strip_seconds(results["replicate"].records, _STORAGE_KEYS)
        and bool(np.array_equal(results["baseline"].rf, results["replicate"].rf))
        and bool(np.array_equal(results["baseline"].category_idx,
                                results["replicate"].category_idx)))

    # -- the frontier ------------------------------------------------------
    rep_final, ec_final = sides["replicate"]["storage_final"], sides["ec_archival"]["storage_final"]
    arch_rf4 = rep_final["per_category_bytes"].get("Archival", 0)
    arch_ec = ec_final["per_category_bytes"].get("Archival", 0)
    ratio = round(arch_rf4 / arch_ec, 4) if arch_ec else None
    frontier = {
        "archival_bytes_rf4": arch_rf4,
        "archival_bytes_ec63": arch_ec,
        "archival_bytes_ratio": ratio,
        "total_stored_rf": rep_final["bytes_stored"],
        "total_stored_ec": ec_final["bytes_stored"],
        "cost_units_rf": rep_final["cost_units"],
        "cost_units_ec": ec_final["cost_units"],
        "ec_repair_amplification": sides["ec_archival"]["repair_amplification"],
        "rf_repair_amplification": sides["replicate"]["repair_amplification"],
    }

    out: dict = {
        "scenario": {
            "n_files": n_files, "seed": seed, "nodes": list(_NODES),
            "racks": _RACK_SPEC, "killed_rack": list(_KILLED_RACK),
            "duration_seconds": duration, "n_windows": n_windows,
            "window_seconds": window_seconds, "k": k,
            "kill_window": kill_window, "default_rf": 2,
            "replication_factors": scoring.replication_factors,
            "ec_archival": "ec(6,3):cold",
            "max_bytes_per_window": max_bytes,
            "max_bytes_frac": max_bytes_frac,
        },
        "sides": sides,
        "frontier": frontier,
    }

    if resume_check:
        storage = StorageConfig.ec_archival(scoring)
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "storage.npz")
            a = mk(storage).run(events, checkpoint_path=ck,
                                max_windows=kill_window + 2)  # mid-outage
            b = mk(storage).run(events, checkpoint_path=ck)
            resume_identical = (
                strip_seconds(a.records) + strip_seconds(b.records)
                == strip_seconds(results["ec_archival"].records)
                and bool(np.array_equal(b.rf, results["ec_archival"].rf)))
        out["kill_resume"] = {"killed_after_window": kill_window + 1,
                              "bit_identical": resume_identical}

    out["criteria"] = {
        "all_replicate_bit_identical": identical,
        "ec_zero_files_lost": sides["ec_archival"]["files_lost_max"] == 0,
        "rf4_zero_files_lost": sides["replicate"]["files_lost_max"] == 0,
        "ec_2x_fewer_archival_bytes": bool(ratio and ratio >= 2.0),
        "budget_respected": all(s["budget_respected"] for s in sides.values()),
        **({"ec_resume_bit_identical": out["kill_resume"]["bit_identical"]}
           if resume_check else {}),
    }
    return out


def storage_overhead(n_files: int = 8000, duration: float = 480.0,
                     window_seconds: float = 60.0, repeats: int = 9, device=None) -> dict:
    """Telemetry wall-clock ratio with STORAGE accounting on: the
    EC-Archival config, fault feed, durability accounting and repair
    planning on BOTH sides; the instrumented side also streams window
    records (with the ``storage`` digest), the ``storage.*`` gauges and the
    fault/durability/repair telemetry.  The schedule holds a rack-kill
    span, a partition and a straggler."""
    from .summary import TELEMETRY_OVERHEAD_BUDGET

    dev = resolve_device(device)
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=7, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=8))
    n_windows = int(duration // window_seconds)
    schedule = FaultSchedule.from_specs([
        f"crash:dn4@{n_windows // 3}-{2 * n_windows // 3}",
        f"partition:dn7+dn8@{n_windows // 4}-{n_windows // 2}",
        f"degrade:dn10@{n_windows // 2}-{3 * n_windows // 4}:0.5",
    ])
    scoring = min_rf2_scoring()

    def mk() -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            kmeans=KMeansConfig(k=8, seed=42), scoring=scoring,
            fault_schedule=FaultSchedule(schedule.events),
            topology=ClusterTopology.from_rack_spec(_NODES, _RACK_SPEC),
            storage=StorageConfig.ec_archival(scoring), device=dev)
        return ReplicationController(manifest, cfg)

    plain_times, instr_times, ratios = telemetry_rounds(mk, events, repeats)
    ratio = min(instr_times) / min(plain_times)
    return {
        "n_files": n_files,
        "windows_per_run": n_windows,
        "storage_config": "ec_archival",
        "plain_seconds": min(plain_times),
        "telemetry_seconds": min(instr_times),
        "plain_windows": plain_times,
        "telemetry_windows": instr_times,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.storage_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--overhead_out", default=DEFAULT_OVERHEAD_OUT)
    p.add_argument("--round", type=int, default=7, dest="round_no",
                   help="PR-round stamp for the regress history")
    p.add_argument("--n_files", type=int, default=400)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--duration", type=float, default=1800.0)
    p.add_argument("--windows", type=int, default=15)
    p.add_argument("--kill_window", type=int, default=5)
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--no_overhead", action="store_true",
                   help="skip the paired telemetry-overhead rounds")
    p.add_argument("--quick", action="store_true", help="small sizes for smoke runs (CI)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        out = run_storage_bench(n_files=160, seed=args.seed, duration=720.0, n_windows=8,
                                kill_window=4, k=8, device=dev)
    else:
        out = run_storage_bench(n_files=args.n_files, seed=args.seed,
                                duration=args.duration, n_windows=args.windows,
                                kill_window=args.kill_window, k=args.k, device=dev)
    out["round"] = args.round_no
    # Comparable metrics for the trajectory gate (regress bench_records):
    # the frontier ratio is deterministic per seed and bands tightly.
    out["bench_records"] = [
        bench_record("storage_ec_archival_bytes_ratio", out["frontier"]["archival_bytes_ratio"],
                     "x", dev),
    ]

    if not args.no_overhead:
        overhead = storage_overhead(device=dev)
        write_artifact(args.overhead_out, overhead, dev)
        out["criteria"]["overhead_within_budget"] = overhead["within_budget"]
        out["overhead"] = {k: overhead[k] for k in ("overhead_ratio", "budget", "within_budget")}

    write_artifact(args.out, out, dev)
    print(json.dumps({"out": args.out, **out["criteria"],
                      "archival_bytes_ratio": out["frontier"]["archival_bytes_ratio"],
                      "ec_repair_amplification": out["frontier"]["ec_repair_amplification"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
