"""Integrity baselines: mean-time-to-detect vs scrub budget, and what rot
costs without scrubbing; the counterpart of
``cdrs_tpu/benchmarks/integrity_bench.py``.  Three scenario families over
the 5-node topology:

**MTTD vs scrub budget** (``run_mttd_sweep``): a silent-corruption event
rots every copy on one node mid-run; the background scrubber is the only
detector.  For each budget (fractions of the worst-case full-lap scan bytes)
the per-copy detection latency in windows must meet the budget-implied
bound: a round-robin scan spending ``B`` bytes a window over a population
whose lap costs at most ``L`` bytes touches every copy within
``ceil(L / B) + 1`` windows.

**Rot + kill overlap** (``run_overlap_bench``): rot lands at one window, a
node holding the clean second copies dies a few windows later.  Scrubbed
and verified reads: zero true losses, zero corrupt reads served.
Unscrubbed and unverified: garbage goes out on the read path and the kill
turns latent rot into permanent loss.  A mid-scrub kill/resume of the
scrubbed side must be bit-identical.

**Telemetry overhead** (``integrity_overhead``): interleaved paired rounds
with the corrupt fault, the scrubber and the integrity records on BOTH
sides, against the 1.05x budget.

The controllers fold and re-cluster on ``device`` (CUDA unless ``--device
cpu``); faults, scrub and the read path are host numpy.

    python -m cdrs_tpu_torch.benchmarks.integrity_bench [--quick] [--device cpu]

writes ``data/integrity_bench_torch.json``; outside ``--quick`` its
bench_record (the detection margin at the half-lap budget) is appended to
the port's history (``regress.append_history``, deduplicated on (round,
metric, platform)); ``--history ''`` disables it.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig
from ..control.controller import ControllerConfig, ReplicationController
from ..device import resolve_device
from ..faults import FaultSchedule, ScrubConfig
from ..sim.access import simulate_access
from ..sim.generator import generate_population
from .common import (bench_record, min_rf2_scoring, strip_seconds, telemetry_rounds,
                     write_artifact)

__all__ = ["run_mttd_sweep", "run_overlap_bench", "integrity_overhead"]

DEFAULT_OUT = "data/integrity_bench_torch.json"

_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5")


def _lap_upper_bytes(manifest, scoring, default_rf: int) -> int:
    """Worst-case bytes of one full scrub lap: every file at the largest
    rf the scoring table (or the default) can assign.  An upper bound, so
    the implied detection bound is conservative, never flattering."""
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    rf_max = max(max(scoring.replication_factors.values()), default_rf)
    return int(sizes.sum()) * rf_max


def run_mttd_sweep(
    n_files: int = 400,
    seed: int = 17,
    duration: float = 1800.0,
    n_windows: int = 15,
    corrupt_window: int = 2,
    k: int = 12,
    budget_fracs: tuple[float, ...] = (0.125, 0.25, 0.5),
    device=None,
) -> dict:
    """Detection latency vs scrub budget (module docstring)."""
    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    scoring = min_rf2_scoring(every_category=True)
    lap = _lap_upper_bytes(manifest, scoring, default_rf=2)
    schedule_specs = [f"corrupt:dn2@{corrupt_window}:1.0"]

    sweep = []
    for frac in budget_fracs:
        budget = max(int(lap * frac), 1)
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            hysteresis_windows=1, kmeans=KMeansConfig(k=k, seed=42),
            scoring=scoring,
            fault_schedule=FaultSchedule.from_specs(schedule_specs),
            scrub=ScrubConfig(bytes_per_window=budget), device=dev)
        res = ReplicationController(manifest, cfg).run(events)
        # Per-window detections: latency of a copy found at window w is
        # w - corrupt_window + 1 (the landing window's scrub pass counts as
        # one window of scanning).
        lat_counts: list[tuple[int, int]] = []
        for r in res.records:
            found = (r.get("scrub") or {}).get("corrupt_found", 0)
            if found:
                lat_counts.append((int(r["window"]) - corrupt_window + 1, found))
        detected = sum(c for _, c in lat_counts)
        integ = res.summary()["integrity"]
        bound = int(np.ceil(lap / budget)) + 1
        max_lat = max((lw for lw, _ in lat_counts), default=None)
        sweep.append({
            "budget_bytes_per_window": budget,
            "budget_lap_fraction": frac,
            "bound_windows": bound,
            "injected_detected": detected,
            "residual_corrupt_final": integ["corrupt_copies_final"],
            "true_lost_final": integ["true_lost_final"],
            "mttd_mean_windows": round(sum(lw * c for lw, c in lat_counts) / detected, 3)
            if detected else None,
            "mttd_max_windows": max_lat,
            "detected_within_bound":
                detected > 0 and integ["corrupt_copies_final"] == 0
                and max_lat is not None and max_lat <= bound,
            "scrub_bytes_total": integ["scrub_bytes_total"],
        })
    return {
        "scenario": {
            "n_files": n_files, "seed": seed, "nodes": list(_NODES),
            "duration_seconds": duration, "n_windows": n_windows,
            "window_seconds": window_seconds, "k": k,
            "corrupt": schedule_specs[0], "default_rf": 2,
            "lap_upper_bytes": lap,
            "replication_factors": scoring.replication_factors,
        },
        "sweep": sweep,
    }


def run_overlap_bench(
    n_files: int = 400,
    seed: int = 17,
    duration: float = 1800.0,
    n_windows: int = 15,
    corrupt_window: int = 2,
    kill_window: int = 6,
    k: int = 12,
    resume_check: bool = True,
    device=None,
) -> dict:
    """Rot + node-kill overlap, scrubbed vs unscrubbed (module docstring)."""
    from ..serve import ServeConfig, SloSpec

    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    scoring = min_rf2_scoring(every_category=True)
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    lap = _lap_upper_bytes(manifest, scoring, default_rf=2)
    specs = [f"corrupt:dn2@{corrupt_window}:1.0", f"crash:dn3@{kill_window}"]
    max_bytes = int(3 * float(sizes.sum()))  # repairs + scrub both fit

    def mk(scrub_on: bool, verify: bool) -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            max_bytes_per_window=max_bytes, hysteresis_windows=1,
            kmeans=KMeansConfig(k=k, seed=42), scoring=scoring,
            fault_schedule=FaultSchedule.from_specs(specs),
            serve=ServeConfig(policy="p2c", seed=0, service_ms=0.5,
                              slo=SloSpec(target_ms=10.0, availability=0.999),
                              verify_reads=verify),
            scrub=ScrubConfig(bytes_per_window=max(lap // 2, 1)) if scrub_on else None,
            device=dev)
        return ReplicationController(manifest, cfg)

    def side(scrub_on: bool, verify: bool) -> tuple[dict, object]:
        t0 = time.perf_counter()
        res = mk(scrub_on, verify).run(events)
        summ = res.summary()
        integ = summ["integrity"]
        timeline = [{
            "window": r["window"], "fault_events": r["fault_events"],
            "corrupt_copies": r["integrity"]["corrupt_copies"],
            "true_lost": r["integrity"]["true_lost"],
            "detected_scrub": r["integrity"]["detected_scrub"],
            "detected_read": r["integrity"]["detected_read"],
            "detected_repair": r["integrity"]["detected_repair"],
            "reads_corrupt_served": r.get("reads_corrupt_served") or 0,
            "lost_blind": r["durability"]["lost"],
            "repair_moves": r["repair_moves"],
        } for r in res.records]
        return {
            "timeline": timeline,
            "true_lost_final": integ["true_lost_final"],
            "true_lost_max": integ["true_lost_max"],
            "corrupt_reads_served": integ["corrupt_reads_served"],
            "detected_total": integ["detected_total"],
            "detected_scrub": integ["detected_scrub"],
            "detected_read": integ["detected_read"],
            "blind_lost_final": summ["durability"]["lost_final"],
            "run_seconds": round(time.perf_counter() - t0, 3),
        }, res

    scrubbed, sres = side(scrub_on=True, verify=True)
    unscrubbed, _ = side(scrub_on=False, verify=False)

    out: dict = {
        "scenario": {
            "n_files": n_files, "seed": seed, "nodes": list(_NODES),
            "duration_seconds": duration, "n_windows": n_windows,
            "window_seconds": window_seconds, "k": k,
            "schedule": specs, "default_rf": 2,
            "scrub_bytes_per_window": max(lap // 2, 1),
            "max_bytes_per_window": max_bytes,
            "replication_factors": scoring.replication_factors,
        },
        "scrubbed": scrubbed,
        "unscrubbed": unscrubbed,
    }

    if resume_check:
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "integrity.npz")
            a = mk(True, True).run(events, checkpoint_path=ck, max_windows=corrupt_window + 2)
            b = mk(True, True).run(events, checkpoint_path=ck)
            identical = (strip_seconds(a.records) + strip_seconds(b.records)
                         == strip_seconds(sres.records)
                         and bool(np.array_equal(b.rf, sres.rf))
                         and bool(np.array_equal(b.category_idx, sres.category_idx)))
        out["kill_resume"] = {"killed_after_window": corrupt_window + 1,
                              "bit_identical": identical}
    return out


def integrity_overhead(n_files: int = 8000, duration: float = 1440.0,
                       window_seconds: float = 60.0, repeats: int = 9, device=None) -> dict:
    """Telemetry wall-clock ratio with the INTEGRITY machinery on: both
    sides run the corrupt fault, the budgeted scrubber and per-window
    integrity records; the instrumented side also streams ``scrub.*`` and
    ``integrity.*`` counters and gauges, window records and audit events.
    24 windows keep each sample several seconds long."""
    from .summary import TELEMETRY_OVERHEAD_BUDGET

    dev = resolve_device(device)
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=7, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=8))
    n_windows = int(duration // window_seconds)
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    schedule = FaultSchedule.from_specs([
        f"corrupt:dn2@{max(n_windows // 3, 1)}:0.2",
        f"crash:dn4@{max(n_windows // 2, 2)}-{max(3 * n_windows // 4, 3)}",
    ])

    def mk() -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            kmeans=KMeansConfig(k=8, seed=42),
            scoring=min_rf2_scoring(every_category=True),
            fault_schedule=FaultSchedule(schedule.events),
            scrub=ScrubConfig(bytes_per_window=int(sizes.sum()) // 4), device=dev)
        return ReplicationController(manifest, cfg)

    plain_runs, instr_runs, ratios = telemetry_rounds(mk, events, repeats)
    ratio = min(instr_runs) / min(plain_runs)
    return {
        "n_files": n_files,
        "windows_per_run": n_windows,
        "plain_seconds": min(plain_runs),
        "telemetry_seconds": min(instr_runs),
        "plain_runs": plain_runs,
        "telemetry_runs": instr_runs,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def main(argv=None) -> int:
    from .regress import add_history_argument, append_history, extract_records, \
        resolve_history_path

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.integrity_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--n_files", type=int, default=400)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--duration", type=float, default=1800.0)
    p.add_argument("--windows", type=int, default=15)
    p.add_argument("--corrupt_window", type=int, default=2)
    p.add_argument("--kill_window", type=int, default=6)
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--round_no", type=int, default=9)
    add_history_argument(p)
    p.add_argument("--no_overhead", action="store_true",
                   help="skip the paired telemetry-overhead rounds")
    p.add_argument("--quick", action="store_true", help="small sizes for smoke runs (CI)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        kw = dict(n_files=160, seed=args.seed, duration=720.0, n_windows=8,
                  corrupt_window=2, k=8, device=dev)
        mttd = run_mttd_sweep(budget_fracs=(0.25, 0.5), **kw)
        overlap = run_overlap_bench(kill_window=4, **kw)
    else:
        kw = dict(n_files=args.n_files, seed=args.seed, duration=args.duration,
                  n_windows=args.windows, corrupt_window=args.corrupt_window, k=args.k,
                  device=dev)
        mttd = run_mttd_sweep(**kw)
        overlap = run_overlap_bench(kill_window=args.kill_window, **kw)

    # The half-lap budget's detection margin: bound / actual max latency
    # (>= 1 means the scan met its budget-implied bound).
    half = next(s for s in mttd["sweep"] if s["budget_lap_fraction"] == 0.5)
    margin = (half["bound_windows"] / half["mttd_max_windows"]
              if half["mttd_max_windows"] else None)

    out: dict = {
        "round": args.round_no,
        "mttd": mttd,
        "overlap": overlap,
        "criteria": {
            "all_detected_within_bound": all(s["detected_within_bound"] for s in mttd["sweep"]),
            "scrubbed_zero_files_lost": overlap["scrubbed"]["true_lost_final"] == 0,
            "scrubbed_zero_corrupt_reads": overlap["scrubbed"]["corrupt_reads_served"] == 0,
            "unscrubbed_serves_corrupt_reads":
                overlap["unscrubbed"]["corrupt_reads_served"] > 0,
            "unscrubbed_loses_files": overlap["unscrubbed"]["true_lost_final"] >= 1,
            **({"mid_scrub_resume_bit_identical": overlap["kill_resume"]["bit_identical"]}
               if "kill_resume" in overlap else {}),
        },
        "bench_records": [
            bench_record("integrity_mttd_margin_half_lap",
                         round(margin, 4) if margin else 0.0, "x", dev),
        ],
    }

    if not args.no_overhead:
        overhead = integrity_overhead(device=dev)
        out["overhead"] = overhead
        out["criteria"]["overhead_within_budget"] = overhead["within_budget"]

    write_artifact(args.out, out, dev)
    history = resolve_history_path(args)
    appended = 0
    if history:
        appended = append_history(history, extract_records(out, os.path.basename(args.out)))
    print(json.dumps({
        "out": args.out, **out["criteria"],
        "history_appended": appended,
        "mttd_margin_half_lap": out["bench_records"][0]["value"],
        "unscrubbed_true_lost": overlap["unscrubbed"]["true_lost_final"],
        "unscrubbed_corrupt_reads": overlap["unscrubbed"]["corrupt_reads_served"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
