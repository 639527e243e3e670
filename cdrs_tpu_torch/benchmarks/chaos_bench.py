"""Durability baselines: node kills, rack kills, partitions, stragglers; the
counterpart of ``cdrs_tpu/benchmarks/chaos_bench.py``.

**Kill one node** (``run_chaos_bench`` -> ``data/chaos_bench_torch.json``): a
stationary workload on a 5-node topology settles into its category plan,
then one node crashes at a fixed window and never returns.  The
fault-injected controller must re-replicate every under-replicated file
back to its target rf through the SAME per-window churn budget drift
migrations use.  Reported: windows to full re-replication, repair traffic
and per-window proof the budget held, zero files lost (min-rf-2 scoring
table), kill/resume bit-identity, and the telemetry-overhead ratio
(interleaved paired rounds, best window; the schedule adds a partition and
a straggler so the fault accounting is inside the measured loop).

**Rack kill + partition** (``run_rack_bench`` ->
``data/chaos_rack_bench_torch.json``): 6 nodes in 3 racks of 2.  (a) A whole
rack crashes for good: domain-aware placement keeps a replica of every
rf >= 2 file outside the dead rack (ZERO lost) while the flat policy loses
a measurable count on the same schedule.  (b) A rack-sized partition opens
and heals with a straggler degrading one survivor: reads behind it fail,
stranded repairs defer, and the run ends with zero lost and zero
correlated-risk files; a controller killed mid-partition resumes
bit-identically.

Every controller runs its fold and re-clusters on ``device`` (CUDA unless
``--device cpu``); faults, repairs and durability are host numpy.

    python -m cdrs_tpu_torch.benchmarks.chaos_bench [--device cpu]
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
from .common import min_rf2_scoring, strip_seconds, telemetry_rounds, write_artifact

__all__ = ["run_chaos_bench", "run_rack_bench", "chaos_overhead"]

DEFAULT_OUT = "data/chaos_bench_torch.json"
DEFAULT_RACK_OUT = "data/chaos_rack_bench_torch.json"

_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5")
#: Rack scenarios: 6 nodes in 3 racks of 2 — one rack is a minority the
#: cluster must survive losing outright.
_RACK_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5", "dn6")
_RACK_SPEC = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6"
_KILLED_RACK = ("dn3", "dn4")


def run_chaos_bench(
    n_files: int = 400,
    seed: int = 11,
    duration: float = 1800.0,
    n_windows: int = 15,
    kill_window: int = 6,
    k: int = 12,
    max_bytes_frac: float = 0.25,
    resume_check: bool = True,
    overhead: bool = True,
    overhead_repeats: int = 9,
    device=None,
) -> dict:
    """Run the kill-one-node scenario; returns the artifact dict."""
    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    scoring = min_rf2_scoring()
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    max_bytes = int(max_bytes_frac * float(sizes.sum()))
    schedule = FaultSchedule.from_specs([f"crash:dn2@{kill_window}"])

    def mk() -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            max_bytes_per_window=max_bytes, hysteresis_windows=1,
            kmeans=KMeansConfig(k=k, seed=42), scoring=scoring,
            fault_schedule=FaultSchedule(schedule.events), device=dev)
        return ReplicationController(manifest, cfg)

    t0 = time.perf_counter()
    res = mk().run(events)
    run_seconds = time.perf_counter() - t0

    timeline = []
    recover_at = None
    for r in res.records:
        d = r["durability"]
        degraded = d["lost"] + d["at_risk"] + d["under_replicated"]
        timeline.append({
            "window": r["window"], "fault_events": r["fault_events"],
            "nodes_up": d["nodes_up"], "lost": d["lost"],
            "at_risk": d["at_risk"],
            "under_replicated": d["under_replicated"],
            "repair_moves": r["repair_moves"],
            "repair_bytes": r["repair_bytes"],
            "repair_backlog": r["repair_backlog"],
            "bytes_migrated": r["bytes_migrated"],
            "locality_after": None if r["locality_after"] is None
            else round(r["locality_after"], 4),
        })
        if r["window"] >= kill_window and degraded == 0 and recover_at is None:
            recover_at = r["window"]
    lost_max = max(t["lost"] for t in timeline)
    budget_ok = all(t["repair_bytes"] + t["bytes_migrated"] <= max_bytes for t in timeline)

    out: dict = {
        "scenario": {
            "n_files": n_files, "seed": seed, "nodes": list(_NODES),
            "duration_seconds": duration, "n_windows": n_windows,
            "window_seconds": window_seconds, "k": k,
            "kill": f"dn2@{kill_window}", "default_rf": 2,
            "replication_factors": scoring.replication_factors,
            "max_bytes_per_window": max_bytes,
            "max_bytes_frac": max_bytes_frac,
        },
        "timeline": timeline,
        "recovery": {
            "windows_to_full_re_replication":
                None if recover_at is None else recover_at - kill_window,
            "files_lost_max": lost_max,
            "repair_bytes_total": int(sum(t["repair_bytes"] for t in timeline)),
            "repair_moves_total": int(sum(t["repair_moves"] for t in timeline)),
            "unavailable_reads": res.summary()["durability"]["unavailable_reads"],
            "run_seconds": round(run_seconds, 3),
        },
    }

    if resume_check:
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "chaos.npz")
            a = mk().run(events, checkpoint_path=ck,
                         max_windows=kill_window + 2)  # killed mid-outage
            b = mk().run(events, checkpoint_path=ck)
            identical = (strip_seconds(a.records) + strip_seconds(b.records)
                         == strip_seconds(res.records)
                         and bool(np.array_equal(b.rf, res.rf))
                         and bool(np.array_equal(b.category_idx, res.category_idx)))
        out["kill_resume"] = {"killed_after_window": kill_window + 1,
                              "bit_identical": identical}

    if overhead:
        out["overhead"] = chaos_overhead(repeats=overhead_repeats, device=dev)

    out["criteria"] = {
        "recovered_within_run": recover_at is not None,
        "zero_files_lost": lost_max == 0,
        "budget_respected": budget_ok,
        **({"kill_resume_bit_identical": out["kill_resume"]["bit_identical"]}
           if resume_check else {}),
        **({"overhead_within_budget": out["overhead"]["within_budget"]}
           if overhead else {}),
    }
    return out


def _durability_timeline(records: list[dict]) -> list[dict]:
    """Per-window durability/repair digest for the artifact timelines."""
    out = []
    for r in records:
        d = r["durability"]
        out.append({
            "window": r["window"], "fault_events": r["fault_events"],
            "nodes_up": d["nodes_up"],
            "nodes_partitioned": d.get("nodes_partitioned", 0),
            "lost": d["lost"], "unreachable": d.get("unreachable", 0),
            "at_risk": d["at_risk"],
            "under_replicated": d["under_replicated"],
            "correlated_risk": d.get("correlated_risk", 0),
            "repair_moves": r["repair_moves"],
            "repair_bytes": r["repair_bytes"],
            "repair_bytes_copied": r.get("repair_bytes_copied", 0),
            "repair_rebalanced": r.get("repair_rebalanced", 0),
            "repair_deferred_partition": r.get("repair_deferred_partition", 0),
            "repair_backlog": r["repair_backlog"],
            "bytes_migrated": r["bytes_migrated"],
            "unavailable_reads": r.get("unavailable_reads", 0),
        })
    return out


def run_rack_bench(
    n_files: int = 400,
    seed: int = 13,
    duration: float = 1800.0,
    n_windows: int = 15,
    kill_window: int = 5,
    partition_windows: tuple[int, int] = (4, 7),
    degrade_factor: float = 0.25,
    k: int = 12,
    max_bytes_frac: float = 0.25,
    resume_check: bool = True,
    device=None,
) -> dict:
    """Rack-kill + rack-partition scenarios (module docstring); returns
    the rack artifact dict."""
    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(
        GeneratorConfig(n_files=n_files, seed=seed, nodes=_RACK_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1))
    scoring = min_rf2_scoring()
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    max_bytes = int(max_bytes_frac * float(sizes.sum()))
    racked = ClusterTopology.from_rack_spec(_RACK_NODES, _RACK_SPEC)

    def mk(schedule: FaultSchedule, topology=None) -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            max_bytes_per_window=max_bytes, hysteresis_windows=1,
            kmeans=KMeansConfig(k=k, seed=42), scoring=scoring,
            fault_schedule=FaultSchedule(schedule.events),
            topology=topology, device=dev)
        return ReplicationController(manifest, cfg)

    # -- (a) whole-rack kill: domain-aware vs flat placement ---------------
    kill = FaultSchedule.from_specs([f"crash:{n}@{kill_window}" for n in _KILLED_RACK])
    sides = {}
    for name, topo in (("domain_aware", racked), ("flat", None)):
        res = mk(kill, topo).run(events)
        timeline = _durability_timeline(res.records)
        recover_at = next(
            (t["window"] for t in timeline
             if t["window"] >= kill_window
             and t["lost"] + t["at_risk"] + t["under_replicated"] == 0),
            None)
        sides[name] = {
            "timeline": timeline,
            "files_lost_max": max(t["lost"] for t in timeline),
            "files_lost_final": timeline[-1]["lost"],
            "correlated_risk_final": timeline[-1]["correlated_risk"],
            "windows_to_full_re_replication":
                None if recover_at is None else recover_at - kill_window,
            "repair_bytes_total": int(sum(t["repair_bytes"] for t in timeline)),
            "budget_respected": all(
                t["repair_bytes"] + t["bytes_migrated"] <= max_bytes for t in timeline),
        }

    # -- (b) rack partition that heals + straggler survivor ---------------
    p0, p1 = partition_windows
    part = FaultSchedule.from_specs([
        f"partition:{'+'.join(_KILLED_RACK)}@{p0}-{p1}",
        f"degrade:dn5@{p0}-{p1}:{degrade_factor:g}",
    ])
    pres = mk(part, racked).run(events)
    ptimeline = _durability_timeline(pres.records)
    psum = pres.summary()["durability"]
    partition_out: dict = {
        "schedule": [e.spec() for e in part],
        "timeline": ptimeline,
        "files_lost_max": max(t["lost"] for t in ptimeline),
        "unreachable_max": max(t["unreachable"] for t in ptimeline),
        "stalled_repairs": psum["partition_stalled_repairs"],
        "unavailable_reads": psum["unavailable_reads"],
        "lost_final": psum["lost_final"],
        "unreachable_final": psum["unreachable_final"],
        "correlated_risk_final": psum["correlated_risk_final"],
        "under_replicated_final": psum["under_replicated_final"],
        "budget_respected": all(
            t["repair_bytes"] + t["bytes_migrated"] <= max_bytes for t in ptimeline),
    }
    if resume_check:
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "rack.npz")
            a = mk(part, racked).run(events, checkpoint_path=ck,
                                     max_windows=p0 + 2)  # mid-partition
            b = mk(part, racked).run(events, checkpoint_path=ck)
            identical = (strip_seconds(a.records) + strip_seconds(b.records)
                         == strip_seconds(pres.records)
                         and bool(np.array_equal(b.rf, pres.rf)))
        partition_out["kill_resume"] = {"killed_after_window": p0 + 1,
                                        "bit_identical": identical}

    return {
        "scenario": {
            "n_files": n_files, "seed": seed, "nodes": list(_RACK_NODES),
            "racks": _RACK_SPEC, "killed_rack": list(_KILLED_RACK),
            "duration_seconds": duration, "n_windows": n_windows,
            "window_seconds": window_seconds, "k": k,
            "kill_window": kill_window,
            "partition_windows": list(partition_windows),
            "degrade": f"dn5@{p0}-{p1}:{degrade_factor:g}",
            "default_rf": 2,
            "replication_factors": scoring.replication_factors,
            "max_bytes_per_window": max_bytes,
            "max_bytes_frac": max_bytes_frac,
        },
        "rack_kill": sides,
        "rack_partition": partition_out,
        "criteria": {
            "domain_aware_zero_lost": sides["domain_aware"]["files_lost_max"] == 0,
            "flat_loses_files": sides["flat"]["files_lost_max"] > 0,
            "domain_recovered_within_run":
                sides["domain_aware"]["windows_to_full_re_replication"] is not None,
            "partition_heals_clean":
                partition_out["lost_final"] == 0
                and partition_out["unreachable_final"] == 0
                and partition_out["correlated_risk_final"] == 0,
            "budget_respected":
                sides["domain_aware"]["budget_respected"]
                and partition_out["budget_respected"],
            **({"partition_resume_bit_identical":
                partition_out["kill_resume"]["bit_identical"]}
               if resume_check else {}),
        },
    }


def chaos_overhead(n_files: int = 8000, duration: float = 480.0,
                   window_seconds: float = 60.0, repeats: int = 9, device=None) -> dict:
    """Telemetry wall-clock ratio on the FAULT-MODE controller path: the
    fault feed, durability accounting and repair planning run on BOTH
    sides; the instrumented side also streams window records, fault/
    durability/repair counters and gauges and audit events through the
    sink.  The schedule holds a crash span, a partition and a straggler."""
    from .summary import TELEMETRY_OVERHEAD_BUDGET

    dev = resolve_device(device)
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=7, nodes=_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=8))
    n_windows = int(duration // window_seconds)
    schedule = FaultSchedule.from_specs([
        f"crash:dn2@{n_windows // 3}-{2 * n_windows // 3}",
        f"partition:dn4@{n_windows // 4}-{n_windows // 2}",
        f"degrade:dn5@{n_windows // 2}-{3 * n_windows // 4}:0.5",
    ])

    def mk() -> ReplicationController:
        cfg = ControllerConfig(window_seconds=window_seconds, default_rf=2,
                               kmeans=KMeansConfig(k=8, seed=42),
                               scoring=min_rf2_scoring(),
                               fault_schedule=FaultSchedule(schedule.events), device=dev)
        return ReplicationController(manifest, cfg)

    plain_windows, instr_windows, ratios = telemetry_rounds(mk, events, repeats)
    ratio = min(instr_windows) / min(plain_windows)
    return {
        "n_files": n_files,
        "windows_per_run": n_windows,
        "plain_seconds": min(plain_windows),
        "telemetry_seconds": min(instr_windows),
        "plain_windows": plain_windows,
        "telemetry_windows": instr_windows,
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.chaos_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--rack_out", default=DEFAULT_RACK_OUT)
    p.add_argument("--n_files", type=int, default=400)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--duration", type=float, default=1800.0)
    p.add_argument("--windows", type=int, default=15)
    p.add_argument("--kill_window", type=int, default=6)
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--no_overhead", action="store_true",
                   help="skip the paired telemetry-overhead rounds")
    p.add_argument("--scenario", choices=["kill", "rack", "all"], default="all",
                   help=f"kill = one-node crash ({DEFAULT_OUT}); rack = rack kill + "
                        f"partition ({DEFAULT_RACK_OUT})")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    summary: dict = {}
    if args.scenario in ("kill", "all"):
        out = run_chaos_bench(n_files=args.n_files, seed=args.seed,
                              duration=args.duration, n_windows=args.windows,
                              kill_window=args.kill_window, k=args.k,
                              overhead=not args.no_overhead, device=dev)
        write_artifact(args.out, out, dev)
        summary.update({"out": args.out, **out["criteria"],
                        "windows_to_full_re_replication":
                            out["recovery"]["windows_to_full_re_replication"],
                        "repair_bytes_total": out["recovery"]["repair_bytes_total"]})
    if args.scenario in ("rack", "all"):
        rack = run_rack_bench(n_files=args.n_files, seed=args.seed + 2,
                              duration=args.duration, n_windows=args.windows, k=args.k,
                              device=dev)
        write_artifact(args.rack_out, rack, dev)
        # Prefix the rack criteria: both scenarios define budget_respected,
        # and the rack value must not shadow the kill scenario's.
        summary.update({
            "rack_out": args.rack_out,
            **{f"rack_{k}": v for k, v in rack["criteria"].items()},
            "flat_files_lost_max": rack["rack_kill"]["flat"]["files_lost_max"],
        })
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
