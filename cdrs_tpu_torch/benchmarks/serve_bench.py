"""Serving-layer baselines: routed throughput, tail latency, hotspots; the
counterpart of ``cdrs_tpu/benchmarks/serve_bench.py``.  Four scenario
families, one artifact (``data/serve_bench_torch.json``):

**Batch routing throughput** (``run_throughput``): a config-2-scale
population (2^20 files on 16 nodes) with a skewed synthetic read stream,
routed in one batch per policy.  The acceptance line: >= 1M simulated
reads a second through the full router (selection + queue model +
percentiles) with no per-request Python.  The router is host numpy.

**Chaos tail latency** (``run_chaos_p99``): 8 nodes in 4 racks serving a
zipf-skewed stream while a rack partitions and a survivor straggles; every
policy routes the SAME windows, and power-of-two-choices must beat
random-replica on p99.

**Flash crowd** (``run_flash_crowd``): a transient read burst on a cohort
late in a controller run.  The cumulative fold dilutes the burst below the
drift threshold, so the drift-only controller never re-clusters; the
serve-enabled controller's hotspot detector fires the window the burst
lands and triggers the re-cluster, with the ``hotspot_recluster`` audit
flag as the trail.  The controllers fold and re-cluster on ``device``.

**Telemetry overhead** (``serve_overhead``): interleaved paired rounds with
the serving instrumentation on, against the 1.05x budget.

    python -m cdrs_tpu_torch.benchmarks.serve_bench [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..device import resolve_device
from ..serve import POLICIES, ReadRouter, ServeConfig
from ..sim.access import simulate_flash_crowd
from ..sim.generator import generate_population
from .common import bench_record, telemetry_rounds, write_artifact

__all__ = ["run_throughput", "run_chaos_p99", "run_flash_crowd", "serve_overhead"]

DEFAULT_OUT = "data/serve_bench_torch.json"


def _skewed_reads(n_files: int, n_reads: int, n_nodes: int, *,
                  span_seconds: float, seed: int, skew: float = 3.0):
    """(ts, pid, client) of a time-sorted, popularity-skewed read stream:
    pid ~ floor(n · u^skew) concentrates traffic on low ids (a zipf-ish
    head), the imbalance load-aware policies exist to absorb."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.random(n_reads) * span_seconds)
    pid = (n_files * rng.random(n_reads) ** skew).astype(np.int32)
    client = rng.integers(0, n_nodes, n_reads).astype(np.int32)
    return ts, pid, client


def _uniform_placement(n_files: int, nodes: tuple[str, ...], rf: int, seed: int = 0):
    """rf distinct replicas per file via place_replicas on a synthetic
    manifest (primary uniform over nodes)."""
    from ..cluster.placement import ClusterTopology, place_replicas

    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=nodes))
    return manifest, place_replicas(manifest, np.full(n_files, rf, dtype=np.int32),
                                    ClusterTopology(nodes=nodes), seed=seed)


def run_throughput(n_files: int = 1 << 20, n_reads: int = 4_000_000,
                   n_nodes: int = 16, rf: int = 3, seed: int = 21) -> dict:
    """Batch-mode routed reads/sec per policy at config-2 scale."""
    nodes = tuple(f"dn{i}" for i in range(1, n_nodes + 1))
    _, placement = _uniform_placement(n_files, nodes, rf, seed=seed)
    rm = placement.replica_map
    slot_ok = rm >= 0
    thr = np.ones(n_nodes)
    ts, pid, client = _skewed_reads(n_files, n_reads, n_nodes, span_seconds=60.0,
                                    seed=seed + 1)
    out: dict = {"n_files": n_files, "n_reads": n_reads, "n_nodes": n_nodes, "rf": rf,
                 "policies": {}}
    for policy in POLICIES:
        router = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=seed))
        t0 = time.perf_counter()
        res = router.route(rm, slot_ok, thr, ts=ts, pid=pid, client=client,
                           window_seconds=60.0)
        dt = time.perf_counter() - t0
        out["policies"][policy] = {
            "reads_per_sec": round(n_reads / dt, 1),
            "seconds": round(dt, 4),
            "p50_ms": round(res.p50_ms, 4),
            "p99_ms": round(res.p99_ms, 4),
            "utilization_max": round(res.utilization_max, 4),
        }
    out["best_reads_per_sec"] = max(p["reads_per_sec"] for p in out["policies"].values())
    return out


_CHAOS_NODES = tuple(f"dn{i}" for i in range(1, 9))
_CHAOS_RACKS = "r0=dn1,dn2;r1=dn3,dn4;r2=dn5,dn6;r3=dn7,dn8"


def run_chaos_p99(n_files: int = 20_000, n_windows: int = 10, window_seconds: float = 60.0,
                  reads_per_window: int = 150_000, rf: int = 3, service_ms: float = 1.0,
                  seed: int = 23) -> dict:
    """Per-policy p99 under a partition + straggler schedule: rack r1
    partitions over windows 3-5 and dn7 degrades to 0.4x over windows 2-7.
    Under random-replica the straggler's queue grows linearly (p50
    untouched, p99 explodes); p2c sees the queue through the load signal
    and routes around it.  Every policy routes the identical windows;
    per-policy p99 is over the merged latency samples of all windows."""
    from ..cluster.placement import ClusterTopology, place_replicas
    from ..faults import FaultSchedule
    from ..faults.state import ClusterState

    topology = ClusterTopology.from_rack_spec(_CHAOS_NODES, _CHAOS_RACKS)
    manifest = generate_population(
        GeneratorConfig(n_files=n_files, seed=seed, nodes=_CHAOS_NODES))
    placement = place_replicas(manifest, np.full(n_files, rf, dtype=np.int32), topology, seed=0)
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    schedule = FaultSchedule.from_specs(["partition:dn3+dn4@3-5", "degrade:dn7@2-7:0.4"])
    n_nodes = len(_CHAOS_NODES)
    windows = []
    for w in range(n_windows):
        ts, pid, client = _skewed_reads(n_files, reads_per_window, n_nodes,
                                        span_seconds=window_seconds, seed=seed + 100 + w)
        windows.append((ts + w * window_seconds, pid, client))

    out: dict = {
        "n_files": n_files, "n_windows": n_windows,
        "reads_per_window": reads_per_window, "rf": rf,
        "service_ms": service_ms,
        "nodes": list(_CHAOS_NODES), "racks": _CHAOS_RACKS,
        "schedule": [e.spec() for e in schedule],
        "policies": {},
    }
    for policy in POLICIES:
        state = ClusterState(placement, sizes)
        router = ReadRouter(n_nodes, ServeConfig(policy=policy, seed=seed,
                                                 service_ms=service_ms))
        samples: list[np.ndarray] = []
        unavail = 0
        per_window_p99 = []
        for w, (ts, pid, client) in enumerate(windows):
            for ev in schedule.for_window(w):
                state.apply_event(ev)
            res = router.route(state.replica_map, state.reachable_mask(),
                               state.node_throughput, ts=ts, pid=pid, client=client,
                               window_seconds=window_seconds,
                               rng=np.random.default_rng([seed, w]))
            samples.append(res.latency_ms)
            unavail += res.n_unavailable
            per_window_p99.append(round(res.p99_ms, 4))
        lat = np.concatenate(samples)
        out["policies"][policy] = {
            "p50_ms": round(float(np.percentile(lat, 50)), 4),
            "p95_ms": round(float(np.percentile(lat, 95)), 4),
            "p99_ms": round(float(np.percentile(lat, 99)), 4),
            "per_window_p99_ms": per_window_p99,
            "reads_unavailable": int(unavail),
        }
    out["p2c_beats_random_p99"] = (out["policies"]["p2c"]["p99_ms"]
                                   < out["policies"]["random"]["p99_ms"])
    return out


_FLASH_NODES = ("dn1", "dn2", "dn3", "dn4", "dn5")


def run_flash_crowd(n_files: int = 400, seed: int = 29, duration: float = 1800.0,
                    n_windows: int = 15, burst_windows: tuple[int, int] = (10, 10),
                    boost: float = 40.0, k: int = 12, hotspot_min_reads: int = 15,
                    drift_threshold: float = 0.10, device=None) -> dict:
    """Hotspot feedback vs drift-only on a flash crowd (module docstring).
    ``drift_threshold`` sits above the workload's drift noise band, so the
    drift-only controller sleeps through the burst while the hotspot path
    re-clusters the window it lands.  The burst's drift sits near that
    threshold (ROADMAP Queue C4): which side of it depends on the cold
    init."""
    from ..obs import JsonlSink, Telemetry, read_events

    dev = resolve_device(device)
    window_seconds = duration / n_windows
    manifest = generate_population(
        GeneratorConfig(n_files=n_files, seed=seed, nodes=_FLASH_NODES))
    cohort = np.asarray([c == "archival" for c in manifest.category])
    b0, b1 = burst_windows
    events, _ = simulate_flash_crowd(
        manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1),
        cohort=cohort, start=b0 * window_seconds,
        duration=(b1 - b0 + 1) * window_seconds, boost=boost)

    def mk(hotspot_feedback: bool) -> ReplicationController:
        cfg = ControllerConfig(
            window_seconds=window_seconds, default_rf=2,
            drift_threshold=drift_threshold,
            kmeans=KMeansConfig(k=k, seed=42),
            scoring=validated_scoring_config(),
            serve=ServeConfig(policy="p2c", seed=seed, hotspot_min_reads=hotspot_min_reads,
                              recluster_on_hotspot=hotspot_feedback),
            device=dev)
        return ReplicationController(manifest, cfg)

    # Drift-only side first: the burst stays under the drift threshold.
    plain = mk(hotspot_feedback=False).run(events)

    # Feedback side under telemetry: the audit stream carries the
    # hotspot_recluster flag.
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "serve.jsonl")
        with Telemetry(JsonlSink(path)):
            fed = mk(hotspot_feedback=True).run(events, metrics_path=path)
        stream = read_events(path)
    audit_flags = {int(e["window"]): e.get("flags", [])
                   for e in stream if e.get("kind") == "audit"}

    def window_digest(res):
        return [{
            "window": r["window"],
            "drift": None if r.get("drift") is None else round(r["drift"], 5),
            "recluster": r["recluster"],
            "trigger": r.get("recluster_trigger"),
            "hotspot_score": r.get("hotspot_score"),
            "hotspot_files": (r.get("hotspot_files") or [])[:4],
            "latency_p99_ms": r.get("latency_p99_ms"),
        } for r in res.records]

    burst_set = set(range(b0, n_windows))
    drift_reclusters = [r["window"] for r in plain.records
                        if r["recluster"] and r["window"] in burst_set]
    hotspot_reclusters = [r["window"] for r in fed.records
                          if r.get("recluster_trigger") == "hotspot"]
    burst_drift = [r.get("drift") for r in plain.records if r["window"] == b0]
    flagged = [w for w, flags in audit_flags.items() if "hotspot_recluster" in flags]
    return {
        "n_files": n_files, "n_windows": n_windows,
        "window_seconds": window_seconds,
        "burst_windows": list(burst_windows), "boost": boost,
        "cohort_files": int(cohort.sum()),
        "drift_threshold": drift_threshold,
        "drift_noise_band_max": max(
            (r["drift"] for r in plain.records
             if r.get("drift") is not None and r["window"] not in burst_set), default=None),
        "drift_at_burst": burst_drift[0] if burst_drift else None,
        "hotspot_score_at_burst": next(
            (r.get("hotspot_score") for r in fed.records if r["window"] == b0), None),
        "drift_only": {
            "reclusters_at_or_after_burst": drift_reclusters,
            "windows": window_digest(plain),
        },
        "hotspot_feedback": {
            "hotspot_reclusters": hotspot_reclusters,
            "audit_hotspot_flag_windows": flagged,
            "windows": window_digest(fed),
        },
        "hotspot_catches_what_drift_misses":
            bool(hotspot_reclusters) and not drift_reclusters
            and hotspot_reclusters[0] == b0
            and hotspot_reclusters[0] in flagged,
    }


def serve_overhead(n_files: int = 20_000, duration: float = 480.0,
                   window_seconds: float = 60.0, repeats: int = 9, device=None) -> dict:
    """Telemetry wall-clock ratio with SERVING instrumentation on: both
    sides run the serve-enabled controller (router + hotspot every window);
    the instrumented side also streams window records, serve gauges and
    counters and the per-window latency hist_bulk (capped by
    HIST_BULK_SAMPLE_CAP, so fixed per window whatever the read volume)."""
    from ..sim.access import simulate_access
    from .summary import TELEMETRY_OVERHEAD_BUDGET

    dev = resolve_device(device)
    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=7, nodes=_FLASH_NODES))
    events = simulate_access(manifest, SimulatorConfig(duration_seconds=duration, seed=8))

    def mk() -> ReplicationController:
        cfg = ControllerConfig(window_seconds=window_seconds, default_rf=2,
                               kmeans=KMeansConfig(k=8, seed=42),
                               scoring=validated_scoring_config(),
                               serve=ServeConfig(policy="p2c", seed=3), device=dev)
        return ReplicationController(manifest, cfg)

    plain_times, instr_times, ratios = telemetry_rounds(mk, events, repeats)
    ratio = min(instr_times) / min(plain_times)
    return {
        "n_files": n_files,
        "windows_per_run": int(duration // window_seconds),
        "plain_seconds": min(plain_times),
        "telemetry_seconds": min(instr_times),
        "paired_ratios": ratios,
        "paired_ratio_median": ratios[len(ratios) // 2],
        "overhead_ratio": ratio,
        "budget": TELEMETRY_OVERHEAD_BUDGET,
        "within_budget": ratio <= TELEMETRY_OVERHEAD_BUDGET,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.serve_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=6, dest="round_no",
                   help="PR-round stamp for the regress history (the filename carries no "
                        "rNN, so the artifact itself records which round produced it)")
    p.add_argument("--reads", type=int, default=4_000_000, help="batch-throughput read count")
    p.add_argument("--no_overhead", action="store_true",
                   help="skip the paired telemetry-overhead rounds")
    p.add_argument("--quick", action="store_true", help="small sizes for smoke runs (CI)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        throughput = run_throughput(n_files=1 << 16, n_reads=200_000)
        # Same utilization regime as the full run (the p2c-vs-random p99 gap
        # needs the straggler overloaded): fewer reads, slower disks.
        chaos = run_chaos_p99(n_files=4000, reads_per_window=60_000, n_windows=6,
                              service_ms=4.0)
        flash = run_flash_crowd(n_files=200, duration=900.0, n_windows=9,
                                burst_windows=(6, 6), k=8, device=dev)
    else:
        throughput = run_throughput(n_reads=args.reads)
        chaos = run_chaos_p99()
        flash = run_flash_crowd(device=dev)

    out: dict = {
        "round": args.round_no,
        "throughput": throughput,
        "chaos_p99": chaos,
        "flash_crowd": flash,
    }
    if not args.no_overhead:
        out["overhead"] = serve_overhead(device=dev)

    out["criteria"] = {
        "routed_1m_reads_per_sec": throughput["best_reads_per_sec"] >= 1_000_000,
        "p2c_beats_random_p99": chaos["p2c_beats_random_p99"],
        "hotspot_catches_what_drift_misses": flash["hotspot_catches_what_drift_misses"],
        **({"overhead_within_budget": out["overhead"]["within_budget"]}
           if not args.no_overhead else {}),
    }
    # Comparable metrics for the trajectory gate (regress bench_records).
    out["bench_records"] = [
        bench_record("serve_routed_reads_per_sec", throughput["best_reads_per_sec"],
                     "reads/s", dev),
        bench_record("serve_chaos_p99_ms_p2c", chaos["policies"]["p2c"]["p99_ms"], "ms", dev),
        bench_record("serve_chaos_p99_ms_random", chaos["policies"]["random"]["p99_ms"],
                     "ms", dev),
    ]

    write_artifact(args.out, out, dev)
    print(json.dumps({"out": args.out, **out["criteria"],
                      "best_reads_per_sec": throughput["best_reads_per_sec"],
                      "p99_p2c": chaos["policies"]["p2c"]["p99_ms"],
                      "p99_random": chaos["policies"]["random"]["p99_ms"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
