"""Geo-hierarchical placement and elasticity; the counterpart of
``cdrs_tpu/benchmarks/geo_bench.py``.

* **region_loss** — kill a whole region (4 of 12 nodes, correlated) on the
  SAME workload seed under (a) the geo hierarchy and (b) the same racks
  without a region level: hierarchy-aware placement must end with ZERO lost
  files while flat placement loses some, for replicate (rf >= 2) and
  EC(6,3), in both the materialized (rng) and functional (hash) modes.
* **hier_throughput** — the hierarchical greedy chooser's recompute rate on
  the host (files/s and resolved placements/s) next to the flat chooser's.
* **black_friday** — the elastic loop end to end: flash crowd -> SLO-burn
  scale-out, rebalance traffic EXACTLY the addition-pruned epoch-diff moved
  set and inside the shared churn budget, drain back to baseline capacity.
* **wan_partition** — partition a region off the WAN with region-local cold
  stripes homed in it: stranded files (unreachable, not lost), stalled
  repairs, full heal after.  Its schedule is ROADMAP Queue C5's, whose
  verdict depends on the cold init.

The controllers fold and re-cluster on ``device`` (CUDA unless ``--device
cpu``); the chooser, faults and serving are host numpy.

    python -m cdrs_tpu_torch.benchmarks.geo_bench [--quick] [--device cpu]

writes ``data/geo_bench_torch.json``; outside ``--quick`` the bench_records
are appended to the port's history (``regress.append_history``,
deduplicated).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..cluster.placement import ClusterTopology
from ..config import GeneratorConfig, KMeansConfig, SimulatorConfig, validated_scoring_config
from ..control.controller import ControllerConfig, ReplicationController
from ..control.elastic import ElasticPolicy
from ..device import resolve_device
from ..faults import FaultSchedule
from ..placement_fn import compute_placement
from ..sim.access import simulate_access, simulate_flash_crowd
from ..sim.generator import generate_population
from ..storage import resolve_storage_config, storage_config_from_dict
from .common import bench_record, min_rf2_scoring, write_artifact

__all__ = ["run_geo_bench"]

DEFAULT_OUT = "data/geo_bench_torch.json"

_NODES12 = tuple(f"dn{i}" for i in range(1, 13))
_GEO = {
    "nodes": list(_NODES12),
    "levels": ["rack", "region"],
    "rack": {f"r{j}": [f"dn{2 * j + 1}", f"dn{2 * j + 2}"] for j in range(6)},
    "region": {"eu": ["r0", "r1"], "us": ["r2", "r3"], "ap": ["r4", "r5"]},
    "edge_bytes": {"rack": 1.0, "region": 4.0},
    "edge_latency": {"rack": 1.5, "region": 8.0},
}
_FLAT = {"nodes": list(_NODES12), "levels": ["rack"], "rack": _GEO["rack"]}
_EU = ("dn1", "dn2", "dn3", "dn4")


# -- region-loss contrast ----------------------------------------------------

def _region_loss_run(n_files: int, seed: int, topo_spec: dict, mode: str, ec: bool,
                     device) -> dict:
    man = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES12))
    events = simulate_access(man, SimulatorConfig(duration_seconds=1800.0, seed=seed + 1))
    if "region" in topo_spec["levels"]:
        specs = ["crash:region:eu@5-9"]
    else:
        specs = [f"crash:{n}@5-9" for n in _EU]
    scoring = min_rf2_scoring()
    cfg = ControllerConfig(
        window_seconds=120.0, default_rf=2, drift_threshold=0.02,
        max_bytes_per_window=int(np.asarray(man.size_bytes, np.int64).sum() * 0.25),
        kmeans=KMeansConfig(k=10, seed=42), scoring=scoring,
        topology=ClusterTopology.from_hierarchy(topo_spec),
        fault_schedule=FaultSchedule(FaultSchedule.from_specs(specs)),
        placement_mode=mode,
        storage=resolve_storage_config("ec_archival", scoring) if ec else None,
        device=device)
    t0 = time.perf_counter()
    res = ReplicationController(man, cfg).run(events)
    dur = [r["durability"] for r in res.records if r.get("durability")]
    return {
        "lost_max": int(max(d["lost"] for d in dur)),
        "lost_final": int(dur[-1]["lost"]),
        "under_replicated_final": int(dur[-1]["under_replicated"]),
        "repair_bytes_total": int(sum(r.get("repair_bytes", 0) for r in res.records)),
        "seconds": round(time.perf_counter() - t0, 2),
    }


def _bench_region_loss(n_files: int, seed: int, device=None) -> dict:
    out: dict = {"n_files": n_files, "seed": seed, "killed_region_nodes": list(_EU)}
    for strat in ("replicate", "ec"):
        for mode in ("materialized", "functional"):
            hier = _region_loss_run(n_files, seed, _GEO, mode, strat == "ec", device)
            flat = _region_loss_run(n_files, seed, _FLAT, mode, strat == "ec", device)
            out[f"{strat}_{mode}"] = {
                "lost_max_hier": hier["lost_max"],
                "lost_max_flat": flat["lost_max"],
                "lost_final_hier": hier["lost_final"],
                "seconds": hier["seconds"] + flat["seconds"],
            }
            print(json.dumps({"region_loss": f"{strat}/{mode}",
                              "lost_hier": hier["lost_max"], "lost_flat": flat["lost_max"]}))
    return out


# -- hierarchical chooser throughput -----------------------------------------

def _bench_hier_throughput(n: int, rounds: int) -> dict:
    rng = np.random.default_rng(3)
    fids = np.arange(n, dtype=np.int64)
    prim = rng.integers(0, 12, n).astype(np.int32)
    rf3 = np.full(n, 3, dtype=np.int32)
    geo = ClusterTopology.from_hierarchy(_GEO)
    flat = ClusterTopology(_NODES12)
    best = {"hier": float("inf"), "flat": float("inf")}
    slots = {}
    for r in range(rounds):
        for case in (("hier", "flat") if r % 2 == 0 else ("flat", "hier")):
            topo = geo if case == "hier" else flat
            t0 = time.perf_counter()
            _, rr = compute_placement(fids, rf3, prim, topo, 0)
            best[case] = min(best[case], time.perf_counter() - t0)
            slots[case] = int(rr.sum())
    return {
        "n_files": n, "rounds": rounds,
        "hier_files_per_sec": round(n / best["hier"], 1),
        "hier_placements_per_sec": round(slots["hier"] / best["hier"], 1),
        "flat_placements_per_sec": round(slots["flat"] / best["flat"], 1),
        "hier_vs_flat_cost": round(best["hier"] / best["flat"], 2),
    }


# -- black friday (elasticity) -----------------------------------------------

def _bench_black_friday(n_files: int, seed: int, device=None) -> dict:
    from ..serve import ServeConfig, SloSpec

    man = generate_population(GeneratorConfig(n_files=n_files, seed=seed))
    cohort = np.asarray([c == "hot" for c in man.category])
    events, _ = simulate_flash_crowd(
        man, SimulatorConfig(duration_seconds=1800.0, seed=seed + 1),
        cohort=cohort, start=450.0, duration=540.0, boost=25.0)
    pol = ElasticPolicy(pool=("sb1", "sb2", "sb3"), burn_hot=0.4, util_hot=0.9, hot_windows=2,
                        util_cool=0.5, cool_windows=2, drain_spacing=1)
    max_bytes = int(np.asarray(man.size_bytes, np.int64).sum() * 0.25)
    cfg = ControllerConfig(
        window_seconds=120.0, default_rf=2, drift_threshold=0.02,
        max_bytes_per_window=max_bytes,
        kmeans=KMeansConfig(k=8, seed=42),
        scoring=validated_scoring_config(),
        placement_mode="functional", elastic=pol,
        serve=ServeConfig(policy="p2c", service_ms=6.0, slo=SloSpec(target_ms=60.0)),
        device=device)
    t0 = time.perf_counter()
    res = ReplicationController(man, cfg).run(events)
    recs = res.records
    el = [r.get("elastic") or {} for r in recs]
    moved = sum(e.get("moved", 0) for e in el)
    rebal = sum(e.get("rebalanced", 0) for e in el)
    p99 = [r.get("latency_p99_ms") for r in recs]
    crowd_peak = max(p for p in p99 if p is not None)
    budget_ok = all(
        r.get("repair_bytes", 0) + r["bytes_migrated"]
        + (r.get("elastic") or {}).get("rebalance_bytes", 0) <= max_bytes for r in recs)
    return {
        "n_files": n_files, "seed": seed,
        "scaled_out_window": next((r["window"] for r, e in zip(recs, el) if "added" in e),
                                  None),
        "moved_set": int(moved),
        "rebalanced": int(rebal),
        "rebalance_equals_moved": moved == rebal and moved > 0,
        "rebalance_bytes": int(sum(e.get("rebalance_bytes", 0) for e in el)),
        "budget_conserved": bool(budget_ok),
        "p99_peak_ms": round(float(crowd_peak), 2),
        "p99_final_ms": round(float(p99[-1]), 3),
        "p99_recovery_x": round(float(crowd_peak) / float(p99[-1]), 1),
        "drained_back_to_baseline": bool(recs[-1]["durability"]["nodes_up"] == 3),
        "seconds": round(time.perf_counter() - t0, 2),
    }


# -- WAN partition (stranded != lost) ----------------------------------------

def _bench_wan_partition(n_files: int, seed: int, device=None) -> dict:
    man = generate_population(GeneratorConfig(n_files=n_files, seed=seed, nodes=_NODES12))
    events = simulate_access(man, SimulatorConfig(duration_seconds=1800.0, seed=seed + 1))
    scoring = min_rf2_scoring()
    cfg = ControllerConfig(
        window_seconds=120.0, default_rf=2, drift_threshold=0.02,
        max_bytes_per_window=int(np.asarray(man.size_bytes, np.int64).sum() * 0.25),
        kmeans=KMeansConfig(k=10, seed=42), scoring=scoring,
        topology=ClusterTopology.from_hierarchy(_GEO),
        fault_schedule=FaultSchedule(FaultSchedule.from_specs(["partition:region:eu@4-7"])),
        placement_mode="functional",
        storage=storage_config_from_dict(
            {"strategies": {"Archival": {"k": 2, "m": 1, "tier": "cold",
                                         "locality": "region"}}}),
        device=device)
    t0 = time.perf_counter()
    res = ReplicationController(man, cfg).run(events)
    dur = [r["durability"] for r in res.records if r.get("durability")]
    return {
        "n_files": n_files, "seed": seed,
        "stranded_peak": int(max(d.get("unreachable", 0) for d in dur)),
        "lost_while_stranded": int(max(d["lost"] for d in dur
                                       if d.get("unreachable", 0) > 0)),
        "stalled_repairs": int(sum(r.get("repair_deferred_partition", 0)
                                   for r in res.records)),
        "healed_final": bool(dur[-1].get("unreachable", 0) == 0
                             and dur[-1]["under_replicated"] == 0
                             and dur[-1]["lost"] == 0),
        "seconds": round(time.perf_counter() - t0, 2),
    }


def run_geo_bench(*, contrast_n: int, chooser_n: int, elastic_n: int, seed: int = 21,
                  rounds: int = 3, device=None) -> dict:
    dev = resolve_device(device)
    out: dict = {"methodology": "interleaved paired rounds, best-of-rounds "
                                "(chooser); single seeded runs (scenario benches)"}
    out["region_loss"] = _bench_region_loss(contrast_n, seed, dev)
    out["hier_throughput"] = _bench_hier_throughput(chooser_n, rounds)
    print(json.dumps({"hier_mplacements_per_sec": round(
        out["hier_throughput"]["hier_placements_per_sec"] / 1e6, 2)}))
    out["black_friday"] = _bench_black_friday(elastic_n, seed + 2, dev)
    print(json.dumps({"black_friday_p99_recovery": out["black_friday"]["p99_recovery_x"]}))
    out["wan_partition"] = _bench_wan_partition(contrast_n, seed + 1, dev)
    print(json.dumps({"wan_stranded_peak": out["wan_partition"]["stranded_peak"]}))
    rl = out["region_loss"]
    modes = ("replicate_materialized", "replicate_functional", "ec_materialized",
             "ec_functional")
    out["criteria"] = {
        "region_loss_zero_hier_all_modes": all(rl[k]["lost_max_hier"] == 0 for k in modes),
        "region_loss_positive_flat_all_modes": all(rl[k]["lost_max_flat"] > 0 for k in modes),
        "black_friday_rebalance_equals_moved": out["black_friday"]["rebalance_equals_moved"],
        "black_friday_budget_conserved": out["black_friday"]["budget_conserved"],
        "black_friday_drained": out["black_friday"]["drained_back_to_baseline"],
        "wan_stranded_not_lost": out["wan_partition"]["stranded_peak"] > 0
        and out["wan_partition"]["lost_while_stranded"] == 0,
        "wan_heal_converged": out["wan_partition"]["healed_final"],
    }
    out["bench_records"] = [
        bench_record("geo_regionloss_lost_flat_ec", float(rl["ec_functional"]["lost_max_flat"]),
                     "files", dev, direction="higher"),
        bench_record("geo_hier_mplacements",
                     round(out["hier_throughput"]["hier_placements_per_sec"] / 1e6, 2),
                     "M/s", dev),
        bench_record("geo_hier_vs_flat_cost", out["hier_throughput"]["hier_vs_flat_cost"],
                     "x", dev, direction="lower"),
        bench_record("geo_blackfriday_p99_recovery", out["black_friday"]["p99_recovery_x"],
                     "x", dev),
        bench_record("geo_blackfriday_rebalance_bytes",
                     float(out["black_friday"]["rebalance_bytes"]), "bytes", dev,
                     direction="lower"),
    ]
    return out


def main(argv=None) -> int:
    from .regress import add_history_argument, append_history, extract_records, \
        resolve_history_path

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.geo_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=14, dest="round_no",
                   help="PR-round stamp for the regress history")
    add_history_argument(p)
    p.add_argument("--rounds", type=int, default=3,
                   help="interleaved paired timing rounds (chooser)")
    p.add_argument("--quick", action="store_true",
                   help="small scales for smoke runs (CI); never appends to the history")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        out = run_geo_bench(contrast_n=300, chooser_n=500_000, elastic_n=200, rounds=2,
                            device=dev)
    else:
        out = run_geo_bench(contrast_n=400, chooser_n=10_000_000, elastic_n=300,
                            rounds=args.rounds, device=dev)
    out["round"] = args.round_no
    out["quick"] = bool(args.quick)

    write_artifact(args.out, out, dev)
    appended = 0
    if not args.quick:
        history = resolve_history_path(args)
        if history:
            appended = append_history(history,
                                      extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"], "history_appended": appended}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
