"""Functional placement vs the materialized map; the counterpart of
``cdrs_tpu/benchmarks/placement_bench.py``.

The claim is that the MAP, not the kernels, is the memory, checkpoint-size
and plan-diff bottleneck at 100M+ files.  This bench holds the functional
engine (``placement_fn``) against the materialized representation on four
observables:

* **recompute** — vectorized placement recompute throughput of
  ``compute_placement`` on one host core (target >= 50M placements/s flat),
  flat and rack-aware, against the legacy rng+argsort chooser
  materializing the same population;
* **checkpoint** — on-disk bytes and save seconds of a fault-damaged
  ClusterState snapshot: the dense ``(n_files, n_nodes)`` map and
  corruption mask against the functional exception overlay (target >= 20x
  smaller), and the resident placement-state bytes of each;
* **epoch_diff** — migration planning for one node decommissioned out of 12:
  hash-twice-and-compare (``EpochMap.diff``, removal-pruned) against
  materializing the new map with the legacy chooser and diffing (target
  >= 10x faster), the pruned diff checked against the full compare;
* **controller window** — a REAL ``ReplicationController`` window in
  functional placement mode (serve routing through the O(unique pids)
  resolver, Lloyd budget capped at 3 iterations) at 100M files: its fold,
  Lloyd (B1) and medians (B2's bisection past 2M rows) run on ``device``,
  the placement plane on the host.

Timing: interleaved paired rounds, best-of-rounds per side.

    python -m cdrs_tpu_torch.benchmarks.placement_bench [--quick] [--device cpu]

writes ``data/placement_bench_torch.json``; outside ``--quick`` the
bench_records are appended to the port's history (``regress.append_history``,
deduplicated).  ``--window_n`` sets the controller window's files (default:
2,000,000 with ``--quick``, else 100,000,000).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time

import numpy as np

from ..cluster.placement import ClusterTopology, place_replicas, primary_on_topology
from ..device import resolve_device
from ..placement_fn import EpochMap, FunctionalClusterState, compute_placement
from ..utils.checkpoint import save_state
from .common import bench_record, write_artifact

__all__ = ["run_placement_bench"]

DEFAULT_OUT = "data/placement_bench_torch.json"

_NODES12 = tuple(f"dn{i}" for i in range(1, 13))
_RACKS12 = {f"dn{i}": f"r{(i - 1) // 3}" for i in range(1, 13)}
_REMOVED = "dn5"


class _ArrayManifest:
    """Manifest duck type backed by arrays only — no per-file Python strings,
    which is what makes the 100M-file window constructible on one host.
    ``paths`` yields empty strings for the one consumer (FeatureTable
    construction) that lists it."""

    class _NullPaths:
        def __init__(self, n: int):
            self._n = n

        def __len__(self) -> int:
            return self._n

        def __iter__(self):
            return iter(itertools.repeat("", self._n))

    def __init__(self, n: int, nodes, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.nodes = list(nodes)
        self.primary_node_id = rng.integers(0, len(self.nodes), n).astype(np.int32)
        self.size_bytes = rng.integers(1 << 10, 1 << 20, n).astype(np.int64)
        self.creation_ts = np.full(n, 1.7e9) - rng.integers(0, 365 * 86400, n).astype(np.float64)
        self.paths = self._NullPaths(n)
        self.path_to_id = {"": -1}  # sentinel: already interned

    def __len__(self) -> int:
        return len(self.primary_node_id)


# -- recompute throughput ----------------------------------------------------

def _bench_recompute(n: int, rounds: int) -> dict:
    """Recompute throughput: uniform rf=3 flat and rack-aware, a mixed rf
    2..4 rack-aware row, and the legacy rng+argsort chooser materializing
    the same rf=3 population as the baseline."""
    rng = np.random.default_rng(3)
    fids = np.arange(n, dtype=np.int64)
    prim = rng.integers(0, 12, n).astype(np.int32)
    rf3 = np.full(n, 3, dtype=np.int32)
    rf_mixed = rng.integers(2, 5, n).astype(np.int32)
    flat = ClusterTopology(_NODES12)
    racked = ClusterTopology.from_racks(_NODES12, _RACKS12)
    man = _ArrayManifest(n, _NODES12, seed=3)
    man.primary_node_id = prim
    cases = {
        "flat": (flat, rf3, False),
        "racked": (racked, rf3, False),
        "racked_mixed": (racked, rf_mixed, False),
        "legacy_rng": (racked, rf3, True),
    }
    best: dict[str, float] = {k: float("inf") for k in cases}
    slots: dict[str, int] = {}
    for r in range(rounds):
        for case in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            topo, rf, legacy = cases[case]
            t0 = time.perf_counter()
            if legacy:
                place_replicas(man, rf, topo, seed=0, method="rng")
            else:
                _, rr = compute_placement(fids, rf, prim, topo, 0)
                slots[case] = int(rr.sum())
            best[case] = min(best[case], time.perf_counter() - t0)
    out = {"n_files": n, "rounds": rounds}
    for case in ("flat", "racked", "racked_mixed"):
        out[f"{case}_files_per_sec"] = round(n / best[case], 1)
        out[f"{case}_placements_per_sec"] = round(slots[case] / best[case], 1)
    out["legacy_rng_seconds"] = round(best["legacy_rng"], 4)
    out["racked_seconds"] = round(best["racked"], 4)
    out["recompute_vs_legacy_speedup"] = round(best["legacy_rng"] / best["racked"], 2)
    return out


# -- checkpoint bytes --------------------------------------------------------

def _damaged_state(n: int, sparse: bool) -> FunctionalClusterState:
    """A fault-damaged functional state (same base + same mutations on both
    representations).  ``sparse`` builds the overlay backend, what
    functional placement runs: no dense map is materialized at any point."""
    from ..faults import FaultEvent, RepairScheduler
    from ..placement_fn import OverlayClusterState

    topo = ClusterTopology.from_racks(_NODES12, _RACKS12)
    man = _ArrayManifest(n, _NODES12, seed=5)
    rng = np.random.default_rng(5)
    rf = rng.integers(2, 4, n).astype(np.int32)
    primary = primary_on_topology(man.nodes, man.primary_node_id, topo)
    if sparse:
        state = OverlayClusterState.from_base(topo, man.size_bytes, n_shards=rf,
                                              primary=primary, seed=0)
    else:
        placement = place_replicas(man, rf, topo, seed=0, method="hash")
        state = FunctionalClusterState(placement, man.size_bytes, primary=primary, seed=0,
                                       sparse_checkpoint=False)
    state.apply_event(FaultEvent(0, "crash", "dn4"))
    # One budgeted repair window: the retargets it admits are exactly the
    # exceptions the sparse snapshot must carry.
    sched = RepairScheduler(seed=0)
    rf64 = rf.astype(np.int64)
    sched.sync(state, rf64)
    sched.schedule(1, state, rf64, np.zeros(n, dtype=np.int64),
                   max_bytes=int(man.size_bytes.sum() * 0.0002), max_files=None)
    return state


def _bench_checkpoint(n: int) -> dict:
    """Checkpoint bytes AND resident placement-state bytes, dense vs
    overlay."""
    out: dict = {"n_files": n}
    # Overlay FIRST: peak RSS is monotonic, so its resident footprint must be
    # observed before the dense twin allocates its map.
    for label, sparse in (("sparse", True), ("dense", False)):
        state = _damaged_state(n, sparse)
        out[f"{label}_resident_mb"] = round(_state_resident_bytes(state) / 1e6, 1)
        if sparse:
            arrays = state.state_arrays(rf_hint=np.maximum(state.installed_shards, 1))
            out["exceptions"] = int(state.exception_fids().size)
        else:
            arrays = state.state_arrays()
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "state.npz")
            t0 = time.perf_counter()
            stats = save_state(path, arrays, {"bench": label})
            dt = time.perf_counter() - t0
        out[f"{label}_bytes"] = stats["bytes"]
        out[f"{label}_save_seconds"] = round(dt, 4)
        del state, arrays
    out["bytes_ratio"] = round(out["dense_bytes"] / max(out["sparse_bytes"], 1), 2)
    out["resident_ratio"] = round(out["dense_resident_mb"] / max(out["sparse_resident_mb"], 0.1),
                                  2)
    return out


def _state_resident_bytes(state) -> int:
    """Resident bytes of a ClusterState's PLACEMENT arrays (dense map and
    corruption mask when they exist as real arrays, count caches, overlay
    rows)."""
    total = 0
    for name in ("replica_map", "slot_corrupt"):
        arr = state.__dict__.get(name)   # properties don't count
        if arr is not None:
            total += arr.nbytes
    for name in ("_live_counts", "_reach_counts", "_dom_spread", "installed_shards",
                 "min_live", "ec_k"):
        arr = getattr(state, name, None)
        if arr is not None:
            total += arr.nbytes
    ov = getattr(state, "_ov", None)
    if ov:
        total += sum(r.nbytes for r in ov.values())
    return total


# -- epoch diff vs materialized plan diff ------------------------------------

def _bench_epoch_diff(n: int, rounds: int) -> dict:
    man = _ArrayManifest(n, _NODES12, seed=7)
    rng = np.random.default_rng(7)
    shards = rng.integers(2, 5, n).astype(np.int32)
    topo_old = ClusterTopology.from_racks(_NODES12, _RACKS12)
    survivors = tuple(x for x in _NODES12 if x != _REMOVED)
    topo_new = ClusterTopology.from_racks(
        survivors, {k: v for k, v in _RACKS12.items() if k != _REMOVED})
    emap = EpochMap(man.nodes, topo_old, seed=0)
    emap.advance(topo_new)

    # The materialized side's stored "current" map, built OUTSIDE timing (it
    # exists before the topology change).  Slot-set membership by per-row
    # sorting, so the compare is order-insensitive like the epoch diff's.
    old_map = place_replicas(man, shards, topo_old, seed=0).replica_map
    old_sorted = np.sort(old_map, axis=1)
    name_to_old = {nm: i for i, nm in enumerate(topo_old.nodes)}
    remap = np.asarray([name_to_old[x] for x in survivors] + [len(_NODES12)], dtype=np.int32)

    t_fn = t_mat = float("inf")
    moved_fn = moved_mat = 0
    for r in range(rounds):
        for side in (("fn", "mat") if r % 2 == 0 else ("mat", "fn")):
            t0 = time.perf_counter()
            if side == "fn":
                diff = emap.diff(0, 1, shards, man.primary_node_id)
                moved_fn = len(diff)
                t_fn = min(t_fn, time.perf_counter() - t0)
            else:
                new_map = place_replicas(man, shards, topo_new, seed=0).replica_map
                w = old_sorted.shape[1]
                new_ids = np.where(new_map >= 0, remap[np.clip(new_map, 0, None)], -1)
                if w > new_ids.shape[1]:
                    pad = np.full((n, w - new_ids.shape[1]), -1, dtype=np.int32)
                    new_ids = np.concatenate([new_ids, pad], axis=1)
                moved = (np.sort(new_ids, axis=1) != old_sorted).any(axis=1)
                moved_mat = int(moved.sum())
                np.flatnonzero(moved)  # the plan's work list
                t_mat = min(t_mat, time.perf_counter() - t0)
    # Prune correctness: the removal-pruned diff must equal the full
    # hash-twice compare.
    full = emap.diff(0, 1, shards, man.primary_node_id, prune=False)
    zero = emap.diff(0, 0, shards, man.primary_node_id)
    return {
        "n_files": n, "rounds": rounds, "removed_node": _REMOVED,
        "functional_seconds": round(t_fn, 4),
        "materialized_seconds": round(t_mat, 4),
        "speedup": round(t_mat / t_fn, 2),
        "moved_functional": moved_fn,
        "moved_materialized_rng": moved_mat,
        "moved_fraction": round(moved_fn / n, 4),
        "prune_matches_full": bool(np.array_equal(
            np.sort(full.moved),
            np.sort(emap.diff(0, 1, shards, man.primary_node_id).moved))),
        "same_epoch_zero_moves": len(zero) == 0,
    }


# -- the controller window ---------------------------------------------------

def _bench_window(n: int, n_reads: int, device=None) -> dict:
    import resource

    from ..config import KMeansConfig, validated_scoring_config
    from ..control.controller import ControllerConfig, ReplicationController
    from ..io.events import EventLog
    from ..serve import ServeConfig

    man = _ArrayManifest(n, _NODES12, seed=9)
    rng = np.random.default_rng(9)
    # One window of read traffic over a hot subset (zipf-ish head).
    pid = rng.integers(0, max(n // 50, 1), n_reads).astype(np.int32)
    ts = np.sort(rng.uniform(0.0, 60.0, n_reads))
    events = EventLog(ts=ts, path_id=pid, op=np.zeros(n_reads, dtype=np.int8),
                      client_id=rng.integers(0, 12, n_reads).astype(np.int32),
                      clients=list(man.nodes))
    cfg = ControllerConfig(
        window_seconds=60.0, default_rf=2, evaluate=False,
        placement_mode="functional",
        # Bounded Lloyd budget: the bench measures the placement plane.
        kmeans=KMeansConfig(k=8, seed=42, max_iter=3, tol=1e-3),
        scoring=validated_scoring_config(),
        serve=ServeConfig(policy="p2c"), device=device)
    ctl = ReplicationController(man, cfg)
    t0 = time.perf_counter()
    res = ctl.run(events, max_windows=1)
    dt = time.perf_counter() - t0
    rec = res.records[0]
    return {
        "n_files": n, "n_reads": n_reads,
        "completed": bool(len(res.records) == 1 and rec.get("recluster")
                          and rec.get("reads_routed", 0) > 0
                          and (rec.get("placement") or {}).get("mode") == "functional"),
        "seconds": round(dt, 2),
        "reads_routed": rec.get("reads_routed"),
        "serve_locality": rec.get("serve_locality"),
        "latency_p99_ms": rec.get("latency_p99_ms"),
        "plan_hash": rec.get("plan_hash"),
        "peak_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        "note": "real ReplicationController window, the port's fold, Lloyd and medians on "
                "the device, functional serve resolution, evaluate off, Lloyd budget capped "
                "at 3 iterations",
    }


def run_placement_bench(*, recompute_n: int, checkpoint_n: int, diff_n: int, window_n: int,
                        window_reads: int, rounds: int = 3, device=None) -> dict:
    dev = resolve_device(device)
    out: dict = {"methodology": "interleaved paired rounds, best-of-rounds"}
    out["recompute"] = _bench_recompute(recompute_n, rounds)
    print(json.dumps({"recompute_mplacements_per_sec": round(
        out["recompute"]["flat_placements_per_sec"] / 1e6, 1)}))
    out["checkpoint"] = _bench_checkpoint(checkpoint_n)
    print(json.dumps({"checkpoint_ratio": out["checkpoint"]["bytes_ratio"]}))
    out["epoch_diff"] = _bench_epoch_diff(diff_n, rounds)
    print(json.dumps({"epoch_diff_speedup": out["epoch_diff"]["speedup"]}))
    out["controller_window"] = _bench_window(window_n, window_reads, dev)
    print(json.dumps({"window_files": window_n,
                      "window_seconds": out["controller_window"]["seconds"]}))
    out["criteria"] = {
        "recompute_50m_placements_per_sec":
            out["recompute"]["flat_placements_per_sec"] >= 50e6,
        "checkpoint_20x_smaller": out["checkpoint"]["bytes_ratio"] >= 20.0,
        "epoch_diff_10x_faster": out["epoch_diff"]["speedup"] >= 10.0,
        "epoch_diff_prune_exact": out["epoch_diff"]["prune_matches_full"]
        and out["epoch_diff"]["same_epoch_zero_moves"],
        "window_completed": out["controller_window"]["completed"],
    }
    out["bench_records"] = [
        bench_record("placement_recompute_mplacements",
                     round(out["recompute"]["flat_placements_per_sec"] / 1e6, 2), "M/s", dev),
        bench_record("placement_checkpoint_ratio", out["checkpoint"]["bytes_ratio"], "x", dev),
        bench_record("placement_resident_ratio", out["checkpoint"]["resident_ratio"], "x", dev),
        bench_record("placement_epoch_diff_speedup", out["epoch_diff"]["speedup"], "x", dev),
        bench_record("placement_window_seconds", out["controller_window"]["seconds"], "s", dev),
    ]
    return out


def main(argv=None) -> int:
    from .regress import add_history_argument, append_history, extract_records, \
        resolve_history_path

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.placement_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=13, dest="round_no",
                   help="PR-round stamp for the regress history")
    add_history_argument(p)
    p.add_argument("--rounds", type=int, default=3, help="interleaved paired timing rounds")
    p.add_argument("--quick", action="store_true",
                   help="small scales for smoke runs (CI); never appends to the history")
    p.add_argument("--window_n", type=int, default=None,
                   help="files of the controller window (default 2,000,000 with --quick, "
                        "else 100,000,000)")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        out = run_placement_bench(recompute_n=1_000_000, checkpoint_n=200_000,
                                  diff_n=1_000_000, window_n=args.window_n or 2_000_000,
                                  window_reads=200_000, rounds=2, device=dev)
    else:
        out = run_placement_bench(recompute_n=10_000_000, checkpoint_n=10_000_000,
                                  diff_n=10_000_000, window_n=args.window_n or 100_000_000,
                                  window_reads=1_000_000, rounds=args.rounds, device=dev)
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
