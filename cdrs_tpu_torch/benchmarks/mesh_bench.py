"""Mesh-sharded control loop: decision identity, throughput by shard count,
the data = 1 overhead; the counterpart of
``cdrs_tpu/benchmarks/mesh_bench.py``.

The mesh (``parallel/mesh.py``) shards the per-window device computation —
Lloyd assignment + centroid update, scoring medians, the feature fold and
the drift detector's one Lloyd step — data-parallel over files, with one
shard-ordered sum of the (k, d + 1) statistics per iteration.  This bench
pins the three contracts that make the mesh a pure RUNTIME choice:

* **decision identity** — a controller run at ``mesh_shape={"data": N}``
  makes exactly the decisions of the one-device path on the same seed
  (assignments, category populations, plan hashes, migrations; drift
  scalars agree within 1e-5), on seeds 0/1/2, plus a checkpoint written at
  ``data=1`` resumed at ``data=N`` (mesh shape is not checkpoint state).
* **throughput per shard count** — Lloyd iterations a second at the
  config-2/config-3 SHAPES (d=32/k=128 and d=128/k=1024) over 1/2/4/8
  shards.  A CUDA mesh puts shard ``s`` on card ``s mod`` the card count,
  so the counts are not clipped to the cards: a scaling row needs as many
  cards as shards, and on one card the rows check the harness, not
  scaling.
* **data=1 overhead** — a config-2-shaped pass (Lloyd + classify + drift)
  on the one-device path against the mesh path at ``data=1``.  A 1 x 1 mesh
  in one process is the one-device path, so the ratio measures the
  dispatch and the drift step's route: host numpy ``detect_drift`` on the
  one-device side, the Lloyd kernel (``detect_drift_torch``, one row-major
  launch) on the mesh side.  Interleaved paired rounds, best-of-rounds.

Everything runs on ``device`` (CUDA unless ``--device cpu``).

    python -m cdrs_tpu_torch.benchmarks.mesh_bench [--quick] [--device cpu]

writes ``data/mesh_bench_torch.json`` and, outside ``--quick``, appends its
bench_records to the port's history (``regress.append_history``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from .common import bench_record, strip_seconds, write_artifact

__all__ = ["run_mesh_bench"]

DEFAULT_OUT = "data/mesh_bench_torch.json"

#: BASELINE config-2 / config-3 kernel shapes (benchmarks/harness.CONFIGS);
#: n is a bench parameter so the same shape runs at host-feasible scale.
_SHAPES = {"config2": (32, 128), "config3": (128, 1024)}

#: The decision view of a record: wall clock, the mesh stamp and the drift
#: scalars (compared within a tolerance) removed.
_NOT_DECISIONS = ("seconds", "mesh", "drift", "centroid_shift", "population_delta")

#: Largest drift difference between shapes that still counts as the same.
DRIFT_TOL = 1e-5


def _cards(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- throughput per shard count -----------------------------------------------

def _time_lloyd(x, k: int, init, mesh, iters: int, rounds: int) -> float:
    """Best-of-rounds wall seconds for ``iters`` fixed-trip Lloyd iterations
    (tol=0), warm (the first call, the kernels' build, excluded)."""
    from ..ops.kmeans import kmeans_full

    def once():
        kmeans_full(x, k, tol=0.0, seed=0, max_iter=iters, init_centroids=init,
                    mesh_shape=mesh)
        _sync(x.device)

    once()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        once()
        best = min(best, time.perf_counter() - t0)
    return best


def _points(n: int, d: int, k: int, seed: int, dev):
    """(X, init rows, X on ``dev``, the generator that drew them)."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d), dtype=np.float32)
    init = X[rng.choice(n, k, replace=False)].copy()
    return X, init, torch.from_numpy(X).to(dev), rng


def _throughput(shape_name: str, n: int, iters: int, rounds: int, device_counts: list[int],
                seed: int, dev) -> dict:
    from ..parallel.mesh import collective_bytes_estimate

    d, k = _SHAPES[shape_name]
    _, init, x, _ = _points(n, d, k, seed, dev)
    rows = []
    for ndev in device_counts:
        mesh = None if ndev == 1 else {"data": ndev}
        secs = _time_lloyd(x, k, init, mesh, iters, rounds)
        rows.append({"devices": ndev, "iters_per_sec": round(iters / secs, 3),
                     "seconds": round(secs, 4)})
    return {
        "shape": shape_name, "n": n, "d": d, "k": k, "iters": iters,
        "collective_bytes_per_iter_at_max": collective_bytes_estimate(k * (d + 1) * 4,
                                                                      device_counts[-1]),
        "per_device_count": rows,
    }


# -- decision identity --------------------------------------------------------

def _controller_scenario(seed: int):
    from ..config import GeneratorConfig, SimulatorConfig, validated_scoring_config
    from ..sim.access import simulate_access_with_shift
    from ..sim.generator import generate_population

    manifest = generate_population(GeneratorConfig(n_files=400, seed=seed))
    events, _ = simulate_access_with_shift(
        manifest, SimulatorConfig(duration_seconds=1200.0, seed=seed + 1), 600.0,
        {"hot": "archival", "archival": "hot"})
    # Histogram medians on both sides: integer count statistics, bitwise the
    # same at any mesh shape ("auto" resolves to the exact sort on one
    # device and to hist sharded).
    scoring = dataclasses.replace(validated_scoring_config(), median_method="hist")
    return manifest, events, scoring


def _controller_run(manifest, events, scoring, mesh, seed, checkpoint_path=None,
                    max_windows=None, device=None):
    from ..config import KMeansConfig
    from ..control.controller import ControllerConfig, ReplicationController

    cfg = ControllerConfig(window_seconds=100.0, drift_threshold=0.02,
                           kmeans=KMeansConfig(k=12, seed=42), scoring=scoring,
                           mesh_shape=mesh, default_rf=2, device=device)
    ctl = ReplicationController(manifest, cfg)
    return ctl.run(events, checkpoint_path=checkpoint_path, max_windows=max_windows)


def _decision_identity(seeds: list[int], ndev: int, device=None) -> dict:
    """Mesh-against-one-device controller equivalence + cross-shape resume."""
    dev = resolve_device(device)
    mesh = {"data": ndev}
    out: dict = {"seeds": [], "devices": ndev}
    all_ok = True
    for seed in seeds:
        manifest, events, scoring = _controller_scenario(seed)
        r1 = _controller_run(manifest, events, scoring, None, seed, device=dev)
        rN = _controller_run(manifest, events, scoring, mesh, seed, device=dev)
        # Both sides guarded for None: a divergent acceptance schedule must
        # surface as decisions_identical=false, not a TypeError.
        drift_diff = max((abs(a["drift"] - b["drift"]) for a, b in zip(r1.records, rN.records)
                          if a.get("drift") is not None and b.get("drift") is not None),
                         default=0.0)
        decisions_ok = (
            strip_seconds(r1.records, _NOT_DECISIONS) == strip_seconds(rN.records, _NOT_DECISIONS)
            and bool(np.array_equal(r1.rf, rN.rf))
            and bool(np.array_equal(r1.category_idx, rN.category_idx)))
        # Checkpoint portability: killed at data=1 mid-run, resumed at
        # data=N — decisions must stitch identically.
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "mesh.npz")
            a = _controller_run(manifest, events, scoring, None, seed, checkpoint_path=ck,
                                max_windows=6, device=dev)
            b = _controller_run(manifest, events, scoring, mesh, seed, checkpoint_path=ck,
                                device=dev)
            resume_ok = (
                strip_seconds(a.records, _NOT_DECISIONS) + strip_seconds(b.records,
                                                                         _NOT_DECISIONS)
                == strip_seconds(rN.records, _NOT_DECISIONS)
                and bool(np.array_equal(b.rf, rN.rf))
                and bool(np.array_equal(b.category_idx, rN.category_idx)))
        out["seeds"].append({
            "seed": seed,
            "windows": len(r1.records),
            "decisions_identical": bool(decisions_ok),
            "resume_across_shapes_identical": bool(resume_ok),
            "drift_score_max_diff": float(drift_diff),
        })
        all_ok = all_ok and decisions_ok and resume_ok and drift_diff < DRIFT_TOL
    out["ok"] = bool(all_ok)
    return out


# -- data=1 overhead ----------------------------------------------------------

def _overhead(n: int, iters: int, rounds: int, seed: int, device=None) -> dict:
    """One config-2-shaped pass (Lloyd + classify + drift) on the one-device
    path against the mesh path at data=1, interleaved paired rounds,
    best-of-rounds ratio."""
    from ..config import ScoringConfig
    from ..control.drift import detect_drift, detect_drift_torch
    from ..ops.kmeans import kmeans_full
    from ..ops.scoring import classify

    dev = resolve_device(device)
    d, k = _SHAPES["config2"]
    X, init, x, rng = _points(n, d, k, seed, dev)
    cat_idx = rng.integers(0, 4, k)
    frac = np.full(4, 0.25)
    # Scoring and drift run at the controller's 5-feature width (the score
    # tables are (C, 5)); Lloyd carries the full config-2 shape.  Global
    # medians from data: the stock table covers only the named 5 features.
    scoring = ScoringConfig(median_method="hist", compute_global_medians_from_data=True)
    X5 = np.ascontiguousarray(X[:, :5])
    x5 = x[:, :5].contiguous()
    init5 = np.ascontiguousarray(init[:, :5])

    def one_pass(mesh):
        _, labels, _, _ = kmeans_full(x, k, tol=0.0, seed=0, max_iter=iters,
                                      init_centroids=init, mesh_shape=mesh)
        classify(x5, labels, k, scoring, mesh_shape=mesh)
        if mesh is None:
            detect_drift(X5, init5, cat_idx, frac, 4)
        else:
            detect_drift_torch(x5, init5, cat_idx, frac, 4, mesh_shape=mesh)
        _sync(dev)

    one_pass(None)          # warm both sides
    one_pass({"data": 1})
    t = {"single": [], "mesh1": []}
    for r in range(rounds):
        order = (("single", None), ("mesh1", {"data": 1}))
        if r % 2:
            order = order[::-1]
        for name, mesh in order:
            t0 = time.perf_counter()
            one_pass(mesh)
            t[name].append(time.perf_counter() - t0)
    best_single = min(t["single"])
    best_mesh = min(t["mesh1"])
    return {
        "n": n, "d": d, "k": k, "iters": iters, "rounds": rounds,
        "seconds_single_device": round(best_single, 4),
        "seconds_mesh_data1": round(best_mesh, 4),
        "overhead_ratio": round(best_mesh / best_single, 4),
        "rounds_single_seconds": [round(v, 4) for v in t["single"]],
        "rounds_mesh_seconds": [round(v, 4) for v in t["mesh1"]],
        "methodology": "interleaved paired rounds, best-of-rounds ratio",
    }


# -- the bench ----------------------------------------------------------------

def run_mesh_bench(n2: int, n3: int, iters2: int, iters3: int, rounds: int,
                   device_counts: list[int], seeds: list[int], overhead_rounds: int,
                   seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    if not device_counts or min(device_counts) < 1:
        raise ValueError(f"shard counts must be >= 1, got {device_counts}")
    ndev_max = device_counts[-1]
    out: dict = {
        "torch_device": dev.type,
        "cards": _cards(dev),
        "device_counts": device_counts,
        "note": ("shard s runs on card s mod the card count, so the shard counts are not "
                 "clipped to the cards: a scaling row needs as many cards as shards, and on "
                 "one card (or the CPU) the rows check the harness, not scaling.  A 1 x 1 "
                 "mesh is the one-device path, so the data = 1 ratio measures the dispatch "
                 "and the drift step's route (host numpy against the Lloyd kernel)"),
    }
    out["throughput"] = [
        _throughput("config2", n2, iters2, rounds, device_counts, seed, dev),
        _throughput("config3", n3, iters3, rounds, device_counts, seed, dev),
    ]
    for t in out["throughput"]:
        print(json.dumps({"shape": t["shape"], "per_device_count": t["per_device_count"]}))
    out["decision_identity"] = _decision_identity(seeds, ndev_max, dev)
    print(json.dumps({"decision_identity_ok": out["decision_identity"]["ok"]}))
    # Full iteration budget for the overhead pass: each timed side must run
    # long enough that jitter does not swamp a 5% effect.
    out["overhead"] = _overhead(n2, iters2, overhead_rounds, seed, dev)
    print(json.dumps({"overhead_ratio": out["overhead"]["overhead_ratio"]}))

    ratio = out["overhead"]["overhead_ratio"]
    out["criteria"] = {
        "decision_identity_all_seeds": out["decision_identity"]["ok"],
        "data1_overhead_within_5pct": ratio <= 1.05,
    }
    # Only the throughput row feeds the trajectory ledger: the overhead
    # ratio's ideal is ~1.0 with jitter on both sides, a criterion.
    top2 = out["throughput"][0]["per_device_count"][-1]
    rec = bench_record(f"mesh_config2_iters_per_sec_d{top2['devices']}", top2["iters_per_sec"],
                       "iter/s", dev)
    rec["device_count"] = out["cards"]
    out["bench_records"] = [rec]
    return out


def main(argv=None) -> int:
    from .regress import (add_history_argument, append_history, extract_records,
                          resolve_history_path)

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.mesh_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--round", type=int, default=11, dest="round_no",
                   help="PR-round stamp for the regress history")
    add_history_argument(p)
    p.add_argument("--n2", type=int, default=262_144,
                   help="rows for the config-2 SHAPE (d=32, k=128)")
    p.add_argument("--n3", type=int, default=65_536,
                   help="rows for the config-3 SHAPE (d=128, k=1024)")
    p.add_argument("--iters2", type=int, default=8)
    p.add_argument("--iters3", type=int, default=4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--overhead_rounds", type=int, default=4)
    p.add_argument("--devices", default="1,2,4,8",
                   help="comma-separated shard counts (not clipped to the cards: shard s "
                        "runs on card s mod the card count)")
    p.add_argument("--seeds", default="0,1,2", help="decision-identity controller seeds")
    p.add_argument("--quick", action="store_true",
                   help="smoke sizes for CI: tiny shapes, 1 seed")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    counts = [int(x) for x in args.devices.split(",") if x]
    if args.quick:
        out = run_mesh_bench(n2=16_384, n3=4_096, iters2=3, iters3=2, rounds=2,
                             device_counts=counts, seeds=[0], overhead_rounds=2, device=dev)
    else:
        out = run_mesh_bench(n2=args.n2, n3=args.n3, iters2=args.iters2, iters3=args.iters3,
                             rounds=args.rounds, device_counts=counts,
                             seeds=[int(s) for s in args.seeds.split(",") if s],
                             overhead_rounds=args.overhead_rounds, device=dev)
    out["round"] = args.round_no

    write_artifact(args.out, out, dev)
    history = resolve_history_path(args)
    appended = 0
    if history:
        appended = append_history(history, extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"], "history_appended": appended}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
