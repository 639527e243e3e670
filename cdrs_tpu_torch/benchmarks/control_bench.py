"""Controller-vs-batch benchmark: adaptation speed and churn under a shift,
the counterpart of ``cdrs_tpu/benchmarks/control_bench.py``.

Scenario: a seeded population serves a stationary workload, then mid-stream
a cohort's planted categories flip hot<->archival
(sim/access.simulate_access_with_shift).  Two strategies replay the same log
window by window:

* **controller** — the port's online loop (control/controller.py): carried
  decayed feature fold, drift-gated warm re-clusters, bounded-churn
  scheduling with hysteresis;
* **batch baseline** — every window recomputes features over ALL events so
  far (``features/batch.compute_features_torch``), re-clusters from a fresh
  init with the port's model, and applies the entire new plan at once (no
  budget, no hysteresis).

Both run on ``device`` (CUDA unless ``--device cpu``).  Reported per
strategy: **time-to-adapt** (windows after the shift until the majority of
the flipped cohort is planned into its new planted category) and
**cumulative bytes migrated** (size x added replicas; replica drops are
free).

    python -m cdrs_tpu_torch.benchmarks.control_bench [--device cpu]

writes ``data/control_bench_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..config import (CATEGORIES, PLANTED_TO_CATEGORY, GeneratorConfig, KMeansConfig,
                      SimulatorConfig, validated_scoring_config)
from ..control.controller import ControllerConfig, ReplicationController
from ..control.windows import iter_windows
from ..device import deterministic, resolve_device
from ..features.batch import compute_features_torch
from ..io.events import EventLog
from ..models.replication import ReplicationPolicyModel
from ..sim.access import simulate_access_with_shift
from ..sim.generator import generate_population
from .common import write_artifact

__all__ = ["run_control_bench"]

DEFAULT_OUT = "data/control_bench_torch.json"


def run_control_bench(
    n_files: int = 300,
    seed: int = 7,
    duration: float = 2400.0,
    n_windows: int = 20,
    k: int = 12,
    decay: float = 0.7,
    drift_threshold: float = 0.02,
    max_bytes_frac: float = 0.15,
    adapt_majority: float = 0.5,
    device=None,
) -> dict:
    """Run the shifted-workload scenario; returns the artifact dict."""
    dev = resolve_device(device)
    window_seconds = duration / n_windows
    shift_at = duration / 2.0
    shift_window = int(shift_at // window_seconds)

    manifest = generate_population(GeneratorConfig(n_files=n_files, seed=seed))
    flip = {"hot": "archival", "archival": "hot"}
    events, flipped = simulate_access_with_shift(
        manifest, SimulatorConfig(duration_seconds=duration, seed=seed + 1),
        shift_at=shift_at, category_flip=flip)

    # Ground truth for the flipped cohort AFTER the shift.
    target_idx = np.asarray([
        CATEGORIES.index(PLANTED_TO_CATEGORY[flip[c]]) if f else -1
        for c, f in zip(manifest.category, flipped)], dtype=np.int64)
    cohort = np.flatnonzero(flipped)

    def cohort_match(cat_per_file: np.ndarray) -> float:
        return float((np.asarray(cat_per_file)[cohort] == target_idx[cohort]).mean())

    scoring = validated_scoring_config()
    sizes = np.asarray(manifest.size_bytes, dtype=np.int64)
    # Churn budget: a fraction of the bytes one full uniform-rf=3 rollout
    # would move — a budget in the workload's own units.
    max_bytes = int(max_bytes_frac * float(sizes.sum()) * 2)

    # --- controller -------------------------------------------------------
    cfg = ControllerConfig(
        window_seconds=window_seconds, decay=decay,
        drift_threshold=drift_threshold, full_recluster_drift=0.30,
        hysteresis_windows=1, max_bytes_per_window=max_bytes,
        kmeans=KMeansConfig(k=k, seed=42), scoring=scoring, device=dev)
    ctl = ReplicationController(manifest, cfg)
    ctl_match, ctl_loc, ctl_bytes = [], [], []
    records = []
    t0 = time.perf_counter()
    with deterministic():
        for w, win in iter_windows(events, manifest, window_seconds):
            rec = ctl.process_window(w, win)
            records.append(rec)
            ctl_match.append(cohort_match(ctl.current_cat))
            ctl_loc.append(rec["locality_after"])
            ctl_bytes.append(rec["bytes_migrated"])
    ctl_seconds = time.perf_counter() - t0

    # --- batch baseline ---------------------------------------------------
    base_model = ReplicationPolicyModel(kmeans_cfg=KMeansConfig(k=k, seed=42),
                                        scoring_cfg=scoring)
    rf_vec = np.asarray(scoring.rf_vector(), dtype=np.int64)
    cur_rf = np.ones(n_files, dtype=np.int64)
    base_match, base_bytes = [], []
    seen: list[EventLog] = []
    t0 = time.perf_counter()
    with deterministic():
        for w, win in iter_windows(events, manifest, window_seconds):
            if len(win):
                seen.append(win)
            table = compute_features_torch(manifest, EventLog.concat(seen), device=dev)
            decision = base_model.run(table.norm)
            cat = np.asarray(decision.category_idx)[np.asarray(decision.labels)]
            new_rf = rf_vec[cat]
            base_bytes.append(int((sizes * np.maximum(new_rf - cur_rf, 0)).sum()))
            cur_rf = new_rf
            base_match.append(cohort_match(cat))
    base_seconds = time.perf_counter() - t0

    def adapt_at(match: list[float]) -> int | None:
        for w in range(shift_window, len(match)):
            if match[w] >= adapt_majority:
                return w - shift_window
        return None

    ctl_total = int(np.sum(ctl_bytes))
    base_total = int(np.sum(base_bytes))
    out = {
        "scenario": {
            "n_files": n_files, "seed": seed, "duration_seconds": duration,
            "window_seconds": window_seconds, "n_windows": n_windows,
            "shift_at": shift_at, "shift_window": shift_window,
            "category_flip": flip, "n_flipped": int(flipped.sum()),
            "k": k, "decay": decay, "drift_threshold": drift_threshold,
            "max_bytes_per_window": max_bytes,
            "adapt_majority": adapt_majority,
        },
        "controller": {
            "windows_to_adapt": adapt_at(ctl_match),
            "bytes_migrated_total": ctl_total,
            "bytes_migrated_per_window": [int(b) for b in ctl_bytes],
            "cohort_match_per_window": [round(m, 4) for m in ctl_match],
            "locality_per_window": [None if v is None else round(v, 4) for v in ctl_loc],
            "reclusters": sum(1 for r in records if r["recluster"]),
            "full_reclusters": sum(1 for r in records if r["recluster_mode"] == "full"),
            "seconds": round(ctl_seconds, 3),
        },
        "baseline": {
            "windows_to_adapt": adapt_at(base_match),
            "bytes_migrated_total": base_total,
            "bytes_migrated_per_window": base_bytes,
            "cohort_match_per_window": [round(m, 4) for m in base_match],
            "seconds": round(base_seconds, 3),
        },
    }
    out["criteria"] = {
        "controller_adapted": out["controller"]["windows_to_adapt"] is not None,
        "controller_fewer_bytes": ctl_total < base_total,
    }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.control_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--n_files", type=int, default=300)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--duration", type=float, default=2400.0)
    p.add_argument("--windows", type=int, default=20)
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--decay", type=float, default=0.7)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    out = run_control_bench(n_files=args.n_files, seed=args.seed, duration=args.duration,
                            n_windows=args.windows, k=args.k, decay=args.decay, device=dev)
    write_artifact(args.out, out, dev)
    print(json.dumps({"out": args.out, **out["criteria"],
                      "controller_bytes": out["controller"]["bytes_migrated_total"],
                      "baseline_bytes": out["baseline"]["bytes_migrated_total"],
                      "controller_adapt": out["controller"]["windows_to_adapt"],
                      "baseline_adapt": out["baseline"]["windows_to_adapt"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
