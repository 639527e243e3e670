"""D² against k-means|| init quality on the port's own inits, the
counterpart of ``cdrs_tpu/benchmarks/init_quality.py``.

The D² init is k sequential rounds; k-means|| does the job in 5
oversampling rounds.  Choosing between them needs evidence that quality
holds: this module sweeps both inits across seeds at the BASELINE
config-2/3 shapes and records **final inertia** (what Lloyd minimizes)
and **planted-category accuracy** through the whole decision pipeline.
The inits are the port's (``ops/kmeans``, seeded ``torch.Generator``s),
so the numbers are the port's, not the reference's.

    python -m cdrs_tpu_torch.benchmarks.init_quality [--small] [--out FILE]

(the card makes the full shapes fast; ``--small`` runs reduced ones).

``--carry_witness`` asks instead whether the card's planted accuracy at
100,000 files differs from the CPU's by its init alone: for seeds 21 on,
the pipeline on the CPU, on the card from its own D² init and on the card
from the CPU's D² init (``carry_witness``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

__all__ = ["run_init_quality", "carry_witness"]

#: The default output files: the port's own, beside the reference's records.
DEFAULT_OUT = "data/init_quality_torch.json"
WITNESS_OUT = "data/init_carry_witness_torch.json"


def _inertia(X, centroids, labels, chunk: int = 131_072) -> float:
    """sum ||x_i - c[lab_i]||^2 over rows with a label >= 0, in float64,
    ``chunk`` rows at a time so no (n, d) temporary of the whole matrix is
    made."""
    import torch

    c = torch.as_tensor(centroids).to(device=X.device, dtype=torch.float32)
    lab = torch.as_tensor(labels).to(X.device).long()
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for i in range(0, X.shape[0], chunk):
        lc = lab[i:i + chunk]
        diff = X[i:i + chunk].float() - c[lc.clamp(min=0)]
        total += torch.where((lc >= 0)[:, None], diff * diff, 0.0).sum(dtype=torch.float64)
    return float(total)


def _sweep_shape(n: int, d: int, k: int, seeds, max_iter: int,
                 methods=("d2", "kmeans||"), device=None) -> dict:
    from ..device import resolve_device
    from ..ops.kmeans import kmeans_full
    from .harness import _sync, _synth_blobs_device

    dev = resolve_device(device)
    out: dict = {"n": n, "d": d, "k": k, "max_iter": max_iter, "seeds": list(seeds)}
    for method in methods:
        inertias, iters, secs = [], [], []
        for seed in seeds:
            X = _synth_blobs_device(n, d, min(k, 64), seed, "float32", dev)
            _sync(dev)
            t0 = time.perf_counter()
            c, lab, it, _ = kmeans_full(X, k, seed=seed, max_iter=max_iter, tol=1e-4,
                                        init_method=method)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            inertias.append(_inertia(X, c, lab))
            iters.append(int(it))
        out[method] = {
            "inertia_per_seed": inertias,
            "inertia_mean": float(np.mean(inertias)),
            "inertia_std": float(np.std(inertias)),
            "n_iter_per_seed": iters,
            "wall_seconds_per_seed": secs,
        }
    if all(m in out for m in ("d2", "kmeans||")):
        out["inertia_ratio_kmeans_par_over_d2"] = (
            out["kmeans||"]["inertia_mean"] / out["d2"]["inertia_mean"])
    return out


def run_init_quality(small: bool = False, n_seeds: int = 5, device=None) -> dict:
    """The whole gate: inertia sweeps at configs 2/3 and pipeline accuracy."""
    from ..device import device_name, resolve_device
    from .harness import _quality_one

    seeds = list(range(n_seeds))
    shapes = ([(131_072, 32, 128, 30), (262_144, 128, 1024, 10)] if small else
              [(1_048_576, 32, 128, 30), (10_485_760, 128, 1024, 10)])
    result: dict = {"small": small, "device_name": device_name(resolve_device(device)),
                    "shapes": []}
    for n, d, k, max_iter in shapes:
        result["shapes"].append(_sweep_shape(n, d, k, seeds, max_iter, device=device))

    # Decision quality through the whole pipeline: does the init change
    # which categories files land in?
    dq = {}
    for method in ("d2", "kmeans||"):
        dq[method] = {
            "at_300": _quality_one(300, 300.0, 21, init_method=method,
                                   device=device)["planted_accuracy"],
            "at_2000": _quality_one(2000, 600.0, 121, init_method=method,
                                    device=device)["planted_accuracy"],
        }
    result["decision_quality_planted_accuracy"] = dq
    return result


def carry_witness(seeds=(21, 22, 23, 24), n_files: int = 100_000, duration: float = 600.0,
                  device=None) -> dict:
    """Planted accuracy at one decision-quality workload, per seed: on the
    CPU, on ``device`` from its own D² init, on ``device`` from the CPU's
    D² init, and on the CPU from that init again (equal to its own run:
    the carried init is the one the CPU's pipeline draws).  Where the
    device from the CPU's init reads the CPU's number, the gap between the
    first two is the inits'.  Also the largest difference of the two
    devices' feature tables and of their D² inits."""
    from ..device import deterministic, device_name, resolve_device
    from ..ops.kmeans import _d2_init
    from .harness import _quality_run

    dev = resolve_device(device)
    rows = []
    with deterministic():
        for seed in seeds:
            cpu = _quality_run(n_files, duration, seed, device="cpu")
            card = _quality_run(n_files, duration, seed, device=dev)
            init = _d2_init(cpu.table.norm.float(), 8, 42)
            own = _d2_init(card.table.norm.float(), 8, 42).cpu()
            carried = _quality_run(n_files, duration, seed, device=dev, init_centroids=init)
            again = _quality_run(n_files, duration, seed, device="cpu", init_centroids=init)
            rows.append({
                "seed": seed, "cpu": cpu.planted_accuracy, "device": card.planted_accuracy,
                "device_from_cpu_init": carried.planted_accuracy,
                "cpu_from_cpu_init": again.planted_accuracy,
                "features_max_abs_diff": float(
                    (card.table.norm.cpu().double() - cpu.table.norm.double()).abs().max()),
                "init_max_abs_diff": float((own.double() - init.double()).abs().max())})
    return {"device_name": device_name(dev), "n_files": n_files, "duration": duration,
            "seeds": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.init_quality",
                                description="D² against k-means|| init quality")
    p.add_argument("--out", default=None,
                   help=f"default {DEFAULT_OUT}, or {WITNESS_OUT} with --carry_witness")
    p.add_argument("--small", action="store_true", help="reduced sizes")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--carry_witness", action="store_true",
                   help="the 100,000-file decision quality on the CPU, the card and the "
                        "card from the CPU's init, for --seeds seeds from 21")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.carry_witness:
        result = carry_witness(seeds=range(21, 21 + args.seeds), device=args.device)
        with open(args.out or WITNESS_OUT, "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps(result, indent=2))
        return 0

    result = run_init_quality(small=args.small, n_seeds=args.seeds, device=args.device)
    with open(args.out or DEFAULT_OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "shapes"}, indent=2))
    for s in result["shapes"]:
        print(f"n={s['n']} d={s['d']} k={s['k']}: "
              f"ratio kmeans||/d2 = {s.get('inertia_ratio_kmeans_par_over_d2')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
