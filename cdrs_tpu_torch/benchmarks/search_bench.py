"""Failure-space search effectiveness: guided against blind, shrink quality;
the counterpart of ``cdrs_tpu/benchmarks/search_bench.py``.

The acceptance artifact of the coverage-guided scenario search
(``data/search_bench_torch.json``), two claims:

**Guided beats blind** (``run_effectiveness``): on a fixed seed and a
MATCHED cell budget, the coverage-guided mutator (``scenarios/search.py``)
must reach a strictly larger coverage fingerprint than blind
``random_cell`` sampling — both start from the same base-preset coverage,
the blind arm gets exactly as many extra cells as the guided arm actually
ran.  Coverage is the harness fingerprint (``coverage_bits``): fault kinds
applied, durability tiers entered, repair/detection branches taken, alerts
fired, lineage causes, and the invariant branches evaluated non-vacuously.

**Violations shrink to tiny repros** (``run_shrinker``): a planted
invariant violation with a known 2-event minimal cause (silent corruption
of one node's copies + decommission of the last clean holder, padded with
healing noise spans) must delta-debug down to a <= 3-event repro whose
one-line repro command reruns RED verbatim through the port's CLI.

Every cell runs on ``device`` (CUDA unless ``--device cpu``): each
controller's re-clusters launch the Lloyd kernel.

    python -m cdrs_tpu_torch.benchmarks.search_bench [--quick] [--device cpu]

Outside ``--quick`` the bench_records are appended to the port's history
(``regress.append_history``, deduplicated).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os

from ..device import resolve_device
from ..scenarios.harness import run_cell
from ..scenarios.presets import preset, random_cell
from ..scenarios.search import _sanitize, planted_violation_spec, run_search, shrink_cell
from .common import bench_record, write_artifact

__all__ = ["run_effectiveness", "run_shrinker"]

DEFAULT_OUT = "data/search_bench_torch.json"


def run_effectiveness(seed: int = 0, budget_cells: int = 60, device=None) -> dict:
    """Guided search against blind random sampling at a matched cell budget
    (module docstring).  Deterministic in ``seed``."""
    dev = resolve_device(device)
    guided = run_search(seed=seed, budget_cells=budget_cells, bank=False, corpus_dir="",
                        shrink=False, device=dev)
    # The blind arm: same base coverage, plus exactly as many random cells
    # as the guided arm actually RAN (mutation draws that failed validation
    # cost the guided arm budget but no run).
    base_union: set = set()
    for name in guided["base"]:
        base_union |= set(run_cell(_sanitize(preset(name), name=name), device=dev)["coverage"])
    blind_bits = set(base_union)
    for i in range(guided["cells_run"]):
        blind_bits |= set(run_cell(random_cell(i, seed), device=dev)["coverage"])
    blind_total = len(blind_bits)
    return {
        "seed": int(seed),
        "budget_cells": int(budget_cells),
        "cells_run": guided["cells_run"],
        "baseline_bits": len(base_union),
        "guided_bits": guided["coverage_bits"],
        "guided_new_cells": guided["new_coverage_cells"],
        "guided_violations": len(guided["violations"]),
        "blind_bits": blind_total,
        "advantage_bits": guided["coverage_bits"] - blind_total,
        "guided_exceeds_blind": guided["coverage_bits"] > blind_total,
        "seconds": guided["seconds"],
    }


def run_shrinker(seed: int = 0, device=None) -> dict:
    """Plant the known-minimal-cause violation, shrink it, and rerun the
    emitted repro line's ``--spec`` through the port's CLI on ``device``
    (module docstring)."""
    from ..cli import main as cli_main

    dev = resolve_device(device)
    spec = planted_violation_spec(seed)
    planted = run_cell(spec, device=dev)
    sh = shrink_cell(spec, device=dev)
    # The repro line is `python -m cdrs_tpu_torch scenarios run --spec '...'`;
    # rerun its --spec payload through the CLI entry point and require the
    # red exit the line promises.
    payload = sh["repro"].split("--spec ", 1)[1].strip().strip("'")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["scenarios", "run", "--spec", payload, "--device", str(dev)])
    rerun = json.loads(buf.getvalue())
    return {
        "seed": int(seed),
        "planted_ok": planted["ok"],
        "planted_events": len((spec.faults or {}).get("specs") or ()),
        "planted_failed": sorted(k for k, v in planted["invariants"].items() if not v),
        "shrunk_events": sh["n_events"],
        "shrunk_schedule": sh["events"],
        "shrunk_failed": sh["failed"],
        "oracle_runs": sh["oracle_runs"],
        "repro": sh["repro"],
        "repro_exit_code": rc,
        "repro_failed": sorted(k for k, v in rerun["invariants"].items() if not v),
        "repro_reruns_red": rc == 1 and not rerun["ok"],
    }


def main(argv=None) -> int:
    from .regress import (add_history_argument, append_history, extract_records,
                          resolve_history_path)

    p = argparse.ArgumentParser(prog="python -m cdrs_tpu_torch.benchmarks.search_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--budget-cells", type=int, default=60, dest="budget_cells")
    p.add_argument("--round", type=int, default=19, dest="round_no",
                   help="PR-round stamp for the regress history")
    p.add_argument("--quick", action="store_true",
                   help="small budget for smoke runs (CI); never appends to the history")
    add_history_argument(p)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    budget = 12 if args.quick else args.budget_cells
    effectiveness = run_effectiveness(seed=args.seed, budget_cells=budget, device=dev)
    shrinker = run_shrinker(seed=args.seed, device=dev)

    out: dict = {"round": args.round_no, "effectiveness": effectiveness, "shrinker": shrinker}
    out["criteria"] = {
        "guided_exceeds_blind": effectiveness["guided_exceeds_blind"],
        "new_coverage_found": effectiveness["guided_new_cells"] >= 1,
        "planted_violation_detected": not shrinker["planted_ok"],
        "shrunk_to_3_events_or_fewer": shrinker["shrunk_events"] <= 3,
        "shrunk_repro_reruns_red": shrinker["repro_reruns_red"],
    }
    out["bench_records"] = [
        bench_record("search_coverage_bits", float(effectiveness["guided_bits"]), "bits", dev,
                     "higher"),
        bench_record("search_coverage_advantage_bits", float(effectiveness["advantage_bits"]),
                     "bits", dev, "higher"),
        bench_record("search_shrunk_repro_events", float(shrinker["shrunk_events"]), "events",
                     dev, "lower"),
    ]

    write_artifact(args.out, out, dev)
    appended = 0
    if not args.quick:
        history = resolve_history_path(args)
        if history:
            appended = append_history(history, extract_records(out, os.path.basename(args.out)))
    print(json.dumps({"out": args.out, **out["criteria"],
                      "guided_bits": effectiveness["guided_bits"],
                      "blind_bits": effectiveness["blind_bits"],
                      "shrunk_events": shrinker["shrunk_events"],
                      "history_appended": appended}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
