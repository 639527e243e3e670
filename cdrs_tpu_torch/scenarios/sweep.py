"""Matrix sweep runner: ``cdrs_tpu/scenarios/sweep.py`` on the port's harness.

``run_sweep`` runs a suite's cells and returns the sweep artifact: the
per-cell verdicts and headline metrics, the flattened ``bench_records``,
and ``ok``, which the CLI turns into the exit code.  Failing cells carry
their one-line repro.

The reference's history append (``--round``/``--history``, its
``benchmarks/regress``) belongs to the port's benchmark, ROADMAP A10a.
"""

from __future__ import annotations

import json
import time

from .harness import run_cell
from .presets import suite_cells
from .spec import ScenarioSpec

__all__ = ["run_sweep", "run_cells", "format_cell_line", "load_extra_cells"]


def format_cell_line(cell: dict) -> str:
    """One human line per cell: verdict, name, failed invariants, repro."""
    inv = cell["invariants"]
    if cell["ok"]:
        return (f"  [ok  ] {cell['cell']:<22} {len(inv)} invariants, "
                f"{cell['metrics']['windows']} windows, {cell['seconds']:.1f}s")
    failed = sorted(k for k, v in inv.items() if not v)
    return (f"  [FAIL] {cell['cell']:<22} {','.join(failed)}\n"
            f"         repro: {cell['repro']}")


def load_extra_cells(paths) -> list[ScenarioSpec]:
    """Corpus cell files (``{"cells": [spec dicts], "names": [...]}``, the
    shape of the reference's distilled.json and triage.json) as specs, with
    their stored names."""
    specs: list[ScenarioSpec] = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except OSError as e:
            raise ValueError(f"cannot read extra-cells file {path}: {e.strerror or e}") from e
        if not isinstance(doc, dict) or not isinstance(doc.get("cells"), list):
            raise ValueError(f"extra-cells file {path} must be a JSON object with a 'cells' "
                             f"list (distilled.json / triage.json shape)")
        names = doc.get("names") or []
        for i, c in enumerate(doc["cells"]):
            d = dict(c)
            if i < len(names):
                d["name"] = str(names[i])
            specs.append(ScenarioSpec.from_dict(d))
    return specs


def run_sweep(suite: str, *, seed: int = 0, extra=None, progress=None,
              device=None) -> dict:
    """Run every cell of ``suite`` (and of the ``extra`` corpus cell
    files, never seed-shifted) on ``device``; returns the sweep artifact."""
    cells = list(suite_cells(suite, seed))
    if extra:
        cells += load_extra_cells(extra)
    return run_cells(cells, suite=suite, seed=seed, progress=progress, device=device)


def run_cells(cells: list[ScenarioSpec], *, suite: str | None = None, seed: int = 0,
              progress=None, device=None) -> dict:
    t0 = time.perf_counter()
    results = []
    for spec in cells:
        cell = run_cell(spec, suite=suite, suite_seed=seed, device=device)
        results.append(cell)
        if progress is not None:
            progress(format_cell_line(cell))
    return {
        "suite": suite,
        "seed": seed,
        "cells": results,
        "n_cells": len(results),
        "n_failed": sum(1 for c in results if not c["ok"]),
        "invariants_checked": sum(len(c["invariants"]) for c in results),
        "ok": all(c["ok"] for c in results),
        "seconds": round(time.perf_counter() - t0, 3),
        "bench_records": [r for c in results for r in c["bench_records"]],
    }
