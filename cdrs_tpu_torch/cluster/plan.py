"""Exportable replication plan: ``PlanEntry`` and ``write_plan_csv`` of
``cdrs_tpu/cluster/plan.py``, byte-identical to it (CSV ``path,category,rf``,
one row per file, header included)."""

from __future__ import annotations

import csv
from dataclasses import dataclass

__all__ = ["PlanEntry", "write_plan_csv"]


@dataclass(frozen=True)
class PlanEntry:
    path: str
    category: str
    rf: int


def write_plan_csv(path: str, entries: list[PlanEntry]) -> None:
    """``path,category,rf``: one row per file, header included."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "category", "rf"])
        for e in entries:
            w.writerow([e.path, e.category, e.rf])
