"""Exportable replication plan: the port of ``cdrs_tpu/cluster/plan.py``,
byte-identical to it.

* a **plan file** (CSV ``path,category,rf``, one row per file, header
  included) — the per-file target replication factor, round-tripped by
  ``read_plan_csv``;
* an **``hdfs dfs -setrep`` script** — one command per batch of paths of
  one rf, runnable against a live HDFS.

Building a plan touches no cluster.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

from ..config import ScoringConfig

__all__ = ["PlanEntry", "build_plan", "write_plan_csv", "read_plan_csv",
           "write_setrep_script"]

#: Paths per ``hdfs dfs -setrep`` command: bounds the command-line length.
_SETREP_BATCH = 500


@dataclass(frozen=True)
class PlanEntry:
    path: str
    category: str
    rf: int


def build_plan(paths, categories, cfg: ScoringConfig | None = None,
               rf=None) -> list[PlanEntry]:
    """Per-file target-rf plan from decided categories.

    ``rf`` (one int per file) overrides the config's category -> rf table;
    otherwise the factors come from ``cfg.replication_factors``.  Unknown
    categories raise: a silently defaulted rf would mis-replicate a real
    cluster.
    """
    cfg = cfg or ScoringConfig()
    paths = list(paths)
    categories = list(categories)
    if len(paths) != len(categories):
        raise ValueError(f"{len(paths)} paths vs {len(categories)} categories")
    if rf is not None:
        rf = np.asarray(rf, dtype=np.int64)
        if rf.shape != (len(paths),):
            raise ValueError(f"rf shape {rf.shape} != ({len(paths)},)")
        factors = [int(r) for r in rf]
    else:
        table = cfg.replication_factors
        missing = sorted({c for c in categories if c not in table})
        if missing:
            raise ValueError(
                f"categories {missing} have no replication factor in the "
                f"scoring config (known: {sorted(table)})")
        factors = [int(table[c]) for c in categories]
    return [PlanEntry(p, c, f) for p, c, f in zip(paths, categories, factors)]


def write_plan_csv(path: str, entries: list[PlanEntry]) -> None:
    """``path,category,rf``: one row per file, header included."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "category", "rf"])
        for e in entries:
            w.writerow([e.path, e.category, e.rf])


def read_plan_csv(path: str) -> list[PlanEntry]:
    """Inverse of ``write_plan_csv`` (exact round trip)."""
    with open(path, newline="") as f:
        return [PlanEntry(row["path"], row["category"], int(row["rf"]))
                for row in csv.DictReader(f)]


def write_setrep_script(path: str, entries: list[PlanEntry], batch: int = _SETREP_BATCH,
                        wait: bool = False) -> int:
    """Write a shell script of ``hdfs dfs -setrep`` commands applying the
    plan; returns the number of commands.

    Paths are grouped by rf (ascending), ``batch`` paths a command, each
    single-quoted with its quotes escaped.  ``wait=True`` adds ``-w``
    (block until re-replication completes).
    """
    def q(s: str) -> str:
        return "'" + s.replace("'", "'\\''") + "'"

    by_rf: dict[int, list[str]] = {}
    for e in entries:
        by_rf.setdefault(e.rf, []).append(e.path)

    n_cmds = 0
    flag = "-w " if wait else ""
    with open(path, "w") as f:
        f.write("#!/bin/sh\n# Generated replication plan "
                f"({len(entries)} files, {len(by_rf)} rf groups).\n"
                "# Apply with: sh this_script  (requires the hdfs CLI "
                "on PATH and a running namenode).\nset -e\n")
        for rf in sorted(by_rf):
            paths = by_rf[rf]
            for i in range(0, len(paths), batch):
                chunk = " ".join(q(p) for p in paths[i:i + batch])
                f.write(f"hdfs dfs -setrep {flag}{rf} {chunk}\n")
                n_cmds += 1
    return n_cmds
