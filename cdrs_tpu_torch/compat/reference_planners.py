"""The legacy object-at-a-time planners, kept as the equivalence oracle and
the planner bench's baseline: the port's copy of
``cdrs_tpu/compat/reference_planners.py`` (host numpy, no device).

The per-window control plane is structure-of-arrays (``control/migrate.py``,
``faults/repair.py``).  The implementations it replaced — one Python
``PlanMove`` object per changed file, admission via a Python ``sorted``
loop, one ``RepairTask`` ``while`` loop per damaged file — live on here,
verbatim, for two consumers:

* the equivalence property tests (``tests/test_torch_bench_plan.py``):
  random scenarios assert the vectorized planners reproduce the
  admitted/deferred sets and byte accounting of this path bit for bit;
* ``benchmarks/plan_bench.py``: the >= 10x planner wall-clock criterion is
  measured against this path on the same host, paired interleaved rounds.

Nothing in the production loop imports this module.  It intentionally
preserves the old algorithmic costs (O(n) object churn, O(n log n) Python
sorts) — do not "optimize" it, its slowness is the baseline.
"""

from __future__ import annotations

import numpy as np

from ..control.migrate import _NEVER, PlanMove
from ..faults.repair import _MAX_BACKOFF, RepairReport, RepairTask, _fail_roll

__all__ = ["reference_plan_diff", "ReferenceMigrationScheduler",
           "ReferenceRepairScheduler"]


def reference_plan_diff(rf_old, rf_new, cat_old, cat_new, size_bytes,
                        priority=None, move_bytes=None) -> list[PlanMove]:
    """The pre-SoA ``plan_diff``: one ``PlanMove`` per changed file."""
    rf_old = np.asarray(rf_old, dtype=np.int64)
    rf_new = np.asarray(rf_new, dtype=np.int64)
    cat_old = np.asarray(cat_old, dtype=np.int64)
    cat_new = np.asarray(cat_new, dtype=np.int64)
    size_bytes = np.asarray(size_bytes, dtype=np.int64)
    n = rf_old.shape[0]
    prio = np.zeros(n) if priority is None else np.asarray(priority,
                                                           dtype=np.float64)
    changed = np.flatnonzero((rf_new != rf_old) | (cat_new != cat_old))
    if move_bytes is None:
        bytes_moved = size_bytes * np.maximum(rf_new - rf_old, 0)
    else:
        bytes_moved = np.asarray(move_bytes, dtype=np.int64)
    return [PlanMove(file_index=int(i), rf_old=int(rf_old[i]),
                     rf_new=int(rf_new[i]), cat_old=int(cat_old[i]),
                     cat_new=int(cat_new[i]), bytes_moved=int(bytes_moved[i]),
                     priority=float(prio[i]))
            for i in changed]


class ReferenceMigrationScheduler:
    """The pre-SoA ``MigrationScheduler``: dict backlog, Python-loop
    admission.  Same constructor and ``schedule`` contract as the
    vectorized scheduler; ``schedule`` returns a ``list[PlanMove]``."""

    def __init__(self, n_files: int, max_bytes_per_window: int | None = None,
                 max_files_per_window: int | None = None,
                 hysteresis_windows: int = 0):
        self.n_files = int(n_files)
        self.max_bytes = max_bytes_per_window
        self.max_files = max_files_per_window
        self.hysteresis = int(hysteresis_windows)
        self.backlog: dict[int, PlanMove] = {}
        self.last_moved = np.full(n_files, _NEVER, dtype=np.int64)
        self.last_deferred_hysteresis = 0
        self.last_deferred_budget = 0

    def submit(self, moves) -> None:
        self.backlog = {m.file_index: m for m in moves}

    def schedule(self, window_index: int, *, bytes_reserved: int = 0,
                 files_reserved: int = 0) -> list[PlanMove]:
        order = sorted(self.backlog.values(),
                       key=lambda m: (-m.priority, m.file_index))
        applied: list[PlanMove] = []
        bytes_used = int(bytes_reserved)
        self.last_deferred_hysteresis = 0
        self.last_deferred_budget = 0
        for m in order:
            if self.max_files is not None \
                    and len(applied) + int(files_reserved) >= self.max_files:
                break
            if window_index < int(self.last_moved[m.file_index]) \
                    + 1 + self.hysteresis:
                self.last_deferred_hysteresis += 1
                continue
            if self.max_bytes is not None and m.bytes_moved > 0:
                over = bytes_used + m.bytes_moved > self.max_bytes
                first = bytes_used == 0 and self.max_bytes > 0
                if over and not first:
                    self.last_deferred_budget += 1
                    continue
            applied.append(m)
            bytes_used += m.bytes_moved
        for m in applied:
            del self.backlog[m.file_index]
            self.last_moved[m.file_index] = window_index
        return applied

    @property
    def backlog_bytes(self) -> int:
        return sum(m.bytes_moved for m in self.backlog.values())


class ReferenceRepairScheduler:
    """The pre-SoA ``RepairScheduler``: dict-of-``RepairTask`` backlog,
    per-task Python ``while`` loop.  Drives the SAME ``ClusterState`` API
    as the vectorized scheduler, so equivalence runs mutate two separate
    states from identical starting conditions and compare everything."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.backlog: dict[int, RepairTask] = {}

    def sync(self, state, target_rf: np.ndarray) -> None:
        state.trim_excess(target_rf)
        fids, _reach, _eff = state.repair_needs(target_rf)
        corr = np.flatnonzero(state.correlated_mask(target_rf))
        work = np.union1d(fids, corr)
        self.backlog = {int(f): self.backlog.get(int(f), RepairTask(int(f)))
                        for f in work}

    def _charge(self, state, fid: int, target: int) -> int:
        read_bytes = int(state.repair_read_bytes(fid))
        node_reach = state.node_reachable()
        row = state.replica_map[fid]
        srcs = [float(state.node_throughput[int(x)]) for x in row[row >= 0]
                if node_reach[int(x)]]
        k = int(state.ec_k[fid])
        if k > 1 and srcs:
            srcs.sort(reverse=True)
            src_m = srcs[min(k, len(srcs)) - 1]
        else:
            src_m = max(srcs, default=1.0)
        m = min(src_m, float(state.node_throughput[target]))
        return int(np.ceil(read_bytes / max(m, 1e-9)))

    def schedule(self, window: int, state, target_rf: np.ndarray,
                 cat: np.ndarray, *, max_bytes: int | None = None,
                 max_files: int | None = None) -> RepairReport:
        rep = RepairReport()
        if not self.backlog:
            return rep
        live = state.live_counts()
        reach = state.reachable_counts()
        eff = state.effective_target(target_rf)
        corr = state.correlated_mask(target_rf)
        rf_vec = np.asarray(target_rf, dtype=np.int64)
        need = state.min_live

        def prio(t: RepairTask):
            f = t.file_index
            if reach[f] < need[f]:
                tier = 0          # lost / wholly stranded
            elif reach[f] == need[f]:
                tier = 1          # at risk: one failure from loss
            elif reach[f] < eff[f]:
                tier = 2
            else:
                tier = 3          # correlated-risk rebalance: spread last
            return (tier, -int(rf_vec[f]), f)

        order = sorted(self.backlog.values(), key=prio)
        touched: set[int] = set()
        healed: list[int] = []
        for task in order:
            f = task.file_index
            if task.next_window > window:
                rep.deferred_backoff += 1
                continue
            if reach[f] < need[f]:
                if live[f] >= need[f]:
                    if task.stall_until > window:
                        rep.deferred_backoff += 1
                    else:
                        task.stalled += 1
                        task.stall_until = window + min(2 ** task.stalled,
                                                        _MAX_BACKOFF)
                        rep.deferred_partition += 1
                else:
                    rep.deferred_no_source += 1
                continue
            if max_files is not None and f not in touched \
                    and len(touched) >= max_files:
                rep.deferred_budget += 1
                continue
            size = int(state.shard_bytes[f])
            copy = 0
            rebalance = reach[f] >= eff[f] and bool(corr[f])
            spread_fixed = False
            while reach[f] < eff[f] or (rebalance and copy == 0):
                target = state.pick_repair_target(
                    f, rotate=task.attempts + copy,
                    new_domain_only=rebalance)
                if target < 0:
                    rep.deferred_no_target += 1
                    break
                charge = self._charge(state, f, target)
                if max_bytes is not None:
                    over = rep.bytes_used + charge > max_bytes
                    first = rep.bytes_used == 0 and max_bytes > 0
                    if over and not first:
                        rep.deferred_budget += 1
                        break
                p = float(state.node_fail_prob[target])
                if p > 0.0 and _fail_roll(self.seed, window, f,
                                          task.attempts, copy) < p:
                    task.attempts += 1
                    task.next_window = window + min(2 ** task.attempts,
                                                    _MAX_BACKOFF)
                    rep.failed += 1
                    rep.bytes_used += charge
                    touched.add(f)
                    break
                state.add_replica(f, target)
                rep.bytes_used += charge
                rep.bytes_copied += size
                rep.applied.append((f, int(target), size))
                touched.add(f)
                if rebalance:
                    state.drop_crowded(f)
                    rep.rebalanced += 1
                    rep.rebalanced_fids.append(f)
                    rep.rebalanced_bytes += charge
                    spread_fixed = True
                    break
                reach[f] += 1
                copy += 1
            if reach[f] >= eff[f] and (not bool(corr[f]) or spread_fixed):
                healed.append(f)
        for f in healed:
            self.backlog.pop(f, None)
        rep.files_touched = len(touched)
        return rep
