"""Plan diffing and bounded-churn migration scheduling: the port of
``cdrs_tpu/control/migrate.py``, host numpy, decision-identical to it.

* ``plan_diff`` turns two plans (per-file rf and category) into a
  ``MoveSet``: one row per changed file, with its byte cost
  (``size_bytes * max(0, rf_new - rf_old)``: a new replica is copied, a
  dropped one moves nothing) and a priority.
* ``MigrationScheduler`` keeps the newest plan's moves as its backlog (a
  newer plan supersedes pending moves) in admission order (priority
  descending, file index ascending) and admits per window up to the byte
  and file budgets, holding a migrated file frozen for
  ``hysteresis_windows`` more windows.  The byte scan is a cumulative sum
  and ``searchsorted`` (``_greedy_admit``), with the reference's rules: the
  first byte-moving move of an unreserved window with a positive budget is
  admitted even when it alone exceeds the budget; zero-byte moves pass the
  byte budget but count against the file cap.  ``schedule``'s
  ``bytes_reserved``/``files_reserved`` pre-charge the window's budget with
  what the repair pass and the scrubber spent first (one churn allowance
  for all three); a nonzero byte reservation also takes the first-move
  allowance.  (Storage-specific byte costs come with storage strategies,
  ROADMAP A8e.)

The scheduler's state round-trips through ``state_arrays`` /
``load_state_arrays`` (the ``sched_*`` columns of the controller's
checkpoint, the reference's names).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["PlanMove", "MoveSet", "plan_diff", "MigrationScheduler"]

#: ``last_moved`` of a file never moved: eligible at window 0 for any
#: hysteresis.
_NEVER = -(2 ** 40)

#: The integer MoveSet columns (priority is the float64 seventh); also the
#: checkpoint's ``sched_<col>`` names.
_MOVE_COLS = ("file_index", "rf_old", "rf_new", "cat_old", "cat_new", "bytes_moved")


@dataclass(frozen=True)
class PlanMove:
    """One per-file change, rf_old -> rf_new, with its category: the row
    view of a ``MoveSet``."""

    file_index: int
    rf_old: int
    rf_new: int
    cat_old: int      # index into config.CATEGORIES; -1 = not yet planned
    cat_new: int
    bytes_moved: int
    priority: float   # larger = admitted earlier


class MoveSet:
    """Parallel columns of plan moves.  Supports ``len``, ``fid in ms``,
    iteration as ``PlanMove`` rows and ``take``."""

    __slots__ = ("file_index", "rf_old", "rf_new", "cat_old", "cat_new",
                 "bytes_moved", "priority")

    def __init__(self, file_index, rf_old, rf_new, cat_old, cat_new, bytes_moved,
                 priority):
        for name, value in zip(_MOVE_COLS, (file_index, rf_old, rf_new, cat_old, cat_new,
                                            bytes_moved)):
            setattr(self, name, np.asarray(value, dtype=np.int64))
        self.priority = np.asarray(priority, dtype=np.float64)
        n = self.file_index.shape[0]
        for name in self.__slots__:
            a = getattr(self, name)
            if a.ndim != 1 or a.shape[0] != n:
                raise ValueError(f"MoveSet column {name} has shape {a.shape}, "
                                 f"expected ({n},)")

    @classmethod
    def empty(cls) -> "MoveSet":
        z = np.zeros(0, dtype=np.int64)
        return cls(z, z, z, z, z, z, np.zeros(0))

    @classmethod
    def from_moves(cls, moves) -> "MoveSet":
        moves = list(moves)
        return cls(*([getattr(m, c) for m in moves] for c in cls.__slots__))

    def __len__(self) -> int:
        return int(self.file_index.shape[0])

    def __contains__(self, fid) -> bool:
        return bool((self.file_index == int(fid)).any())

    def __iter__(self):
        for i in range(len(self)):
            yield PlanMove(*(int(getattr(self, c)[i]) for c in _MOVE_COLS),
                           priority=float(self.priority[i]))

    def take(self, idx) -> "MoveSet":
        """Rows by integer indices or a boolean mask."""
        return MoveSet(*(getattr(self, c)[idx] for c in self.__slots__))

    @property
    def total_bytes(self) -> int:
        return int(self.bytes_moved.sum())


def plan_diff(rf_old, rf_new, cat_old, cat_new, size_bytes, priority=None) -> MoveSet:
    """Moves for every file whose (rf, category) changed, in ascending file
    order.  ``priority`` defaults to zero."""
    rf_old = np.asarray(rf_old, dtype=np.int64)
    rf_new = np.asarray(rf_new, dtype=np.int64)
    cat_old = np.asarray(cat_old, dtype=np.int64)
    cat_new = np.asarray(cat_new, dtype=np.int64)
    size_bytes = np.asarray(size_bytes, dtype=np.int64)
    n = rf_old.shape[0]
    for name, a in (("rf_new", rf_new), ("cat_old", cat_old), ("cat_new", cat_new),
                    ("size_bytes", size_bytes)):
        if a.shape != (n,):
            raise ValueError(f"{name} shape {a.shape} != ({n},)")
    prio = np.zeros(n) if priority is None else np.asarray(priority, dtype=np.float64)
    changed = np.flatnonzero((rf_new != rf_old) | (cat_new != cat_old))
    bytes_moved = size_bytes[changed] * np.maximum(rf_new[changed] - rf_old[changed], 0)
    return MoveSet(changed, rf_old[changed], rf_new[changed], cat_old[changed],
                   cat_new[changed], bytes_moved, prio[changed])


def _next_le(values: np.ndarray, start: int, limit) -> int:
    """First index >= ``start`` with ``values[i] <= limit``, or -1, scanned
    in growing chunks."""
    n = values.shape[0]
    chunk = 4096
    i = start
    while i < n:
        j = min(n, i + chunk)
        hit = np.flatnonzero(values[i:j] <= limit)
        if hit.size:
            return i + int(hit[0])
        i = j
        chunk = min(chunk * 4, 1 << 20)
    return -1


def _greedy_admit(bp: np.ndarray, max_bytes: int, reserved: int = 0) -> np.ndarray:
    """Admission flags of positive byte costs ``bp`` in admission order:
    the sequential scan "admit while ``reserved + used + b <= max_bytes``,
    skip and go on otherwise", plus the first-move allowance of an
    unreserved window, as maximal admitted runs found by ``searchsorted``
    on the cumulative sum."""
    n = bp.shape[0]
    admit = np.zeros(n, dtype=bool)
    if n == 0:
        return admit
    used = int(reserved)
    j = 0
    if used == 0 and max_bytes > 0:
        admit[0] = True
        used += int(bp[0])
        j = 1
    cum = np.cumsum(bp)
    while j < n:
        base = int(cum[j - 1]) if j > 0 else 0
        e = int(np.searchsorted(cum, max_bytes - used + base, side="right"))
        if e > j:
            admit[j:e] = True
            used += int(cum[e - 1]) - base
        e = max(e, j)
        if e >= n:
            break
        nxt = _next_le(bp, e + 1, max_bytes - used)
        if nxt < 0:
            break
        j = nxt
    return admit


class MigrationScheduler:
    """Backlog, churn budget and hysteresis (see the module docstring)."""

    def __init__(self, n_files: int, max_bytes_per_window: int | None = None,
                 max_files_per_window: int | None = None, hysteresis_windows: int = 0):
        if max_bytes_per_window is not None and max_bytes_per_window < 0:
            raise ValueError("max_bytes_per_window must be >= 0 or None")
        if max_files_per_window is not None and max_files_per_window < 1:
            raise ValueError("max_files_per_window must be >= 1 or None")
        self.n_files = int(n_files)
        self.max_bytes = max_bytes_per_window
        self.max_files = max_files_per_window
        self.hysteresis = int(hysteresis_windows)
        self.backlog: MoveSet = MoveSet.empty()
        self.last_moved = np.full(n_files, _NEVER, dtype=np.int64)
        #: Moves the last ``schedule`` skipped for hysteresis / for the byte
        #: budget (observations, not checkpointed).
        self.last_deferred_hysteresis = 0
        self.last_deferred_budget = 0

    @staticmethod
    def _admission_order(moves: MoveSet) -> MoveSet:
        return moves.take(np.lexsort((moves.file_index, -moves.priority)))

    def submit(self, moves) -> None:
        """Replace the backlog with the newest plan's moves; of several moves
        of one file the last wins."""
        ms = moves if isinstance(moves, MoveSet) else MoveSet.from_moves(moves)
        fi = ms.file_index
        if fi.size and np.unique(fi).size != fi.size:
            keep = fi.size - 1 - np.unique(fi[::-1], return_index=True)[1]
            ms = ms.take(np.sort(keep))
        self.backlog = self._admission_order(ms)

    def schedule(self, window_index: int, *, bytes_reserved: int = 0,
                 files_reserved: int = 0) -> MoveSet:
        """This window's admitted moves, in admission order; they leave the
        backlog and stamp ``last_moved``.  ``max_bytes == 0`` admits no
        byte-moving move; the file cap is strict and, once reached, stops
        the scan (moves past it are neither admitted nor counted as
        deferred).  The reservations pre-charge both budgets (see the module
        docstring); a file cap used up by them admits nothing."""
        bl = self.backlog
        self.last_deferred_hysteresis = 0
        self.last_deferred_budget = 0
        m = len(bl)
        if m == 0:
            return MoveSet.empty()
        cap = None
        if self.max_files is not None:
            cap = self.max_files - int(files_reserved)
            if cap <= 0:
                return MoveSet.empty()

        hyst_ok = (np.asarray(window_index, dtype=np.int64)
                   >= self.last_moved[bl.file_index] + 1 + self.hysteresis)
        admit = np.zeros(m, dtype=bool)
        if self.max_bytes is None:
            admit[hyst_ok] = True
        else:
            cand = np.flatnonzero(hyst_ok)
            b = bl.bytes_moved[cand]
            adm_c = b == 0
            pos = np.flatnonzero(b > 0)
            if pos.size:
                adm_c[pos[_greedy_admit(b[pos], int(self.max_bytes),
                                        int(bytes_reserved))]] = True
            admit[cand[adm_c]] = True

        limit = m
        hits = np.flatnonzero(admit)
        if cap is not None:
            if hits.size > cap:
                limit = int(hits[cap - 1]) + 1
                admit[limit:] = False
                hits = hits[:cap]
            elif hits.size == cap:
                limit = int(hits[-1]) + 1
        self.last_deferred_hysteresis = int((~hyst_ok[:limit]).sum())
        self.last_deferred_budget = int((hyst_ok[:limit] & ~admit[:limit]).sum())
        if hits.size == 0:
            return MoveSet.empty()
        applied = bl.take(hits)
        self.last_moved[applied.file_index] = window_index
        self.backlog = bl.take(np.flatnonzero(~admit))
        return applied

    @property
    def backlog_bytes(self) -> int:
        return self.backlog.total_bytes

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The backlog columns as they stand, and the hysteresis stamps."""
        out = {"sched_" + c: getattr(self.backlog, c).copy() for c in _MOVE_COLS}
        out["sched_priority"] = self.backlog.priority.copy()
        out["sched_last_moved"] = self.last_moved.copy()
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        """Restore the backlog and stamps, checking shapes, dtypes and file
        indices against ``n_files``; the admission order is re-derived."""
        missing = [k for k in ("sched_last_moved", "sched_priority",
                               *("sched_" + c for c in _MOVE_COLS)) if k not in arrays]
        if missing:
            raise ValueError(f"checkpoint is missing scheduler arrays {missing}: "
                             "not a controller snapshot?")
        lm = np.asarray(arrays["sched_last_moved"])
        if lm.shape != (self.n_files,):
            raise ValueError(f"checkpoint covers {lm.shape[0] if lm.ndim == 1 else lm.shape} "
                             f"files, scheduler has {self.n_files}")
        if not np.issubdtype(lm.dtype, np.integer):
            raise ValueError(f"sched_last_moved dtype {lm.dtype} is not integral")
        cols = [np.asarray(arrays["sched_" + c]) for c in _MOVE_COLS]
        prio = np.asarray(arrays["sched_priority"], dtype=np.float64)
        n_moves = cols[0].shape[0] if cols[0].ndim == 1 else -1
        for name, a in zip((*_MOVE_COLS, "priority"), (*cols, prio)):
            if a.ndim != 1 or a.shape[0] != n_moves:
                raise ValueError(f"scheduler backlog column sched_{name} has shape "
                                 f"{a.shape}, expected ({n_moves},)")
            if name != "priority" and not np.issubdtype(a.dtype, np.integer):
                raise ValueError(f"scheduler backlog column sched_{name} dtype {a.dtype} "
                                 "is not integral")
        bad = cols[0][(cols[0] < 0) | (cols[0] >= self.n_files)]
        if bad.size:
            raise ValueError(f"scheduler backlog names file indices outside "
                             f"[0, {self.n_files}): {bad[:5].tolist()}")
        self.last_moved = lm.astype(np.int64).copy()
        self.backlog = self._admission_order(MoveSet(*cols, prio))
