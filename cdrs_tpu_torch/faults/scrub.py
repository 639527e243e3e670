"""Budgeted background scrubbing: the port of ``cdrs_tpu/faults/scrub.py``,
host numpy, identical to it.

Each window the ``Scrubber`` verification-reads every reachable copy of
the next files in file order, wrapping at the end of the population,
under ``bytes_per_window`` (a copy charges ``shard_bytes / holder
throughput``), itself capped by what repairs left of the shared churn
budget.  A rotten copy found is quarantined at once, so the next repair
sync re-replicates it from a clean source.  Files the read path found rot
in (``add_hints``) are verified first.  The cursor and the hint queue ride
the checkpoint; nothing is random.  A window whose shared remainder cut
the scan short of the configured rate reports ``starved``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ScrubConfig", "ScrubReport", "Scrubber"]


@dataclass(frozen=True)
class ScrubConfig:
    """Knobs of the background scrubber."""

    #: Verification-read budget per window (bytes at nominal throughput).
    bytes_per_window: int

    def __post_init__(self):
        if self.bytes_per_window <= 0:
            raise ValueError(f"scrub bytes_per_window must be > 0, got "
                             f"{self.bytes_per_window}")


@dataclass
class ScrubReport:
    """What one window's scrub pass did."""

    bytes_used: int = 0
    copies_verified: int = 0
    files_verified: int = 0
    corrupt_found: int = 0
    #: Files verified from the hint queue ahead of the cursor.
    hinted: int = 0
    #: The shared remainder, not the configured rate, halted the scan.
    starved: bool = False
    #: Next file the scan will touch.
    cursor: int = 0


class Scrubber:
    """Checkpointed scrub cursor and hint queue over one ClusterState."""

    def __init__(self, n_files: int, cfg: ScrubConfig):
        self.n_files = int(n_files)
        self.cfg = cfg
        self.cursor = 0
        #: Sorted unique file ids verified before the cursor scan.
        self.hints = np.zeros(0, dtype=np.int64)

    def add_hints(self, fids) -> None:
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size:
            self.hints = np.union1d(self.hints, fids)

    def run_window(self, window: int, state, *, shared_left: int | None = None) -> ScrubReport:
        """One window's verification pass; quarantines what it finds and
        moves the cursor.  The allowance is ``min(bytes_per_window,
        shared_left)``; the window's first copy may exceed the configured
        rate but never ``shared_left`` (then the pass defers it and reports
        ``starved``)."""
        cap = int(self.cfg.bytes_per_window)
        hard = None if shared_left is None else max(int(shared_left), 0)
        if hard is not None:
            cap = min(cap, hard)
        rep = ScrubReport()
        if cap <= 0:
            rep.starved = True
            rep.cursor = self.cursor
            return rep
        blocked_hard = False
        reach = state.node_reachable()
        thr = state.node_throughput

        def verify_file(fid: int) -> bool:
            """Verify every reachable copy of ``fid``; False when the budget
            ran out before the file was done."""
            nonlocal blocked_hard
            row = state.row(fid)
            corr = state.corrupt_row(fid)
            checked = 0
            for s in np.flatnonzero(row >= 0):
                node = int(row[s])
                if not reach[node]:
                    continue
                charge = int(np.ceil(int(state.shard_bytes[fid])
                                     / max(float(thr[node]), 1e-9)))
                if rep.bytes_used + charge > cap:
                    if rep.bytes_used > 0:
                        return False
                    if hard is not None and charge > hard:
                        blocked_hard = True
                        return False
                rep.bytes_used += charge
                rep.copies_verified += 1
                checked += 1
                if corr[s]:
                    state.quarantine(fid, node)
                    rep.corrupt_found += 1
            if checked:
                rep.files_verified += 1
            return True

        halted = False
        consumed = 0
        for fid in self.hints:
            if not verify_file(int(fid)):
                halted = True
                break
            consumed += 1
            rep.hinted += 1
        self.hints = self.hints[consumed:]

        # The cursor scan, vectorized: a cumulative sum of copy charges in
        # lap order and one searchsorted cut, reproducing the per-copy loop
        # (the lap's first copy passes when no hint bytes were spent; a
        # partly verified file holds the cursor).
        if not halted:
            n = self.n_files
            order = (self.cursor + np.arange(n)) % n
            rm = state.rows(order)
            ok = (rm >= 0) & reach[np.clip(rm, 0, None)]
            rows, slots = np.nonzero(ok)
            charge = np.ceil(state.shard_bytes[order[rows]]
                             / np.maximum(thr[rm[rows, slots]], 1e-9)).astype(np.int64)
            csum = rep.bytes_used + np.cumsum(charge)
            kpre = int(np.searchsorted(csum, cap, side="right"))
            if kpre == 0 and rep.bytes_used == 0 and charge.size:
                if hard is None or int(charge[0]) <= hard:
                    kpre = 1
                else:
                    blocked_hard = True
            if kpre:
                rep.bytes_used = int(csum[kpre - 1])
                rep.copies_verified += kpre
                fids = order[rows[:kpre]]
                corr = state.corrupt_at(fids, slots[:kpre])
                nodes = rm[rows[:kpre], slots[:kpre]]
                for f, nd in zip(fids[corr].tolist(), nodes[corr].tolist()):
                    state.quarantine(int(f), int(nd))
                    rep.corrupt_found += 1
            # A lap file is done when its last copy is inside the prefix.
            ends = np.cumsum(np.bincount(rows, minlength=n))
            n_done = int(np.searchsorted(ends, kpre, side="right"))
            counts = ends[:n_done]
            if n_done:
                rep.files_verified += int((np.diff(np.concatenate(([0], counts))) > 0).sum())
            self.cursor = (self.cursor + n_done) % n
            halted = kpre < charge.size
        rep.starved = (halted and cap < int(self.cfg.bytes_per_window)) or blocked_hard
        rep.cursor = self.cursor
        return rep

    # -- checkpoint ----------------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        return {"scrub_cursor": np.asarray([self.cursor], dtype=np.int64),
                "scrub_hints": self.hints.copy()}

    def load_state_arrays(self, arrays: dict) -> None:
        cur = np.asarray(arrays.get("scrub_cursor", [0]), dtype=np.int64)
        self.cursor = int(cur[0]) % max(self.n_files, 1)
        self.hints = np.asarray(arrays.get("scrub_hints", ()), dtype=np.int64).copy()
