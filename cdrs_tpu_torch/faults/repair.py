"""Repair planning under the shared churn budget: the port of
``cdrs_tpu/faults/repair.py``, host numpy, decision-identical to it.

Every window ``RepairScheduler.sync`` re-derives the backlog from the
``ClusterState``: files below their effective target, and files at target
whose reachable copies all share one failure domain (the spread
rebalance).  ``schedule`` admits copies in the order lost > at risk >
under-replicated > correlated, then category rf descending, then file
index, against the same byte and file budget the migration scheduler
uses; the controller runs repairs first and hands what they spent to
``MigrationScheduler.schedule`` as a reservation.

* The backlog is five int64 columns in file order (``RepairBacklog``).
  Backoff, stranded and partition-stall deferrals are array operations;
  the admission order packs (tier, -rf, file) into one int64 key and only
  the budget-bounded head is ordered, by ``argpartition`` chunks refilled
  geometrically.  Admitted copies then run file by file (target picking
  mutates the state), and once the remaining byte budget cannot pay any
  remaining task's cheapest copy, or the file cap is full, the whole tail
  is classified at once.
* A copy to a flaky node fails with the node's probability, decided by a
  stateless roll on (seed, window, file, attempt, copy) (``_fail_roll``),
  so a resumed controller replays it; a failed file backs off
  ``2^attempts`` windows (capped at 64) and retries a rotated target.
  Failed copies still spend budget.
* A file whose live copies all sit behind a partition defers with its own
  backoff (``deferred_partition``); a lost file defers as
  ``deferred_no_source``.
* With corruption present, an admitted repair first verification-reads
  the file's reachable copies and quarantines rotten ones
  (``ClusterState.verify_sources``), charging those reads.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["RepairTask", "RepairReport", "RepairBacklog", "RepairScheduler"]

#: Backoff cap in windows.
_MAX_BACKOFF = 64
#: Tasks whose rows a functional state computes in one pass.
_PREFETCH = 8192


@dataclass
class RepairTask:
    """One pending repair: the row view of a ``RepairBacklog``."""

    file_index: int
    attempts: int = 0
    #: First window the task is eligible again after a failed copy.
    next_window: int = 0
    #: Partition-stall backoff, separate from the copy-failure one.
    stalled: int = 0
    stall_until: int = 0


@dataclass
class RepairReport:
    """What one window's repair pass did."""

    applied: list[tuple[int, int, int]] = field(default_factory=list)
    #: Budget spent, failed copies and straggler inflation included.
    bytes_used: int = 0
    #: Data bytes copied.
    bytes_copied: int = 0
    files_touched: int = 0
    failed: int = 0
    #: Correlated-risk files moved into a fresh failure domain, with their
    #: ids and charge (the controller tags them apart from repairs).
    rebalanced: int = 0
    rebalanced_fids: list[int] = field(default_factory=list)
    rebalanced_bytes: int = 0
    deferred_budget: int = 0
    deferred_backoff: int = 0
    deferred_no_source: int = 0
    deferred_no_target: int = 0
    deferred_partition: int = 0
    #: Rotten sources quarantined before a copy streamed from them.
    corrupt_sources: int = 0


def _fail_roll(seed: int, window: int, fid: int, attempt: int, copy: int = 0) -> float:
    """Uniform [0, 1), stateless: crc32 of the five keys as int64."""
    key = np.asarray([seed, window, fid, attempt, copy], dtype=np.int64)
    return zlib.crc32(key.tobytes()) / 2.0 ** 32


class RepairBacklog:
    """Pending repairs as five parallel columns sorted by file index."""

    __slots__ = ("fid", "attempts", "next_window", "stalled", "stall_until")

    def __init__(self, fid, attempts, next_window, stalled, stall_until):
        self.fid = np.asarray(fid, dtype=np.int64)
        self.attempts = np.asarray(attempts, dtype=np.int64)
        self.next_window = np.asarray(next_window, dtype=np.int64)
        self.stalled = np.asarray(stalled, dtype=np.int64)
        self.stall_until = np.asarray(stall_until, dtype=np.int64)

    @classmethod
    def empty(cls) -> "RepairBacklog":
        z = np.zeros(0, dtype=np.int64)
        return cls(z, z, z, z, z)

    def __len__(self) -> int:
        return int(self.fid.shape[0])

    def _pos(self, fid) -> int:
        i = int(np.searchsorted(self.fid, int(fid)))
        if i < len(self) and int(self.fid[i]) == int(fid):
            return i
        return -1

    def __contains__(self, fid) -> bool:
        return self._pos(fid) >= 0

    def __getitem__(self, fid) -> RepairTask:
        i = self._pos(fid)
        if i < 0:
            raise KeyError(fid)
        return self._task(i)

    def get(self, fid, default=None):
        i = self._pos(fid)
        return self._task(i) if i >= 0 else default

    def _task(self, i: int) -> RepairTask:
        return RepairTask(int(self.fid[i]), attempts=int(self.attempts[i]),
                          next_window=int(self.next_window[i]),
                          stalled=int(self.stalled[i]), stall_until=int(self.stall_until[i]))

    def items(self):
        for i in range(len(self)):
            yield int(self.fid[i]), self._task(i)

    def take(self, idx) -> "RepairBacklog":
        return RepairBacklog(*(getattr(self, c)[idx] for c in self.__slots__))


class RepairScheduler:
    """The backlog and the budgeted per-window repair pass."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.backlog: RepairBacklog = RepairBacklog.empty()

    def sync(self, state, target_rf: np.ndarray) -> None:
        """Re-derive the backlog: newly damaged and correlated-risk files
        enter, healed files leave, files still damaged keep their backoff.
        Excess copies a recovery resurfaced are trimmed first."""
        state.trim_excess(target_rf)
        reach = state._reach_counts
        eff = state.effective_target(target_rf)
        corr_mask = state.correlated_mask(target_rf, reach=reach, eff=eff)
        work = np.flatnonzero((reach < eff) | corr_mask).astype(np.int64)
        old = self.backlog
        n = work.shape[0]
        cols = {c: np.zeros(n, dtype=np.int64)
                for c in ("attempts", "next_window", "stalled", "stall_until")}
        if len(old):
            pos = np.searchsorted(old.fid, work)
            safe = np.minimum(pos, len(old) - 1)
            match = old.fid[safe] == work
            for c in cols:
                cols[c][match] = getattr(old, c)[safe[match]]
        self.backlog = RepairBacklog(work, cols["attempts"], cols["next_window"],
                                     cols["stalled"], cols["stall_until"])

    def _tail_avail(self, state, fids: np.ndarray, rebalance: np.ndarray,
                    reach: np.ndarray) -> np.ndarray:
        """Candidate-target counts of a work-list tail (only their emptiness
        matters): reachable nodes without a copy, or for a rebalance copy
        reachable nodes in domains the file does not occupy."""
        node_reach = state.node_reachable()
        n_avail = int(node_reach.sum())
        avail = n_avail - reach[fids]
        if rebalance.any():
            per_dom = np.bincount(state.domain_index[node_reach], minlength=state.n_domains)
            rows = state.rows(fids[rebalance])
            assigned = rows >= 0
            dom = state.domain_index[np.clip(rows, 0, None)]
            occ = np.zeros(rows.shape[0], dtype=np.int64)
            for d in range(state.n_domains):
                occ += ((dom == d) & assigned).any(axis=1) * int(per_dom[d])
            avail[rebalance] = n_avail - occ
        return avail

    def schedule(self, window: int, state, target_rf: np.ndarray, cat: np.ndarray, *,
                 max_bytes: int | None = None, max_files: int | None = None) -> RepairReport:
        """One window's repair pass; mutates ``state`` and the backlog.

        A copy is admitted while ``bytes_used + charge <= max_bytes``, except
        that the window's first byte-moving copy is admitted even when it
        alone exceeds a positive budget; ``max_bytes == 0`` admits nothing.
        ``max_files`` caps the files repaired this window."""
        rep = RepairReport()
        bl = self.backlog
        if not len(bl):
            return rep
        live = state._live_counts
        reach = state.reachable_counts()   # scratch: the loop bumps it
        eff = state.effective_target(target_rf)
        corr = state.correlated_mask(target_rf, reach=reach, eff=eff)
        rf_vec = np.asarray(target_rf, dtype=np.int64)
        need = state.min_live

        # Order-free deferrals: backoff still running; stranded (reachable
        # below min_live), lost when live copies are short too, else a
        # partition stall gated by its own backoff.
        bf = bl.fid
        r_b, n_b = reach[bf], need[bf]
        backoff = bl.next_window > window
        stranded = ~backoff & (r_b < n_b)
        lost = stranded & (live[bf] < n_b)
        stall = stranded & ~lost
        stall_waiting = stall & (bl.stall_until > window)
        stall_bump = stall & ~stall_waiting
        rep.deferred_backoff = int(backoff.sum() + stall_waiting.sum())
        rep.deferred_no_source = int(lost.sum())
        rep.deferred_partition = int(stall_bump.sum())
        if stall_bump.any():
            pos = np.flatnonzero(stall_bump)
            bl.stalled[pos] += 1
            bl.stall_until[pos] = window + (np.int64(1) << np.minimum(bl.stalled[pos], 6))

        # The actionable tasks in admission order: (tier, -rf, file) packed
        # into one int64 (file ids are unique, tier is 1..3).
        act_pos = np.flatnonzero(~backoff & ~stranded)
        af = bf[act_pos]
        m = act_pos.shape[0]
        r_a = r_b[act_pos]
        tier = np.where(r_a == n_b[act_pos], 1, np.where(r_a < eff[af], 2, 3))
        rf_a = rf_vec[af]
        rmax = int(rf_a.max()) if m else 0
        span = np.int64(rmax + 1)
        n_total = np.int64(reach.shape[0])
        if m and 4 * int(span) * int(n_total) >= 2 ** 62:
            key = None
            full_order = np.lexsort((af, -rf_a, tier))
        else:
            key = (tier * span + (rmax - rf_a)) * n_total + af
            full_order = None
        # The cheapest possible charge of each task (its read bytes at
        # nominal throughput): when the budget cannot pay the least of the
        # remainder, the whole tail defers at once.
        min_charge = state.shard_bytes[af] * np.maximum(state.ec_k[af].astype(np.int64), 1)
        picked = np.zeros(m, dtype=bool)

        def next_chunk(k: int) -> np.ndarray | None:
            """The k best unpicked tasks, in order."""
            if full_order is not None:
                if picked.all():
                    return None
                picked[:] = True
                return full_order
            rest = np.flatnonzero(~picked)
            if rest.size == 0:
                return None
            part = rest[np.argpartition(key[rest], k - 1)[:k]] if k < rest.size else rest
            picked[part] = True
            return part[np.argsort(key[part])]

        if max_bytes is None and max_files is None:
            chunk_size = m
        else:
            chunk_size = min(m, max(2048, 2 * (max_files or 0)))

        # A functional state computes the rows of the tasks ahead in one
        # pass instead of one file at a time.
        touched = 0
        healed: list[int] = []
        done = 0
        stop = False
        chunk = next_chunk(chunk_size) if m else None
        while chunk is not None and not stop:
            rest_any = not picked.all()
            rest_min = int(min_charge[~picked].min()) if rest_any else None
            c_charge = min_charge[chunk]
            sfx = np.minimum.accumulate(c_charge[::-1])[::-1]
            for j in range(chunk.shape[0]):
                if j % _PREFETCH == 0:
                    state.prefetch_rows(af[chunk[j:j + _PREFETCH]])
                if max_files is not None and touched >= max_files:
                    rep.deferred_budget += m - done
                    stop = True
                    break
                low = int(sfx[j])
                if rest_min is not None:
                    low = min(low, rest_min)
                if max_bytes is not None and (rep.bytes_used > 0 or max_bytes == 0) \
                        and rep.bytes_used + low > max_bytes:
                    # The budget cannot pay any remaining task: classify the
                    # tail (no-work tasks heal, target-less ones defer as
                    # no_target, the rest as budget).
                    sel = np.concatenate([chunk[j:], np.flatnonzero(~picked)])
                    fs = af[sel]
                    rebal = (reach[fs] >= eff[fs]) & corr[fs]
                    needs = (reach[fs] < eff[fs]) | rebal
                    avail = self._tail_avail(state, fs, rebal, reach)
                    no_t = needs & (avail <= 0)
                    rep.deferred_no_target += int(no_t.sum())
                    rep.deferred_budget += int((needs & ~no_t).sum())
                    healed.extend(int(q) for q in act_pos[sel[~needs]])
                    stop = True
                    break
                p = int(act_pos[chunk[j]])
                f = int(af[chunk[j]])
                done += 1
                size = int(state.shard_bytes[f])
                attempts = int(bl.attempts[p])
                copy = 0
                rebalance = reach[f] >= eff[f] and bool(corr[f])
                spread_fixed = False
                task_touched = False
                if state.has_corruption:
                    nq, vbytes = state.verify_sources(f)
                    if nq:
                        rep.corrupt_sources += nq
                        rep.bytes_used += vbytes
                        reach[f] = int(state._reach_counts[f])
                        rebalance = reach[f] >= eff[f] and bool(corr[f])
                        task_touched = True
                    if reach[f] < int(need[f]):
                        # Every surviving source was rotten.
                        rep.deferred_no_source += 1
                        if task_touched:
                            touched += 1
                        continue
                while reach[f] < eff[f] or (rebalance and copy == 0):
                    target = state.pick_repair_target(f, rotate=attempts + copy,
                                                      new_domain_only=rebalance)
                    if target < 0:
                        rep.deferred_no_target += 1
                        break
                    charge = state.copy_charge(f, target)
                    if max_bytes is not None:
                        over = rep.bytes_used + charge > max_bytes
                        first = rep.bytes_used == 0 and max_bytes > 0
                        if over and not first:
                            rep.deferred_budget += 1
                            break
                    pf = float(state.node_fail_prob[target])
                    if pf > 0.0 and _fail_roll(self.seed, window, f, attempts, copy) < pf:
                        # The copy failed mid-window: traffic spent.
                        attempts += 1
                        bl.attempts[p] = attempts
                        bl.next_window[p] = window + min(2 ** attempts, _MAX_BACKOFF)
                        rep.failed += 1
                        rep.bytes_used += charge
                        task_touched = True
                        break
                    state.add_replica(f, target)
                    rep.bytes_used += charge
                    rep.bytes_copied += size
                    rep.applied.append((f, int(target), size))
                    task_touched = True
                    if rebalance:
                        # The new-domain copy landed; drop one from the
                        # crowded domain (free).
                        state.drop_crowded(f)
                        rep.rebalanced += 1
                        rep.rebalanced_fids.append(f)
                        rep.rebalanced_bytes += charge
                        spread_fixed = True
                        break
                    reach[f] += 1
                    copy += 1
                if task_touched:
                    touched += 1
                if reach[f] >= eff[f] and (not bool(corr[f]) or spread_fixed):
                    healed.append(p)
            else:
                chunk_size *= 8
                chunk = next_chunk(chunk_size)
        if healed:
            keep = np.ones(len(bl), dtype=bool)
            keep[np.asarray(healed, dtype=np.int64)] = False
            self.backlog = bl.take(keep)
        rep.files_touched = touched
        return rep

    # -- checkpoint ----------------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        bl = self.backlog
        return {"repair_file_index": bl.fid.copy(), "repair_attempts": bl.attempts.copy(),
                "repair_next_window": bl.next_window.copy(),
                "repair_stalled": bl.stalled.copy(),
                "repair_stall_until": bl.stall_until.copy()}

    def load_state_arrays(self, arrays: dict) -> None:
        fid = np.asarray(arrays["repair_file_index"], dtype=np.int64)
        att = np.asarray(arrays["repair_attempts"], dtype=np.int64)
        nxt = np.asarray(arrays["repair_next_window"], dtype=np.int64)
        zero = np.zeros_like(fid)
        stl = np.asarray(arrays.get("repair_stalled", zero), dtype=np.int64)
        unt = np.asarray(arrays.get("repair_stall_until", zero), dtype=np.int64)
        if not fid.shape == att.shape == nxt.shape == stl.shape == unt.shape:
            raise ValueError(f"repair backlog arrays disagree on length: {fid.shape} vs "
                             f"{att.shape} vs {nxt.shape} vs {stl.shape} vs {unt.shape}")
        order = np.argsort(fid, kind="stable")
        self.backlog = RepairBacklog(fid[order], att[order], nxt[order], stl[order],
                                     unt[order])
