"""Streaming feature fold: per-file integer counters folded one event batch
at a time, the port of ``cdrs_tpu/features/streaming.py`` (one device or a
mesh).

* ``access_freq``, ``writes``, ``local_acc`` — ``bincount``s over the
  batch's valid path ids added to int32 counters: exact, and deterministic
  on CUDA (no float atomics).
* ``concurrency`` — the batch's (path, second) runs (``batch.second_runs``,
  sorted by path then second) give each file's first and last second as
  the first and last run of its segment, so no scatter-min is needed.  The
  state carries each file's last second and that second's running count;
  a batch whose first second for a file equals it adds the carried count
  to that run, so a bucket cut by a batch boundary counts once.  Batches
  must be time-ordered per file across calls.
* ``stream_finalize`` turns the counters into the table with the batch
  pass's own formulas (``batch.features_from_counters``): a fold and the
  batch pass give bit-identical tables on one device.

``sec_base`` and ``observation_end`` stay host float64 (float32 has ~256 s
resolution at epoch magnitude); seconds on the device are int32 offsets
from ``sec_base``.  ``_prep_batch`` is numpy only and runs on
``fold_stream``'s producer thread; only the calling thread touches the
device.  Host-to-device copies are plain synchronous copies from pageable
memory.  Batches pad to the largest seen so far (``pad_events``, kept so
snapshots carry the JAX package's meta); padded rows have no valid path id
and are masked.

**Mesh** (``mesh_shape={"data": N}``): each batch (globally time-sorted,
padded to a multiple of N) splits into N time-contiguous shards; the
counter deltas are psums of the shards' ``bincount``s, each file's first
and last second of the batch a pmin/pmax, and the concurrency the
reference's sharded fold: the pmax of the shards' runs, the exact psum'd
count at each file's first second (plus the carry) and at the <= 2N shard
edge seconds, and the last second's exact total as the next carry.  All
integers, so the state is bit-identical to one device and a snapshot
resumes on any mesh.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..io.events import EventLog, Manifest
from ..utils.checkpoint import load_state, save_state
from ..parallel.mesh import data_mesh
from .batch import (check_feature_dtype, edge_seconds, features_from_counters,
                    require_sorted, second_runs)
from .table import FeatureTable

__all__ = ["StreamFeatureState", "stream_init", "stream_update", "stream_finalize",
           "fold_stream", "save_stream_state", "load_stream_state"]


@dataclass
class StreamFeatureState:
    """Per-file running counters (int32 tensors on one device) and host scalars."""

    access_freq: torch.Tensor   # (n,) int32
    writes: torch.Tensor        # (n,) int32
    local_acc: torch.Tensor     # (n,) int32
    conc_max: torch.Tensor      # (n,) int32
    last_sec: torch.Tensor      # (n,) int32, -1 = never seen
    last_count: torch.Tensor    # (n,) int32, running count of last_sec's bucket
    sec_base: float | None = None         # epoch floor of the first event seen
    observation_end: float | None = None  # max raw ts seen
    n_events: int = 0
    pad_events: int = 0                   # largest padded batch so far

    @property
    def device(self) -> torch.device:
        return self.access_freq.device


#: Fields of StreamFeatureState that snapshots hold as arrays.
_STATE_ARRAYS = ("access_freq", "writes", "local_acc", "conc_max", "last_sec",
                 "last_count")


def stream_init(n_files: int, device=None) -> StreamFeatureState:
    """Zero counters for ``n_files`` on ``device`` (CUDA unless "cpu")."""
    dev = resolve_device(device)

    def z():
        return torch.zeros(n_files, dtype=torch.int32, device=dev)

    return StreamFeatureState(access_freq=z(), writes=z(), local_acc=z(), conc_max=z(),
                              last_sec=torch.full((n_files,), -1, dtype=torch.int32,
                                                  device=dev),
                              last_count=z())


#: Path ids at or past this cannot share an int32 with the flags byte; such
#: populations (> 16.7M files) take the "cols" wire.
_PACK_PID_LIMIT = 0xFFFFFF


@dataclass
class _PreppedBatch:
    """Host half of one fold: padded columns in one of two wire formats.

    * ``"packed"`` (5 B/event): ``pid`` holds ``pid | flags << 24`` int32
      (``0xFFFFFF`` = no valid path), ``sec`` uint8 second deltas, ``sec0``
      the first second.  Needs pids below 2^24 and a batch whose seconds
      rise by at most 255 at a time.
    * ``"cols"`` (9 B/event): ``pid`` int32 (-1 = none), ``sec`` int32,
      ``flags`` uint8.
    ``flags`` packs op (bit 0) and is-local (bit 1, the client is the
    file's primary node).
    """

    pid: np.ndarray
    sec: np.ndarray
    flags: np.ndarray | None
    n_events: int        # rows before padding
    batch_max: float     # max raw ts in the batch
    sec_base: float
    wire: str = "cols"
    sec0: int = 0
    ndata: int = 1       # data shards the batch folds over (its rows divide by it)


def _prep_batch(events: EventLog, manifest: Manifest, *, sec_base: float | None,
                pad_target: int, ndata: int = 1) -> _PreppedBatch | None:
    """numpy-only preparation of one batch, padded to a multiple of
    ``ndata`` rows; None for an empty batch."""
    e = len(events)
    if e == 0:
        return None
    if ndata > 1:
        require_sorted(events.ts, "stream_update")
    if sec_base is None:
        sec_base = float(np.floor(events.ts.min()))
    sec = (np.floor(events.ts) - sec_base).astype(np.int32)

    pid = np.asarray(events.path_id, dtype=np.int32)
    valid = pid >= 0
    prim = np.asarray(manifest.primary_node_id, dtype=np.int32)
    is_local = (np.asarray(events.client_id, dtype=np.int32)
                == prim[np.where(valid, pid, 0)]) & valid
    flags = (np.asarray(events.op).astype(np.uint8) & 1) | (is_local.astype(np.uint8) << 1)

    dsec = np.diff(sec)
    packable = (len(manifest) < _PACK_PID_LIMIT
                and int(pid.max(initial=0)) < _PACK_PID_LIMIT
                and (e == 1 or (dsec.min() >= 0 and dsec.max() <= 255)))
    want = max(e, int(pad_target))
    pad = want + (-want) % ndata - e

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a

    if packable:
        pidf = (np.where(valid, pid, _PACK_PID_LIMIT).astype(np.int32)
                | (flags.astype(np.int32) << 24))
        d8 = np.empty(e, np.uint8)
        d8[0] = 0
        d8[1:] = dsec
        return _PreppedBatch(pid=padded(pidf, _PACK_PID_LIMIT), sec=padded(d8, 0),
                             flags=None, n_events=e, batch_max=float(events.ts.max()),
                             sec_base=sec_base, wire="packed", sec0=int(sec[0]),
                             ndata=ndata)
    return _PreppedBatch(pid=padded(pid, -1), sec=padded(sec, sec[-1]),
                         flags=padded(flags, 0), n_events=e,
                         batch_max=float(events.ts.max()), sec_base=sec_base, ndata=ndata)


def _to_device(pb: _PreppedBatch, dev: torch.device):
    """(pid int32 with -1 for no path, sec int32, flags uint8) on ``dev``."""
    pid = torch.from_numpy(pb.pid).to(dev)
    if pb.wire == "cols":
        return pid, torch.from_numpy(pb.sec).to(dev), torch.from_numpy(pb.flags).to(dev)
    flags = (pid >> 24).to(torch.uint8)
    pid = pid & _PACK_PID_LIMIT
    pid = torch.where(pid == _PACK_PID_LIMIT, -1, pid)
    sec = torch.cumsum(torch.from_numpy(pb.sec).to(dev), 0, dtype=torch.int32) + pb.sec0
    return pid, sec, flags


def _fold_prepped(state: StreamFeatureState, pb: _PreppedBatch) -> StreamFeatureState:
    """Device half: copy one prepped batch to the state's device and fold it
    into a new state (over ``pb.ndata`` event shards)."""
    return _fold_columns(state, pb, *_to_device(pb, state.device))


def _fold_columns(state: StreamFeatureState, pb: _PreppedBatch, pid: torch.Tensor,
                  sec: torch.Tensor, flags: torch.Tensor) -> StreamFeatureState:
    """The fold of ``pb`` from its columns already on the state's device
    (``_to_device``); the benchmark stages them before its timed loop."""
    n = state.access_freq.shape[0]
    if pb.ndata > 1:
        mesh = data_mesh({"data": pb.ndata}, state.device)
        return _advance(state, pb, *_fold_mesh(state, mesh, pid, sec, flags))
    valid = pid >= 0
    pv = pid[valid].long()
    sv = sec[valid]
    fv = flags[valid]

    def count(rows):
        return torch.bincount(rows, minlength=n).to(torch.int32)

    access = state.access_freq + count(pv)
    writes = state.writes + count(pv[(fv & 1) == 1])
    local = state.local_acc + count(pv[(fv & 2) == 2])

    conc = state.conc_max.clone()
    last_sec = state.last_sec.clone()
    last_count = state.last_count.clone()
    run_pid, run_sec, run_len = second_runs(pv, sv)
    if run_pid.numel():
        new_file = torch.ones_like(run_pid, dtype=torch.bool)
        new_file[1:] = run_pid[1:] != run_pid[:-1]
        first = torch.nonzero(new_file).flatten()
        last = torch.cat([first[1:] - 1, first.new_tensor([run_pid.numel() - 1])])
        # Cross-batch carry: a file's first run here continues the carried
        # bucket when it falls in the carried second.
        fp = run_pid[first]
        carried = last_sec[fp].long() == run_sec[first]
        run_len = run_len.clone()
        run_len[first] += torch.where(carried, last_count[fp].long(), 0)
        conc = torch.maximum(
            conc, torch.zeros(n, dtype=torch.int64, device=state.device)
            .scatter_reduce_(0, run_pid, run_len, "amax").to(torch.int32))
        lp = run_pid[last]
        last_sec[lp] = run_sec[last].to(torch.int32)
        last_count[lp] = run_len[last].to(torch.int32)

    return _advance(state, pb, access, writes, local, conc, last_sec, last_count)


def _advance(state, pb, access, writes, local, conc, last_sec, last_count):
    """The state after ``pb``: its new counters and the host scalars."""
    obs = pb.batch_max if state.observation_end is None else max(state.observation_end,
                                                                 pb.batch_max)
    return replace(state, access_freq=access, writes=writes, local_acc=local,
                   conc_max=conc, last_sec=last_sec, last_count=last_count,
                   sec_base=pb.sec_base, observation_end=obs,
                   n_events=state.n_events + pb.n_events,
                   pad_events=max(state.pad_events, len(pb.pid)))


def _fold_mesh(state, mesh, pid, sec, flags):
    """The counters after one batch folded over the mesh's event shards
    (the reference's sharded fold, ``cdrs_tpu/features/streaming.py``)."""
    n = state.access_freq.shape[0]
    imax = torch.iinfo(torch.int32).max
    shards = []
    for p, s_, f in zip(*(mesh.split(c, fill)[1] for c, fill in ((pid, -1), (sec, 0),
                                                                 (flags, 0)))):
        valid = p >= 0
        shards.append((p[valid].long(), s_[valid], f[valid]))

    def count(rows):
        return torch.bincount(rows, minlength=n).to(torch.int32)

    def per_file(fn):
        return [fn(p, s_, f) for p, s_, f in shards]

    batch_access = mesh.psum(per_file(lambda p, s_, f: count(p)))
    access = state.access_freq + batch_access
    writes = state.writes + mesh.psum(per_file(lambda p, s_, f: count(p[(f & 1) == 1])))
    local = state.local_acc + mesh.psum(per_file(lambda p, s_, f: count(p[(f & 2) == 2])))
    present = batch_access > 0

    def runs_max(p, s_, f):
        run_pid, _, run_len = second_runs(p, s_)
        return torch.zeros(n, dtype=torch.int64, device=p.device).scatter_reduce_(
            0, run_pid, run_len, "amax").to(torch.int32)

    def extreme(p, s_, f, init, how):
        return torch.full((n,), init, dtype=torch.int32, device=p.device).scatter_reduce_(
            0, p, s_.to(torch.int32), how)

    conc = torch.maximum(state.conc_max, mesh.pmax(per_file(runs_max)))
    s_first = mesh.pmin(per_file(lambda p, s_, f: extreme(p, s_, f, imax, "amin")))
    s_last = mesh.pmax(per_file(lambda p, s_, f: extreme(p, s_, f, -1, "amax")))
    carry = torch.where(present & (state.last_sec == s_first), state.last_count, 0)

    def at(sec_of_file):
        """Exact per-file count of events in the second ``sec_of_file[pid]``."""
        return mesh.psum(per_file(
            lambda p, s_, f: count(p[s_ == sec_of_file.to(p.device)[p]])))

    conc = torch.maximum(conc, torch.where(present, at(s_first) + carry, 0))
    for b in edge_seconds(mesh, [s_ for _, s_, _ in shards]):
        cnt = mesh.psum(per_file(lambda p, s_, f: count(p[s_ == b])))
        cnt = cnt + torch.where(s_first == b, carry, 0)
        conc = torch.maximum(conc, torch.where(present, cnt, 0))
    total_last = at(s_last) + torch.where(s_last == s_first, carry, 0)
    last_sec = torch.where(present, s_last, state.last_sec)
    last_count = torch.where(present, total_last, state.last_count)
    return access, writes, local, conc, last_sec, last_count


def stream_update(state: StreamFeatureState, events: EventLog,
                  manifest: Manifest, mesh_shape: dict[str, int] | None = None
                  ) -> StreamFeatureState:
    """Fold one event batch into the state (batches time-ordered per file;
    with a ``mesh_shape`` each batch globally time-sorted)."""
    mesh = data_mesh(mesh_shape, state.device)
    pb = _prep_batch(events, manifest, sec_base=state.sec_base,
                     pad_target=state.pad_events, ndata=1 if mesh is None else mesh.n_data)
    return state if pb is None else _fold_prepped(state, pb)


def save_stream_state(path: str, state: StreamFeatureState,
                      log_offset: int | None = None, log_bytes: int | None = None) -> None:
    """Atomic snapshot of the fold state and the log byte offset it covers;
    ``log_bytes`` (the log's size then) lets a resume detect a swapped log.
    The JAX package's ``load_stream_state`` reads it."""
    save_state(path, {k: getattr(state, k).cpu().numpy() for k in _STATE_ARRAYS},
               meta={"sec_base": state.sec_base,
                     "observation_end": state.observation_end,
                     "n_events": state.n_events, "pad_events": state.pad_events,
                     "log_offset": log_offset, "log_bytes": log_bytes})


def load_stream_state(path: str, device=None) -> tuple[StreamFeatureState, int | None,
                                                       int | None]:
    """(state on ``device``, log_offset, log_bytes) from a snapshot of
    either package."""
    dev = resolve_device(device)
    arrays, meta = load_state(path)
    state = StreamFeatureState(
        **{k: torch.from_numpy(np.asarray(arrays[k], dtype=np.int32)).to(dev)
           for k in _STATE_ARRAYS},
        sec_base=meta.get("sec_base"), observation_end=meta.get("observation_end"),
        n_events=int(meta.get("n_events", 0)), pad_events=int(meta.get("pad_events", 0)))
    return state, meta.get("log_offset"), meta.get("log_bytes")


#: Prepared batches the producer may hold ahead of the fold.
_QUEUE_DEPTH = 2


def fold_stream(source, manifest: Manifest, *, device=None, batch_size: int = 4_000_000,
                checkpoint_path: str | None = None, checkpoint_every: int = 25,
                stats: dict | None = None,
                mesh_shape: dict[str, int] | None = None,
                native: bool = True) -> StreamFeatureState:
    """Fold a whole log, parsing and preparing batches on a producer thread
    while the calling thread folds them on ``device`` (CUDA unless "cpu").

    ``source`` is a log path (read with ``EventLog.read_csv_batches``) or an
    iterable of EventLog batches.  ``checkpoint_path`` snapshots the state
    every ``checkpoint_every`` folded batches, with the log byte offset it
    covers; a later call with the same path resumes there, bit-identical to
    an uninterrupted fold.  It needs a path source, and snapshots happen
    only at reported offsets (``.cdrsb`` block ends; every batch of the
    native CSV parser, none once Python's parser has taken over or with
    ``native=False``).  ``native`` is ``EventLog.read_csv_batches``'s.  The
    checkpoint is deleted when the fold completes.  ``stats``
    receives ``parse_seconds``, ``prep_seconds`` (the producer's),
    ``fold_seconds`` (copy and fold, synchronised on the card), ``batches``
    and ``resumed_from_offset``.  ``mesh_shape`` folds each batch over the
    mesh's event shards; a snapshot resumes on any mesh shape.
    """
    is_path = isinstance(source, (str, bytes, os.PathLike))
    start_offset = 0
    state = None
    if checkpoint_path is not None:
        if not is_path:
            raise ValueError("checkpoint_path requires a log-path source "
                             "(resume needs byte offsets)")
        if os.path.exists(checkpoint_path):
            state, off, ck_bytes = load_stream_state(checkpoint_path, device)
            n_ck = int(state.access_freq.shape[0])
            if n_ck != len(manifest):
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} covers {n_ck} files but the "
                    f"manifest has {len(manifest)}: stale checkpoint? delete it to "
                    "start over")
            size_now = os.path.getsize(source)
            if ck_bytes is not None and size_now < int(ck_bytes):
                raise ValueError(
                    f"log {source!r} is smaller ({size_now} B) than when the "
                    f"checkpoint was written ({ck_bytes} B): the log was swapped or "
                    "truncated; delete the checkpoint to start over")
            start_offset = int(off or 0)
    if state is None:
        state = stream_init(len(manifest), device)
    dev = state.device
    mesh = data_mesh(mesh_shape, dev)
    ndata = 1 if mesh is None else mesh.n_data

    if is_path:
        batches = EventLog.read_csv_batches(source, manifest, batch_size=batch_size,
                                            native=native, start_offset=start_offset,
                                            with_offsets=True)
    else:
        batches = ((ev, None) for ev in source)

    q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    done = object()
    stop = threading.Event()   # the consumer failed: unwind the producer
    meta = {"sec_base": state.sec_base, "pad_target": state.pad_events,
            "prep": 0.0, "parse": 0.0}

    def produce():
        try:
            it = iter(batches)
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    ev, off = next(it)
                except StopIteration:
                    break
                meta["parse"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                pb = _prep_batch(ev, manifest, sec_base=meta["sec_base"],
                                 pad_target=meta["pad_target"], ndata=ndata)
                meta["prep"] += time.perf_counter() - t0
                if pb is None:
                    continue
                meta["sec_base"] = pb.sec_base
                meta["pad_target"] = max(meta["pad_target"], len(pb.pid))
                q.put((pb, off))
        except BaseException as exc:   # handed to the consumer, which re-raises it
            q.put(exc)
        else:
            q.put(done)

    producer = threading.Thread(target=produce, name="cdrs-stream-prep", daemon=True)
    producer.start()
    fold_seconds, n_batches, since_ckpt = 0.0, 0, 0
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            pb, off = item
            t0 = time.perf_counter()
            state = _fold_prepped(state, pb)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            fold_seconds += time.perf_counter() - t0
            n_batches += 1
            since_ckpt += 1
            if (checkpoint_path is not None and off is not None
                    and since_ckpt >= max(1, checkpoint_every)):
                save_stream_state(checkpoint_path, state, log_offset=int(off),
                                  log_bytes=os.path.getsize(source))
                since_ckpt = 0
    finally:
        # A consumer failure can leave the producer blocked in q.put with the
        # log open: stop it and drain the queue until the thread exits.
        stop.set()
        while producer.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=0.05)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    if stats is not None:
        stats.update(parse_seconds=meta["parse"], prep_seconds=meta["prep"],
                     fold_seconds=fold_seconds, batches=n_batches,
                     resumed_from_offset=start_offset)
    return state


def stream_finalize(state: StreamFeatureState, manifest: Manifest,
                    observation_end: float | None = None,
                    dtype="float32") -> FeatureTable:
    """The feature table from the counters, on the state's device; float64
    is a CPU parity mode.  ``observation_end`` defaults to the last event
    folded."""
    ftype = check_feature_dtype(dtype, state.device)
    if observation_end is None:
        observation_end = state.observation_end
    return features_from_counters(manifest, state.access_freq, state.writes,
                                  state.local_acc, state.conc_max, observation_end, ftype)
