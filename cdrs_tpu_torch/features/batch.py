"""Batch feature extraction on tensors: the port of
``cdrs_tpu/features/jax_backend.py:compute_features_jax`` (one device or
a mesh).

* ``access_freq``/``writes``/``reads``/locality matches — integer
  ``bincount``s keyed by path id: exact at any event count, and
  deterministic on CUDA (no float atomics).
* ``concurrency`` — max events in one second per path.  torch has no
  ``lexsort``, so events sort by one combined int64 (path, second) key
  (``second_runs``); equal keys are one run, counted by run length, and
  ``scatter_reduce("amax")`` takes each path's largest run (an integer
  max: exact and order-free).
* the feature formulas (``features_from_counters``) are shared with the
  stream fold (``features/streaming.py``).
* second buckets and ages are reduced on the host in float64: float32 has
  ~256 s resolution at epoch magnitude.
* the degenerate guards: an empty log gives locality 1.0 and zero
  counters; a constant column normalises to 0.  Events with ``pid = -1``
  (path not in the manifest) count toward ``observation_end`` only.

**Mesh** (``mesh_shape={"data": N}``; the model axis is ignored): the
time-sorted event log splits into N contiguous, hence time-contiguous,
shards.  The counters are psums of each shard's ``bincount``s and the
concurrency a pmax of each shard's.  A (path, second) bucket can be cut
only at a shard edge, so the <= 2N edge seconds (each shard's first and
last) are recounted exactly with one psum each, the reference's
edge-second correction.  The counters are integers, so the table is
bit-identical to one device.  An unsorted log is refused.

The JAX package has no Pallas kernel in this stage; these torch ops are
its port.  With an active instrument a call counts
``kernel.calls.compute_features_torch`` and spans its two stages
(``features.counters``, ``features.finalize``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..io.events import EventLog, Manifest
from ..obs import current
from ..obs.devtools import signature
from ..parallel.mesh import data_mesh
from ..utils.logging import stage_span
from .table import FeatureTable

__all__ = ["compute_features_torch", "features_from_counters", "second_runs",
           "edge_seconds", "require_sorted"]


def _minmax(raw: torch.Tensor) -> torch.Tensor:
    lo = raw.min(dim=0).values
    hi = raw.max(dim=0).values
    span = hi > lo
    return torch.where(span, (raw - lo) / torch.where(span, hi - lo, 1.0), 0.0)


def second_runs(pid: torch.Tensor, sec: torch.Tensor):
    """Runs of equal (path, second) among events, in (path, second) order:
    ``(run_pid, run_sec, run_len)``, int64.  The events sort by the combined
    key ``pid * span + (sec - min_sec)``; equal keys are one run."""
    e = pid.numel()
    if e == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=pid.device)
        return empty, empty, empty
    smin = int(sec.min())
    span = int(sec.max()) - smin + 1
    key, _ = torch.sort(pid.long() * span + (sec.long() - smin))
    starts = torch.ones(e, dtype=torch.bool, device=pid.device)
    starts[1:] = key[1:] != key[:-1]
    start_idx = torch.nonzero(starts).flatten()
    run_len = torch.diff(start_idx, append=start_idx.new_tensor([e]))
    run_key = key[start_idx]
    return run_key // span, run_key % span + smin, run_len


def _concurrency(pid: torch.Tensor, sec: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 max events per (path, second) for valid events
    (``pid`` in [0, n))."""
    run_pid, _, run_len = second_runs(pid, sec)
    conc = torch.zeros(n, dtype=torch.int64, device=pid.device)
    return conc.scatter_reduce_(0, run_pid, run_len, "amax")


def require_sorted(ts, what: str) -> None:
    """Sharded folds need time-contiguous shards: refuse an unsorted log."""
    if len(ts) > 1 and not bool(np.all(np.diff(ts) >= 0)):
        raise ValueError(
            f"sharded {what} requires a time-sorted event log (shards must be "
            "time-contiguous for exact concurrency); sort the log")


def edge_seconds(mesh, secs) -> list[int]:
    """The distinct first and last seconds of every data shard's valid
    events (``secs`` holds this process's shards'), in all processes."""
    big = torch.iinfo(torch.int64).max
    ends = [torch.stack([s.min(), s.max()]).long() if s.numel()
            else torch.tensor([big, big], device=s.device) for s in secs]
    return sorted({int(b) for b in mesh.all_gather(ends).flatten().tolist() if b != big})


def features_from_counters(manifest: Manifest, access_i: torch.Tensor,
                           writes_i: torch.Tensor, local_i: torch.Tensor,
                           conc_i: torch.Tensor, observation_end: float | None,
                           ftype: torch.dtype) -> FeatureTable:
    """The five features and their min-max norms from per-file integer
    counters, on the counters' device: the one copy of the formulas, shared
    by the batch pass and the stream fold (``streaming.stream_finalize``),
    so both give bit-identical tables on one device.  Files without events
    get locality 1.0; ``write_ratio`` divides by the mean writes (by 1 when
    that is 0); ``observation_end`` None means now."""
    n = len(manifest)
    if observation_end is None:
        observation_end = time.time()
    age = torch.as_tensor(
        np.asarray(observation_end - manifest.creation_ts, dtype=np.float64),
        device=access_i.device).to(ftype)
    access_freq = access_i.to(ftype)
    writes = writes_i.to(ftype)
    locality = torch.where(access_i > 0,
                           local_i.to(ftype) / torch.clamp(access_freq, min=1.0), 1.0)
    mean_writes = writes.mean()
    write_ratio = writes / torch.where(mean_writes == 0, 1.0, mean_writes)
    raw = torch.stack([access_freq, age, write_ratio, locality, conc_i.to(ftype)], dim=1)
    return FeatureTable(paths=list(manifest.paths), raw=raw,
                        norm=_minmax(raw) if n else raw.clone(),
                        writes=writes, reads=access_freq - writes)


def check_feature_dtype(dtype, dev: torch.device) -> torch.dtype:
    """The table's float type: float32, or float64 on the CPU only."""
    ftype = torch_dtype(dtype)
    if ftype not in (torch.float32, torch.float64):
        raise ValueError(f"feature dtype must be float32 or float64, got {dtype!r}")
    if ftype == torch.float64 and dev.type != "cpu":
        raise ValueError("float64 features are a CPU parity mode; use float32 on CUDA")
    return ftype


def compute_features_torch(
    manifest: Manifest,
    events: EventLog,
    observation_end: float | None = None,
    device=None,
    dtype="float32",
    mesh_shape: dict[str, int] | None = None,
) -> FeatureTable:
    """(n, 5) raw and normalised features on ``device`` (CUDA by default).

    ``dtype`` is the table's float type: float32, or float64 on the CPU
    (the JAX package's x64 mode, for parity tests).  ``mesh_shape`` shards
    the (time-sorted) events over the mesh's data axis.
    """
    dev = resolve_device(device)
    ftype = check_feature_dtype(dtype, dev)
    n = len(manifest)
    mesh = data_mesh(mesh_shape, dev)
    if mesh is not None:
        require_sorted(events.ts, "feature extraction")
    if observation_end is None and len(events):
        observation_end = float(events.ts.max())
    if len(events) == 0 or n == 0:
        zeros = torch.zeros(n, dtype=torch.int64, device=dev)
        return features_from_counters(manifest, zeros, zeros, zeros, zeros,
                                      observation_end, ftype)

    sec_f = np.floor(events.ts)
    sec = torch.as_tensor((sec_f - sec_f.min()).astype(np.int32), device=dev)
    pid = torch.as_tensor(np.asarray(events.path_id, dtype=np.int32), device=dev)
    op = torch.as_tensor(np.asarray(events.op), device=dev)
    client = torch.as_tensor(np.asarray(events.client_id, dtype=np.int32), device=dev)
    primary = torch.as_tensor(np.asarray(manifest.primary_node_id, dtype=np.int32),
                              device=dev)

    tel = current()
    if tel is not None:
        shards = None if mesh is None else mesh.n_data
        tel.record_kernel_call("compute_features_torch",
                               signature(pid, sec, op, client, static=(n, str(ftype), shards)))
    with stage_span("features.counters", dev):
        if mesh is None:
            counters = _counters(pid, sec, op, client, primary, n)
        else:
            counters = _counters_mesh(mesh, pid, sec, op, client, primary, n)
    with stage_span("features.finalize", dev):
        return features_from_counters(manifest, *counters, observation_end, ftype)


def _valid_events(pid, sec, op, client, primary, n):
    """(path ids, seconds, is-write, is-local) of the events on a path."""
    valid = (pid >= 0) & (pid < n)
    pid_v = pid[valid].long()
    return pid_v, sec[valid], op[valid] == 1, client[valid] == primary[pid_v]


def _counters(pid, sec, op, client, primary, n):
    """(access, writes, local, concurrency) per file, int64."""
    pid_v, sec_v, is_w, is_l = _valid_events(pid, sec, op, client, primary, n)
    return (torch.bincount(pid_v, minlength=n), torch.bincount(pid_v[is_w], minlength=n),
            torch.bincount(pid_v[is_l], minlength=n), _concurrency(pid_v, sec_v, n))


def _counters_mesh(mesh, pid, sec, op, client, primary, n):
    """``_counters`` over the mesh's event shards: psums of the shards'
    counters, the pmax of their concurrency, and the edge seconds'
    exact counts."""
    cols = [mesh.split(c, fill)[1] for c, fill in ((pid, -1), (sec, 0), (op, 0), (client, 0))]
    shards = [_valid_events(p, s, o, c, primary.to(p.device), n) for p, s, o, c in zip(*cols)]
    access = mesh.psum([torch.bincount(p, minlength=n) for p, _, _, _ in shards])
    writes = mesh.psum([torch.bincount(p[w], minlength=n) for p, _, w, _ in shards])
    local = mesh.psum([torch.bincount(p[lc], minlength=n) for p, _, _, lc in shards])
    conc = mesh.pmax([_concurrency(p, s, n) for p, s, _, _ in shards])
    for b in edge_seconds(mesh, [s for _, s, _, _ in shards]):
        conc = torch.maximum(conc, mesh.psum([torch.bincount(p[s == b], minlength=n)
                                              for p, s, _, _ in shards]))
    return access, writes, local, conc
