"""Batch feature extraction on tensors: the port of
``cdrs_tpu/features/jax_backend.py:compute_features_jax`` (single device).

* ``access_freq``/``writes``/``reads``/locality matches — integer
  ``bincount``s keyed by path id: exact at any event count, and
  deterministic on CUDA (no float atomics).
* ``concurrency`` — max events in one second per path.  torch has no
  ``lexsort``, so events sort by the combined int64 key
  ``pid * (max_sec + 1) + sec``; equal keys are one (path, second) run,
  counted by run length, and ``scatter_reduce("amax")`` takes each path's
  largest run (an integer max: exact and order-free).
* second buckets and ages are reduced on the host in float64: float32 has
  ~256 s resolution at epoch magnitude.
* the degenerate guards: an empty log gives locality 1.0 and zero
  counters; a constant column normalises to 0.  Events with ``pid = -1``
  (path not in the manifest) count toward ``observation_end`` only.

The JAX package has no Pallas kernel in this stage; these torch ops are
its port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..io.events import EventLog, Manifest
from .table import FeatureTable

__all__ = ["compute_features_torch"]


def _minmax(raw: torch.Tensor) -> torch.Tensor:
    lo = raw.min(dim=0).values
    hi = raw.max(dim=0).values
    span = hi > lo
    return torch.where(span, (raw - lo) / torch.where(span, hi - lo, 1.0), 0.0)


def _concurrency(pid: torch.Tensor, sec: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 max events per (path, second) for valid events
    (``pid`` in [0, n))."""
    conc = torch.zeros(n, dtype=torch.int64, device=pid.device)
    e = pid.numel()
    if e == 0:
        return conc
    width = int(sec.max()) + 1
    key, _ = torch.sort(pid.long() * width + sec.long())
    starts = torch.ones(e, dtype=torch.bool, device=pid.device)
    starts[1:] = key[1:] != key[:-1]
    start_idx = torch.nonzero(starts).flatten()
    run_len = torch.diff(start_idx, append=start_idx.new_tensor([e]))
    return conc.scatter_reduce_(0, key[start_idx] // width, run_len, "amax")


def compute_features_torch(
    manifest: Manifest,
    events: EventLog,
    observation_end: float | None = None,
    device=None,
    dtype="float32",
) -> FeatureTable:
    """(n, 5) raw and normalised features on ``device`` (CUDA by default).

    ``dtype`` is the table's float type: float32, or float64 on the CPU
    (the JAX package's x64 mode, for parity tests).
    """
    dev = resolve_device(device)
    ftype = torch_dtype(dtype)
    if ftype not in (torch.float32, torch.float64):
        raise ValueError(f"feature dtype must be float32 or float64, got {dtype!r}")
    if ftype == torch.float64 and dev.type != "cpu":
        raise ValueError("float64 features are a CPU parity mode; use float32 on CUDA")
    n = len(manifest)
    if observation_end is None:
        observation_end = float(events.ts.max()) if len(events) else time.time()
    age = torch.as_tensor(
        np.asarray(observation_end - manifest.creation_ts, dtype=np.float64),
        device=dev).to(ftype)

    if len(events) == 0 or n == 0:
        zeros = torch.zeros(n, dtype=ftype, device=dev)
        raw = torch.stack([zeros, age, zeros, torch.ones_like(zeros), zeros], dim=1)
        norm = _minmax(raw) if n else raw.clone()
        return FeatureTable(paths=list(manifest.paths), raw=raw, norm=norm,
                            writes=zeros, reads=zeros.clone())

    sec_f = np.floor(events.ts)
    sec = torch.as_tensor((sec_f - sec_f.min()).astype(np.int32), device=dev)
    pid = torch.as_tensor(np.asarray(events.path_id, dtype=np.int32), device=dev)
    op = torch.as_tensor(np.asarray(events.op), device=dev)
    client = torch.as_tensor(np.asarray(events.client_id, dtype=np.int32), device=dev)
    primary = torch.as_tensor(np.asarray(manifest.primary_node_id, dtype=np.int32),
                              device=dev)

    valid = (pid >= 0) & (pid < n)
    pid_v = pid[valid].long()
    op_v = op[valid]
    access_i = torch.bincount(pid_v, minlength=n)
    writes_i = torch.bincount(pid_v[op_v == 1], minlength=n)
    local_i = torch.bincount(pid_v[client[valid] == primary[pid_v]], minlength=n)
    conc_i = _concurrency(pid_v, sec[valid], n)

    access_freq = access_i.to(ftype)
    writes = writes_i.to(ftype)
    reads = access_freq - writes
    locality = torch.where(access_i > 0,
                           local_i.to(ftype) / torch.clamp(access_freq, min=1.0), 1.0)
    mean_writes = writes.mean()
    write_ratio = writes / torch.where(mean_writes == 0, 1.0, mean_writes)
    raw = torch.stack(
        [access_freq, age, write_ratio, locality, conc_i.to(ftype)], dim=1)
    return FeatureTable(paths=list(manifest.paths), raw=raw, norm=_minmax(raw),
                        writes=writes, reads=reads)
