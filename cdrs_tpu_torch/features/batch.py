"""Batch feature extraction on tensors: the port of
``cdrs_tpu/features/jax_backend.py:compute_features_jax`` (single device).

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

__all__ = ["compute_features_torch", "features_from_counters", "second_runs"]


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
) -> FeatureTable:
    """(n, 5) raw and normalised features on ``device`` (CUDA by default).

    ``dtype`` is the table's float type: float32, or float64 on the CPU
    (the JAX package's x64 mode, for parity tests).
    """
    dev = resolve_device(device)
    ftype = check_feature_dtype(dtype, dev)
    n = len(manifest)
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

    valid = (pid >= 0) & (pid < n)
    pid_v = pid[valid].long()
    op_v = op[valid]
    access_i = torch.bincount(pid_v, minlength=n)
    writes_i = torch.bincount(pid_v[op_v == 1], minlength=n)
    local_i = torch.bincount(pid_v[client[valid] == primary[pid_v]], minlength=n)
    conc_i = _concurrency(pid_v, sec[valid], n)
    return features_from_counters(manifest, access_i, writes_i, local_i, conc_i,
                                  observation_end, ftype)
