"""Carry the JAX package's state into the port.

``params_from_reference`` turns plain data — centroids as an array (a
``kmeans_jax_full`` result or its init) and a scoring config as a mapping
(``dataclasses.asdict`` of a ``cdrs_tpu`` ``ScoringConfig``) — into a
``ReplicationPolicyModel`` ``state_dict``; ``minibatch_state_from_reference``
turns the arrays of a reference ``MiniBatchState`` into the port's.  Neither
imports anything of the JAX package: the caller converts the reference's
arrays to numpy first.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import scoring_config_from_dict
from .device import resolve_device
from .ops.kmeans_stream import MiniBatchState
from .ops.scoring import scoring_tables

__all__ = ["params_from_reference", "minibatch_state_from_reference"]


def params_from_reference(centroids: np.ndarray | None,
                          scoring: Mapping) -> dict[str, torch.Tensor]:
    """The model's buffers as float64 CPU tensors (the widening is exact):
    ``centroids`` (k, d) — absent when ``centroids`` is None, so load with
    ``strict=False`` then — and the scoring tables."""
    state = dict(scoring_tables(scoring_config_from_dict(scoring)))
    if centroids is not None:
        c = np.asarray(centroids)
        if c.ndim != 2:
            raise ValueError(f"centroids must be (k, d), got shape {c.shape}")
        state["centroids"] = torch.from_numpy(np.array(c, dtype=np.float64))
    return state


def minibatch_state_from_reference(centroids: np.ndarray, counts: np.ndarray,
                                   n_batches: int, device=None) -> MiniBatchState:
    """A mini-batch tracker's state from the reference's: float32
    centroids (k, d), int32 per-center totals (k,) and the batch count, on
    ``device`` (CUDA when None)."""
    c = np.asarray(centroids, dtype=np.float32)
    cnt = np.asarray(counts, dtype=np.int32)
    if c.ndim != 2 or cnt.shape != (c.shape[0],):
        raise ValueError(f"need centroids (k, d) and counts (k,); got {c.shape}, {cnt.shape}")
    dev = resolve_device(device)
    return MiniBatchState(centroids=torch.from_numpy(c.copy()).to(dev),
                          counts=torch.from_numpy(cnt.copy()).to(dev),
                          n_batches=int(n_batches))
