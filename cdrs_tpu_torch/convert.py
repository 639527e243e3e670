"""Carry the JAX package's state into the port's model.

``params_from_reference`` turns plain data — centroids as an array (a
``kmeans_jax_full`` result or its init) and a scoring config as a mapping
(``dataclasses.asdict`` of a ``cdrs_tpu`` ``ScoringConfig``) — into a
``ReplicationPolicyModel`` ``state_dict``.  It imports nothing of the JAX
package: the caller converts the reference's arrays to numpy first.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import scoring_config_from_dict
from .ops.scoring import scoring_tables

__all__ = ["params_from_reference"]


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
